"""Pipelined candidate feed: background producers ahead of the engine.

The hot loop is "host feeds fixed-shape packed batches, device runs
PBKDF2": with synchronous generator chains, while the host
decoded/unhexed/packed block N the device sat idle, and while the
device cracked block N the host slept.  ``CandidateFeed`` moves the host
stages (dict streaming, rule expansion, ``$HEX`` decode +
``pack_candidates_fast`` packing) onto producer threads behind a
bounded block queue, so ``M22000Engine._prepare``'s packing cost is
paid off the critical path and starvation becomes measurable.

Design contracts:

- **Deterministic framing.**  Blocks are framed by ``framing.frame_blocks``
  — a pure function of the source stream and the ``(batch_size, nproc,
  pid)`` geometry — and delivered strictly in stream order, however many
  producer threads pack them.  Every block carries ``(offset, count)``
  global-stream coordinates, so the client's resume gate and the
  multi-host skip/count contracts are untouched by the threading.
- **Bounded + measured.**  At most ``depth`` framed blocks are in
  flight (framed-not-yet-consumed; packing producers can momentarily
  hold one block each beyond that).  A producer blocked on a full
  queue records ``dwpa_feed_producer_stall_seconds``; a consumer
  blocked on an empty one records ``dwpa_feed_consumer_starve_seconds``
  — the starve fraction is the headline "is the host keeping up"
  number.
- **Producer thread discipline**: producer code runs pure host work —
  framing, byte wrangling, native packing — and makes NO CUDA call: no
  ``pin_memory``, no ``.to(device)``, no stream or event.  Device
  staging belongs to the consumer thread (``feed/staging.py``), as do
  server calls and resume-file writes; the client hoists them before
  the feed starts (``_snapshot_prdict``/``_prefetch_cracked``/
  ``_fetch_pass2_paths``).
- **Faults carry offsets.**  A producer exception is captured and
  re-raised at the consumer as ``FeedError`` with the global stream
  offset of the block being produced, so a crashed unit's checkpoint
  and the operator's log agree about where the stream broke.

Metric names (README "Candidate feed"): ``dwpa_feed_queue_depth``
(gauge), ``dwpa_feed_producer_stall_seconds`` /
``dwpa_feed_consumer_starve_seconds`` (histograms),
``dwpa_feed_blocks_total`` / ``dwpa_feed_candidates_total`` /
``dwpa_feed_bytes_total`` / ``dwpa_feed_framed_words_total`` (counters)
— all labeled ``feed=<name>`` — plus ``feed:skip`` / ``feed:frame`` /
``feed:produce`` spans in ``dwpa_span_seconds``.  ``feed:frame`` is the
source side of a block under the source lock: the resume skip, the
word source pulled through (a dict's gunzip and line split) and the
framing, or a pre-framed source's next block; it is recorded for every
call, the one that finds the source exhausted included.
``dwpa_feed_framed_words_total`` counts the global words of each
framed block (``Block.count``), inside that span.
"""

import threading
import time

from ..obs import SpanTracer, default_registry, get_logger
from ..parallel.mesh import process_count, process_index
from .framing import frame_blocks, frame_packed, frame_rules_packed, \
    skip_stream

#: seconds a waiting producer sleeps before it re-checks the queue (the
#: wait is bounded so a producer never waits unboundedly while it holds
#: the source lock; a notify still wakes it at once)
_STALL_POLL_S = 0.05


class FeedError(RuntimeError):
    """A producer failed; re-raised at the consumer with the global
    stream offset of the block it was producing."""

    def __init__(self, offset: int, cause: BaseException):
        super().__init__(
            f"candidate feed producer failed at stream offset {offset}: "
            f"{type(cause).__name__}: {cause}")
        self.offset = offset
        self.__cause__ = cause


class CandidateFeed:
    """Bounded, framed, optionally-prepacking candidate block queue.

    ``source``: the word iterable (consumed exactly once, in order).
    ``producers``: background threads (0 = inline/synchronous mode —
    same framing and prepacking, no threads; the multi-host-safe mode
    for sources that must stay on the consumer thread).
    ``skip``: resume fast-forward — consumed from the source before any
    framing; the actual count is ``feed.skipped`` and block offsets
    start at ``skip``.  ``nproc``/``pid`` (default: the slice's process
    count and rank, ``parallel.mesh``; 1/0 in one process) select sharded
    framing; ``prepack`` is an optional pure callable
    ``words -> (rows, lens, nvalid) | None`` (see
    ``M22000Engine.host_packer``) run on the producer thread.

    ``frames``: a pre-framed ``Block`` iterator consumed INSTEAD of word
    framing — the source owns geometry and skip (pass ``skip=0``).
    Blocks arriving with a lazy prep (``framing.PackedSlices``,
    ``framing.PackedSpans``) are
    materialized in ``_pack`` on the producer threads, then handed to a
    ``pre=``-aware ``prepack`` (``host_packer``'s bypass).
    """

    def __init__(self, source, batch_size: int, *, depth: int = 2,
                 producers: int = 1, skip: int = 0, nproc: int = None,
                 pid: int = None, pad_word: bytes = b"", prepack=None,
                 registry=None, name: str = "feed", frames=None):
        nproc = process_count() if nproc is None else nproc
        pid = process_index() if pid is None else pid
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.name = name
        self.prepack = prepack
        self._skip = max(0, int(skip))
        self._skipped = 0
        self._skip_done = threading.Event()
        self._frontier = self._skip  # global offset of the framing edge
        if frames is not None:
            if self._skip:
                raise ValueError(
                    "frames= sources own their skip (pass skip=0)")
            self._src = iter(())
            self._frames = iter(frames)
        else:
            self._src = iter(source)
            self._frames = frame_blocks(self._src, self.batch_size,
                                        nproc=nproc, pid=pid,
                                        pad_word=pad_word,
                                        base_offset=self._skip)
        # _src_lock serializes source access (skip + framing); _cv guards
        # the reorder buffer, sequence counters and stop/fault state.
        # Producers take _src_lock then _cv; the consumer only ever takes
        # _cv — no lock-order cycle.
        self._src_lock = threading.Lock()
        self._cv = threading.Condition()
        self._buf = {}          # seq -> Block (packed, awaiting consumer)
        self._next_frame = 0    # next sequence number to frame
        self._next_get = 0      # next sequence number the consumer needs
        self._end_seq = None    # sequence count at stream exhaustion
        self._fault = None      # FeedError, delivered in stream order
        self._stop = False
        reg = registry or default_registry()
        self.tracer = SpanTracer(reg)
        lbl = {"feed": name}
        self._m_depth = reg.gauge(
            "dwpa_feed_queue_depth",
            "framed candidate blocks buffered ahead of the engine"
        ).labels(**lbl)
        self._m_stall = reg.histogram(
            "dwpa_feed_producer_stall_seconds",
            "per-block producer wait on a full feed queue (backpressure)"
        ).labels(**lbl)
        self._m_starve = reg.histogram(
            "dwpa_feed_consumer_starve_seconds",
            "per-block consumer wait on an empty feed queue (host too slow)"
        ).labels(**lbl)
        self._m_blocks = reg.counter(
            "dwpa_feed_blocks_total", "candidate blocks through the feed"
        ).labels(**lbl)
        self._m_cands = reg.counter(
            "dwpa_feed_candidates_total",
            "global candidates covered by feed blocks").labels(**lbl)
        self._m_bytes = reg.counter(
            "dwpa_feed_bytes_total",
            "candidate bytes materialized on this host").labels(**lbl)
        self._m_framed = reg.counter(
            "dwpa_feed_framed_words_total",
            "global words of the blocks framed from the source").labels(**lbl)
        self._threads = []
        self._inline = producers <= 0
        if self._inline:
            # Inline mode: the consumer IS the producer, so the resume
            # fast-forward happens eagerly here — ``skipped`` must never
            # block on a thread that does not exist.
            self._do_skip()
        else:
            for k in range(int(producers)):
                t = threading.Thread(
                    target=self._produce, name=f"dwpa-feed-{name}-{k}",
                    daemon=True)
                t.start()
                self._threads.append(t)

    # -- producer side -----------------------------------------------------

    def _do_skip(self):
        """Resume fast-forward, once, before any framing (caller holds
        ``_src_lock`` in threaded mode)."""
        if self._skip_done.is_set():
            return
        try:
            if self._skip:
                with self.tracer.span("feed:skip"):
                    self._skipped = skip_stream(self._src, self._skip)
        finally:
            self._skip_done.set()

    def _frame_next(self):
        """-> (seq, Block | None) under ``_src_lock``; None = exhausted."""
        with self.tracer.span("feed:frame"):
            self._do_skip()
            blk = next(self._frames, None)
            if blk is not None:
                self._m_framed.inc(blk.count)
        seq = self._next_frame
        self._next_frame += 1
        if blk is not None:
            self._frontier = blk.offset + blk.count
        return seq, blk

    def _pack(self, blk):
        """Pure host work, off the consumer's critical path: byte
        accounting + native prepack.  No CUDA call here: staging is the
        consumer's (``feed/staging.py``)."""
        with self.tracer.span("feed:produce"):
            pre = blk.prep
            if pre is not None and hasattr(pre, "materialize"):
                # lazily framed packed block: copy the column slices
                # into the staged (rows, lens, nvalid) form here, in
                # parallel across producers; a pre-aware prepack
                # (host_packer's bypass) takes it without re-packing
                blk.prep = pre = pre.materialize()
                self._m_bytes.inc(int(pre[1].sum()))
                if getattr(self.prepack, "supports_pre", False):
                    blk.prep = self.prepack(blk.words, pre=pre)
                return
            self._m_bytes.inc(blk.nbytes)
            if self.prepack is not None:
                blk.prep = self.prepack(blk.words)

    def _produce(self):
        blk = None
        try:
            while True:
                with self._src_lock:
                    # Backpressure BEFORE consuming the source: at most
                    # ``depth`` framed blocks in flight.
                    with self._cv:
                        t0 = None
                        while (not self._stop and self._fault is None
                               and self._next_frame
                               >= self._next_get + self.depth):
                            if t0 is None:
                                t0 = time.perf_counter()
                            self._cv.wait(timeout=_STALL_POLL_S)
                        if t0 is not None:
                            self._m_stall.observe(time.perf_counter() - t0)
                        if self._stop or self._fault is not None:
                            return
                    blk = None
                    seq, blk = self._frame_next()
                if blk is None:
                    with self._cv:
                        if self._end_seq is None or seq < self._end_seq:
                            self._end_seq = seq
                        self._cv.notify_all()
                    return
                self._pack(blk)
                with self._cv:
                    self._buf[seq] = blk
                    self._m_depth.set(len(self._buf))
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - delivered to consumer
            with self._cv:
                if self._fault is None:
                    # a framing fault breaks at the frontier; a packing
                    # fault breaks at the framed block's own offset
                    off = blk.offset if blk is not None else self._frontier
                    self._fault = FeedError(off, e)
                self._cv.notify_all()

    # -- consumer side -----------------------------------------------------

    @property
    def skipped(self) -> int:
        """Words actually consumed by the resume fast-forward (waits for
        the producer to finish the skip; it runs before any framing)."""
        self._skip_done.wait()
        return self._skipped

    def __iter__(self):
        return self

    def __next__(self):
        if self._inline:
            return self._record(self._next_inline())
        t0 = time.perf_counter()
        with self._cv:
            seq = self._next_get
            while seq not in self._buf:
                if self._fault is not None:
                    raise self._fault
                if self._end_seq is not None and seq >= self._end_seq:
                    raise StopIteration
                self._cv.wait()
            self._m_starve.observe(time.perf_counter() - t0)
            blk = self._buf.pop(seq)
            self._next_get = seq + 1
            self._m_depth.set(len(self._buf))
            self._cv.notify_all()
        return self._record(blk)

    def _next_inline(self):
        blk = None
        try:
            seq, blk = self._frame_next()
            if blk is None:
                raise StopIteration
            self._pack(blk)
        except StopIteration:
            raise
        except BaseException as e:  # mirror the threaded fault contract
            raise FeedError(
                blk.offset if blk is not None else self._frontier, e) from e
        self._next_get = seq + 1
        return blk

    def _record(self, blk):
        self._m_blocks.inc()
        self._m_cands.inc(blk.count)
        return blk

    def words(self):
        """Flat word-stream view, in global stream order (use
        ``prepack=None`` with this view)."""
        for blk in self:
            yield from blk.words

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 10.0):
        """Stop producers and join them.  Idempotent; safe after a
        consumer break, a fault, or normal exhaustion.  A producer
        blocked inside a slow source read is a daemon thread and is
        abandoned at the timeout (it exits at its next checkpoint)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._skip_done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


#: a cold skip larger than this replays the gzip prefix long enough to
#: matter — logged once per unit so the operator knows the O(skip)
#: hazard fired (the warm path never does: cache skips are index seeks)
SKIP_REPLAY_WARN = 1_000_000

#: words buffered per cache-writer hand-off on the cold tee
_TEE_WORDS = 4096


def _tee(stream, wr):
    """Pass words through to the framer while batching them into the
    cache writer; commits on full-stream exhaustion (a partial consume
    is aborted by the source's ``finally``)."""
    buf = []
    for w in stream:
        buf.append(w)
        if len(buf) >= _TEE_WORDS:
            wr.add_many(buf)
            buf = []
        yield w
    wr.add_many(buf)
    wr.commit()


class DictFeedSource:
    """Framed block source over a unit's dict files — warm where the
    packed cache has them, cold (with cache write-back) where not.

    The warm-source adapter of ``feed.dictcache``: feed it to
    ``CandidateFeed(frames=...)``.  Each dict is framed SEPARATELY
    (offsets stay global and contiguous across dicts), so the
    ``(offset, count)`` block geometry follows from the dict word counts
    alone, whatever the cache state: a warm block carries exactly the
    packed rows the cold block's words pack to, and the resume contract
    is cache-state-independent.

    ``units``: ``[(path, dhash | None)]`` in stream order (a None dhash
    is never cached).  ``skip`` is the GLOBAL resume fast-forward: warm
    dicts satisfy it with an index seek (O(1)); cold dicts replay the
    prefix and log once per unit past ``SKIP_REPLAY_WARN`` words.
    ``skipped`` reports the words actually consumed by the skip, exactly
    like ``CandidateFeed.skipped``.  A cold dict is written back only
    when this pass streams it from word 0: a dict the resume window cuts
    into is served cold and left uncached, since its tee would see only
    the tail.  ``nproc``/``pid``/``pad_word`` (default: the slice's
    process count and rank) select sharded framing, warm or cold: every
    process derives the same block geometry from the dict word counts
    whatever its cache state, and takes its own slice of each block.

    Iteration is driven from the feed's producer side (under its source
    lock), so cache reads and writes stay on producer threads.
    """

    #: the cache species this source reads and fills (``.rbase`` if True)
    _rules = False

    def __init__(self, units, batch_size: int, *, cache=None,
                 nproc: int = None, pid: int = None, pad_word: bytes = b"",
                 skip: int = 0, name: str = "feed", log=None):
        self.units = list(units)
        self.batch_size = int(batch_size)
        self.cache = cache
        self.nproc = process_count() if nproc is None else nproc
        self.pid = process_index() if pid is None else pid
        self.pad_word = pad_word
        self.name = name
        self.skipped = 0
        self._skip = max(0, int(skip))
        self._log = log or get_logger("feed").info

    def _warm_blocks(self, rd, start: int, base_offset: int):
        """Blocks of a warm entry from word ``start`` on, the first at
        global ``base_offset``."""
        return frame_packed(rd.chunks(start), rd.total_words,
                            self.batch_size, nproc=self.nproc, pid=self.pid,
                            base_offset=base_offset, start=start)

    def __iter__(self):
        from ..gen.dicts import DictStream

        cache = self.cache
        offset = 0            # global stream position (skipped + served)
        remaining = self._skip
        warned = False
        for path, dhash in self.units:
            rd = wr = None
            if cache is not None:
                rd, wr = cache.entry(dhash, rules=self._rules,
                                     fill=remaining == 0)
            if rd is not None:
                # -- warm: mmap'd packed blocks, zero gunzip ------------
                total = rd.total_words
                if remaining >= total:
                    # whole dict inside the resume window: pure index
                    # math, nothing decompressed, nothing replayed
                    remaining -= total
                    self.skipped += total
                    offset += total
                    continue
                start = remaining
                self.skipped += start
                remaining = 0
                t0 = time.perf_counter()
                served = 0
                for blk in self._warm_blocks(rd, start, offset + start):
                    cache.m_hit_blocks.inc()
                    served += blk.count
                    yield blk
                el = time.perf_counter() - t0
                if served and el > 0:
                    cache.m_words_warm.set(served / el)
                offset += total
                continue
            # -- cold: gunzip stream; write the cache alongside --------
            stream = iter(DictStream(path))
            if remaining:
                if remaining > SKIP_REPLAY_WARN and not warned:
                    warned = True
                    self._log(
                        f"feed {self.name}: cold dict skip replays "
                        f"{remaining} words (O(skip) gzip prefix; a warm "
                        f"dict cache would seek the block index instead)")
                k = skip_stream(stream, remaining)
                self.skipped += k
                offset += k
                remaining -= k
                if remaining:
                    continue      # dict exhausted inside the skip window
            src = stream if wr is None else _tee(stream, wr)
            t0 = time.perf_counter()
            served = 0
            try:
                for blk in frame_blocks(src, self.batch_size,
                                        nproc=self.nproc, pid=self.pid,
                                        pad_word=self.pad_word,
                                        base_offset=offset):
                    if cache is not None:
                        cache.m_miss_blocks.inc()
                    served += blk.count
                    offset = blk.offset + blk.count
                    yield blk
            finally:
                if wr is not None:
                    wr.abort()    # no-op after the tee's commit
            el = time.perf_counter() - t0
            if cache is not None and served and el > 0:
                cache.m_words_cold.set(served / el)


class RulesFeedSource(DictFeedSource):
    """Framed BASE-WORD block source for the device rule-expansion path
    (``M22000Engine.crack_rules_blocks``) — warm where the ``.rbase``
    cache has the dict, cold (with ``.rbase`` write-back) where not.

    The rules twin of ``DictFeedSource``.  Warm dicts serve
    ``feed.framing.RulesPrep`` blocks (the split into device-eligible
    bases and host-fallback words, and the pack, memoized: the engine
    seam skips straight to H2D); cold dicts serve raw word blocks while
    the tee writes the entry for next time.  Both emit the identical
    ``frame_blocks`` ``(offset, count)`` geometry over the same raw word
    stream, so a warm/cold transition between dicts (or a resume across
    one) cannot shift the expansion order — which is also what keeps
    every resume count equal to the JAX client's on a unit with several
    dicts: framing a chained word stream would put blocks across dict
    boundaries.

    The source takes no skip: the resume window counts expanded pairs
    and is the engine's own ``skip`` argument.  Single-process framing
    only — a multi-process slice's rules pass keeps the flat
    ``crack_rules`` path over ``CandidateFeed.words``.
    """

    _rules = True

    def __init__(self, units, batch_size: int, *, cache=None,
                 name: str = "pass2", log=None):
        super().__init__(units, batch_size, cache=cache, nproc=1, pid=0,
                         name=name, log=log)

    def _warm_blocks(self, rd, start: int, base_offset: int):
        return frame_rules_packed(rd.chunks(start), rd.total_words,
                                  self.batch_size, base_offset=base_offset,
                                  start=start)

"""Device-stream executor: N independent single-device crack streams.

Lockstep dispatch runs one engine over its device: a single consumer
thread feeds it block after block.  Independent per-device streams
(hashcat's multi-GPU model, and the reference dwpa's own per-client work
units) instead give each stream an engine of its own: the stream crunches
WHOLE feed blocks on its device, gates on its own scalar hit count, and
pulls prepacked blocks from a shared work queue — so a straggler only
slows its own stream and the feed fans out across
``default_feed_workers()`` producers instead of starving behind one.

Each stream is a thread that runs its dispatch under its own
``torch.cuda.Stream`` on its device, with its own ``DeviceStager``: a
block's rows are copied on the stager's side stream and the stream's
compute stream waits on that copy's event before the block's kernels
are queued.  Several streams may share one card (each with its own CUDA
stream), which is how a one-card host tests the path.

Resume framing is unchanged: blocks keep their global ``frame_blocks``
offsets, and completed blocks are demuxed and reported strictly in
stream (sequence) order, so the client's skip-by-count checkpoint sees
exactly the sequence the lockstep path would produce.

Failure containment mirrors the fused executor's excluded-style retry:
a stream that raises mid-block requeues its unfinished blocks with
itself excluded, another stream picks them up, and a block that fails
on every stream (or past ``max_attempts``) surfaces as a
``StreamError`` carrying the block's global offset — never a fallback to
another device or to the plain PBKDF2.  No orphan threads: workers exit
only when the queue is closed, drained, and nothing is in flight.

Multi-process slices keep lockstep dispatch: there every process must
agree a batch is done (the global hits gate), so ``streams_default()``
enables streams only in a single process with more than one local CUDA
device.

Discipline (lint rule DW110, which names the JAX twin of this file): no
cross-device collectives, no blocking fetch inside the per-stream
dispatch loop (the only sync is the engine's own hits gate inside
``_collect``).
"""

import collections
import contextlib
import threading
import time

import torch

#: Returned by a non-blocking queue probe: nothing takeable right now,
#: but more may arrive — the stream should drain its own pipeline and
#: retry instead of parking while it still holds unfinished blocks.
_STALL = object()


def streams_default() -> bool:
    """True when device streams should replace lockstep dispatch: one
    process with more than one local CUDA device."""
    from .mesh import process_count

    return process_count() == 1 and torch.cuda.device_count() > 1


def default_feed_workers() -> int:
    """Default candidate-feed producer count: one per local CUDA device,
    so an N-stream host doesn't starve behind a single producer (the
    ``--feed-workers`` flag overrides)."""
    return max(1, torch.cuda.device_count())


def stream_devices(device) -> list:
    """The devices streams run on by default for an engine on ``device``:
    every local CUDA device for a CUDA engine, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def device_label(device) -> str:
    """Stable ``type:index`` metric label for one device (a torch device
    or name; any other object by its ``platform`` and ``id``)."""
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        return f"{device.type}:{device.index or 0}"
    return f"{getattr(device, 'platform', 'dev')}:{getattr(device, 'id', 0)}"


class StreamError(RuntimeError):
    """A block failed on every eligible stream (or past the retry
    budget); ``offset`` is the block's global candidate offset."""

    def __init__(self, offset: int, cause: BaseException):
        super().__init__(
            f"stream block at offset {offset} failed: {cause!r}")
        self.offset = offset
        self.cause = cause


class _Item:
    """One queued block plus its retry state (``excluded`` mirrors the
    fused executor's requeue contract: streams that already failed this
    block don't get it back)."""

    __slots__ = ("seq", "block", "excluded", "attempts")

    def __init__(self, seq, block):
        self.seq = seq
        self.block = block
        self.excluded = frozenset()
        self.attempts = 0


class _WorkQueue:
    """Bounded shared block queue with excluded-stream routing.

    ``get`` returns the oldest item the calling stream may take, or
    None exactly when no such item can ever arrive: the queue is
    closed AND (it is empty with nothing in flight, or every remaining
    item excludes this stream while nothing is in flight that could be
    requeued its way).  Waiting while anything is in flight is what
    makes crash requeue orphan-free — an idle stream stays parked until
    the crashing stream's blocks come back to the queue.
    """

    def __init__(self, maxsize: int):
        self._dq = collections.deque()
        self._cond = threading.Condition()
        self._maxsize = max(1, int(maxsize))
        self._open = True
        self._inflight = 0

    def put(self, item, requeue: bool = False):
        with self._cond:
            if requeue:
                self._inflight -= 1
            else:
                while self._open and len(self._dq) >= self._maxsize:
                    self._cond.wait()
            if not self._open and not requeue:
                return  # aborted mid-feed: drop instead of growing a dead queue
            self._dq.append(item)
            self._cond.notify_all()

    def get(self, stream_index: int, block: bool = True):
        """Oldest item this stream may take; ``None`` when no such item
        can ever arrive; ``_STALL`` (non-blocking mode only) when
        nothing is takeable right now.  A stream must only call with
        ``block=True`` while it holds NO unfinished blocks of its own —
        parked streams hold zero inflight, so a positive count always
        belongs to an active stream that will resolve, requeue or
        abort, and the wait can't cycle."""
        with self._cond:
            while True:
                for i, item in enumerate(self._dq):
                    if stream_index not in item.excluded:
                        del self._dq[i]
                        self._inflight += 1
                        self._cond.notify_all()
                        return item
                done = not self._open and self._inflight == 0
                if done and (not self._dq or all(
                        stream_index in it.excluded for it in self._dq)):
                    return None
                if not block:
                    return _STALL
                self._cond.wait()

    def resolve(self):
        """An item handed out by ``get`` reached a final state."""
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def close(self):
        with self._cond:
            self._open = False
            self._cond.notify_all()

    def abort(self):
        with self._cond:
            self._dq.clear()
            self._open = False
            self._cond.notify_all()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._dq)


class DeviceStream:
    """One crack stream pinned to one device.

    Wraps a single-device engine plus the stream's telemetry:
    ``dwpa_stream_blocks_total`` / ``dwpa_stream_busy_fraction`` /
    ``dwpa_stream_queue_depth``, all labeled ``device=type:index``, and
    ``stream:dispatch`` / ``stream:collect`` spans.
    """

    def __init__(self, index, device, engine, registry=None, tracer=None):
        self.index = index
        self.device = device
        self.engine = engine
        self.tracer = tracer
        self.label = device_label(device)
        self.wait_s = 0.0        # time blocked on the shared queue
        self.blocks_done = 0
        self.inflight = collections.deque()   # _Items fed, FIFO
        self.prune = collections.deque()      # cross-stream found removals
        if registry is not None:
            lbl = {"device": self.label}
            self._m_blocks = registry.counter(
                "dwpa_stream_blocks_total",
                "Feed blocks completed per device stream").labels(**lbl)
            self._m_busy = registry.gauge(
                "dwpa_stream_busy_fraction",
                "Per-stream fraction of wall time spent in "
                "prepare/dispatch/collect (1 - shared-queue wait)"
            ).labels(**lbl)
            self._m_qdepth = registry.gauge(
                "dwpa_stream_queue_depth",
                "Shared work-queue depth at this stream's last pull"
            ).labels(**lbl)
        else:
            self._m_blocks = self._m_busy = self._m_qdepth = None

    def _span(self, name):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name)

    def _cuda_stream(self):
        """This stream's own CUDA stream (None off CUDA), made on the
        stream's thread before any of its work is queued."""
        dev = getattr(self.engine, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return torch.cuda.Stream(dev)
        return None

    def run_blocks(self, next_item, on_result=None) -> list:
        """Crack framed blocks pulled from ``next_item`` on this
        stream's device.

        The single-device body of ``M22000Engine.crack_blocks``: the
        block's rows go up on this stream's own ``DeviceStager`` side
        stream, ``_dispatch`` queues compute without waiting, and the
        same ``PIPELINE_DEPTH`` dispatch/sync window trails the hits
        gate, all under this stream's CUDA stream.  Every completed
        block is reported through ``on_result(block, founds)`` so a
        demux above can reassemble global stream order.

        ``next_item(block_ok)`` returns the next framed block, ``None``
        when the feed is exhausted, or ``_STALL`` (only when
        ``block_ok`` is false) when nothing is takeable yet.  The loop
        passes ``block_ok=True`` only once its pipeline is empty —
        never parking on the shared queue while it holds unfinished
        blocks, which is what keeps the executor's inflight accounting
        deadlock-free.  The only device sync is the engine's hits-gate
        fetch inside ``_collect``.  Returns the stream's Found list.
        """
        cs = self._cuda_stream()
        with (torch.cuda.stream(cs) if cs is not None
              else contextlib.nullcontext()):
            return self._run_blocks(next_item, on_result)

    def _run_blocks(self, next_item, on_result):
        from ..feed.staging import DeviceStager

        eng = self.engine
        dev = getattr(eng, "device", None)
        stager = (DeviceStager(eng, (), depth=0)
                  if isinstance(dev, torch.device) else None)
        pending = collections.deque()  # (block, dispatched | None)
        founds = []
        t_run = time.perf_counter()

        def finish_one():
            block, disp = pending.popleft()
            if disp is None:
                new = []
            else:
                with self._span("stream:collect"):
                    # the hits-gate fetch inside _collect is the sync
                    new = eng._collect(disp)
            founds.extend(new)
            self.blocks_done += 1
            if self._m_blocks is not None:
                self._m_blocks.inc()
                wall = time.perf_counter() - t_run
                if wall > 0:
                    self._m_busy.set(max(0.0, 1.0 - self.wait_s / wall))
            if on_result is not None:
                on_result(block, new)

        while True:
            block = next_item(not pending)
            if block is _STALL:
                finish_one()   # use the queue gap to sync our oldest
                continue
            if block is None:
                break
            if eng.groups:
                if stager is not None:
                    # side-stream H2D, then the compute stream waits on it
                    prep = stager.ready_now(
                        eng._prepare_block(block, stager=stager))
                else:
                    prep = eng._prepare_block(block)
                if prep is None:
                    disp = None                    # nothing valid in the block
                else:
                    with self._span("stream:dispatch"):
                        disp = eng._dispatch(prep)  # async compute
            else:
                disp = None                        # all nets cracked: skip
            pending.append((block, disp))
            if len(pending) > eng.PIPELINE_DEPTH:
                finish_one()
        while pending:
            finish_one()
        return founds


class StreamExecutor:
    """Fan framed blocks out over independent per-device streams.

    ``engine_factory(device)`` builds each stream's single-device
    engine; every engine must be constructed from the SAME hashline
    objects so a find on one stream prunes the same net on every other
    (``M22000Engine.remove`` matches by line identity).  ``run`` feeds
    the shared queue, demuxes per-block results back into global
    sequence order, dedups founds across streams (first block wins,
    exactly like the lockstep live-set), and lazily prunes cracked nets
    from every stream's engine at that stream's next block boundary, on
    the stream's own thread — each engine is changed only by the thread
    that drives it.  The prune is advisory (a racing stream may still
    compute a cracked net's batch) but the ordered dedup keeps the
    reported found list identical to lockstep's.
    """

    def __init__(self, engine_factory, devices, registry=None, tracer=None,
                 queue_depth=None, max_attempts: int = 2):
        devices = list(devices)
        if not devices:
            raise ValueError("StreamExecutor needs at least one device")
        self.max_attempts = int(max_attempts)
        self.streams = [
            DeviceStream(i, d, engine_factory(d), registry=registry,
                         tracer=tracer)
            for i, d in enumerate(devices)
        ]
        for d in {torch.device(st.engine.device) for st in self.streams
                  if isinstance(getattr(st.engine, "device", None), torch.device)
                  and st.engine.device.type == "cuda"}:
            # the engines' net constants were copied on this thread's
            # stream; the stream threads read them on their own streams
            torch.cuda.current_stream(d).synchronize()
        self._q = _WorkQueue(queue_depth or 2 * len(self.streams))
        self._cond = threading.Condition()
        self._results = {}          # seq -> (block, founds, stream index)
        self._alive = set(range(len(self.streams)))
        self._fault = None
        self._total = None          # block count, set once the feed ends
        self._stop = False          # emitter saw every net cracked
        self._dead = set()          # id(line) of nets already reported
        nets = self.streams[0].engine.nets
        self._nlines = len({id(n.line) for n in nets})
        self.block_streams = []     # seq-ordered winning stream index

    # -- feeder --------------------------------------------------------------

    def _feed(self, blocks):
        try:
            seq = 0
            for block in blocks:
                if self._stop or self._fault is not None:
                    break
                self._q.put(_Item(seq, block))
                seq += 1
            with self._cond:
                self._total = seq
                self._cond.notify_all()
            self._q.close()
        except BaseException as e:   # surfaced to the caller (FeedError &co)
            self._abort(e)

    # -- stream workers ------------------------------------------------------

    def _pull(self, st, block_ok):
        """One stream's ``next_item``: pull from the shared queue,
        applying pending cross-stream prunes at block boundaries (the
        stream's own thread — never racing its dispatch).  Blocks only
        when ``block_ok`` (the stream's pipeline is empty), else
        returns ``_STALL`` so the stream drains instead of parking."""
        while st.prune:
            st.engine.remove(st.prune.popleft())
        t0 = time.perf_counter()
        item = self._q.get(st.index, block=block_ok)
        st.wait_s += time.perf_counter() - t0
        if st._m_qdepth is not None:
            st._m_qdepth.set(self._q.depth)
        if item is None or item is _STALL:
            return item
        st.inflight.append(item)
        return item.block

    def _record(self, st, block, founds):
        item = st.inflight.popleft()
        with self._cond:
            self._results[item.seq] = (item.block, founds, st.index)
            self._cond.notify_all()
        self._q.resolve()

    def _work(self, st):
        try:
            st.run_blocks(lambda ok: self._pull(st, ok),
                          on_result=lambda b, f: self._record(st, b, f))
        except BaseException as e:
            self._stream_failed(st, e)

    def _stream_failed(self, st, err):
        """Excluded-style retry (sched/executor.py's requeue contract):
        the dead stream's unfinished blocks go back to the queue with
        this stream excluded; a block out of eligible streams or past
        ``max_attempts`` aborts the run with a ``StreamError``."""
        with self._cond:
            self._alive.discard(st.index)
            alive = set(self._alive)
        fatal = None
        while st.inflight:
            item = st.inflight.popleft()
            item.attempts += 1
            item.excluded = item.excluded | {st.index}
            ok = (item.attempts <= self.max_attempts
                  and bool(alive - item.excluded))
            if fatal is None and ok:
                self._q.put(item, requeue=True)
            else:
                # Resolve even the unretryable blocks so the queue's
                # inflight count drains to zero and surviving workers
                # wake up (to observe the abort) instead of parking.
                if fatal is None:
                    fatal = StreamError(item.block.offset, err)
                self._q.resolve()
        if fatal is not None:
            self._abort(fatal)
        elif not alive:
            self._abort(StreamError(-1, err))

    def _abort(self, err):
        with self._cond:
            if self._fault is None:
                self._fault = err
            self._cond.notify_all()
        self._q.abort()

    # -- ordered demux -------------------------------------------------------

    def run(self, blocks, on_batch=None) -> list:
        """Drain ``blocks`` across every stream; returns the merged
        Found list.  ``on_batch(consumed, founds)`` fires once per
        block in global sequence order — the ``crack_blocks`` resume
        contract, so checkpoints written from it are identical to the
        lockstep path's."""
        feeder = threading.Thread(target=self._feed, args=(iter(blocks),),
                                  name="stream-feeder", daemon=True)
        workers = [threading.Thread(target=self._work, args=(st,),
                                    name=f"stream-{st.label}-{st.index}",
                                    daemon=True)
                   for st in self.streams]
        feeder.start()
        for w in workers:
            w.start()
        all_founds = []
        next_seq = 0
        fault = None
        while True:
            with self._cond:
                while True:
                    if self._fault is not None:
                        fault = self._fault
                        break
                    if next_seq in self._results:
                        break
                    if self._total is not None and next_seq >= self._total:
                        break
                    self._cond.wait()
                if fault is not None:
                    break
                if next_seq not in self._results:
                    break  # every block emitted
                block, founds, si = self._results.pop(next_seq)
            kept = []
            for f in founds:
                if id(f.line) in self._dead:
                    continue  # an earlier block already cracked this net
                self._dead.add(id(f.line))
                kept.append(f)
                for st in self.streams:
                    st.prune.append(f)
            self.block_streams.append(si)
            all_founds.extend(kept)
            if on_batch is not None:
                on_batch(block.count, kept)
            next_seq += 1
            if len(self._dead) >= self._nlines and not self._stop:
                # every net cracked: stop feeding, drain what's queued
                # (queued blocks still report their counts, as skips)
                self._stop = True
        if fault is not None:
            self._q.abort()
        feeder.join(timeout=10)
        for w in workers:
            w.join(timeout=10)
        if fault is not None:
            raise fault
        return all_founds

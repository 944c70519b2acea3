"""Deterministic candidate-block framing for the feed subsystem.

Every block of the candidate pipeline carries ``(offset, count)`` — the
GLOBAL stream position of its first candidate and the number of global
candidates it covers — so the client's resume gate (skip-by-count
against ``_write_resume``'s ``_batch``/mesh/version stamps) and the
multi-host lockstep contract keep working unchanged when production
moves onto background threads: the framing is a pure function of the
source stream and the ``(batch_size, nproc, pid)`` geometry, never of
producer/consumer timing.

Multi-host framing preserves the exact slicing contract of the former
``client.main.shard_word_blocks`` (which now delegates here): per
global block of up to ``batch_size * nproc`` words,
``blk = min(batch_size, ceil(n / nproc))`` and this host's slice is
``block[pid * blk:(pid + 1) * blk]`` padded to ``blk`` with an invalid
word — every host emits the SAME number of same-shaped blocks (the
SPMD-lockstep requirement of ``M22000Engine.crack``), and an empty
shard becomes an all-padding block (``Block.padded``) rather than an
absent one.

Unlike the old slicer, a host no longer materializes the full
``batch_size * nproc`` global block: only words whose index can still
fall inside this host's slice are buffered.  Because
``blk(n) = min(batch_size, ceil(n / nproc))`` is nondecreasing in the
final block length ``n``, the slice window only ever moves right as the
block grows — so a word at block-index ``i`` is kept iff
``pid * blk(i + 1) <= i < (pid + 1) * batch_size``, and the buffer's
left edge is pruned to ``pid * blk(c)`` as the consumed count ``c``
grows.  Peak buffering is ``(pid + 1) * batch_size - pid * blk(c)``
(<= ``(pid + 1)(nproc - pid)/nproc * batch_size``, exactly
``batch_size`` for full blocks and for host 0) versus the former
``batch_size * nproc`` on every host.
"""

import itertools
from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class Block:
    """One framed candidate block.

    ``offset``/``count`` index the GLOBAL source stream (resume
    checkpoints advance by ``count``); ``words`` is this host's local
    slice (equal to the global block when ``nproc == 1``).  ``prep``
    is filled by a prepacking producer (see ``CandidateFeed``):
    ``(rows uint32[cap, 16], lens uint8[nvalid], nvalid)`` — the
    host-packed form ``M22000Engine._prepare_staged`` stages to the
    device without re-packing — or a ``pmkstore.stage.MixedPrep`` when
    the packer is PMK-store-aware (the block pre-split into cache hits
    and misses, ``M22000Engine._prepare_mixed``).  ``padded`` marks an
    all-padding block
    (this host's shard of the global block was empty — dispatched
    anyway to keep the slice in lockstep, see ``_padding_prep``).
    """

    offset: int
    count: int
    words: list
    prep: tuple = None
    padded: bool = False

    @property
    def nbytes(self) -> int:
        return sum(len(w) for w in self.words)


def _blk(n: int, batch_size: int, nproc: int) -> int:
    """Per-host slice width for a global block of ``n`` words."""
    return min(batch_size, -(-n // nproc))


def frame_blocks(words, batch_size: int, nproc: int = 1, pid: int = 0,
                 pad_word: bytes = b"", base_offset: int = 0,
                 watermark: list = None):
    """Frame a global word stream into deterministic ``Block``s,
    materializing only this host's 1/nproc shard slice (module
    docstring has the exact contract and the buffering bound).

    ``base_offset`` seeds the global offset (a resume fast-forward that
    already consumed ``skip`` words passes ``skip``).  ``watermark``
    (tests only) receives each block's peak buffer size.

    One process takes every word of every block, so its blocks are cut
    with ``islice``, without the shard arithmetic below (about 1.75 us
    a word in Python).
    """
    it = iter(words)
    if nproc == 1:
        offset = base_offset
        while batch := list(itertools.islice(it, batch_size)):
            if watermark is not None:
                watermark.append(len(batch))
            yield Block(offset=offset, count=len(batch), words=batch)
            offset += len(batch)
            if len(batch) < batch_size:
                return
        return
    gsize = batch_size * nproc
    hi = (pid + 1) * batch_size
    offset = base_offset
    while True:
        buf = deque()  # (block-index, word), indices strictly increasing
        peak = c = 0
        for w in it:
            i = c
            c += 1
            if i < hi and pid * _blk(i + 1, batch_size, nproc) <= i:
                buf.append((i, w))
            # prune the left edge: the final window start can only grow
            start = pid * _blk(c, batch_size, nproc)
            while buf and buf[0][0] < start:
                buf.popleft()
            peak = max(peak, len(buf))
            if c == gsize:
                break
        if watermark is not None and c:
            watermark.append(peak)
        if c == 0:
            return
        blk = _blk(c, batch_size, nproc)
        start = pid * blk
        mine = [w for i, w in buf if i < start + blk]
        nreal = len(mine)
        mine += [pad_word] * (blk - nreal)
        yield Block(offset=offset, count=c, words=mine, padded=(nreal == 0))
        offset += c
        if c < gsize:
            return


class PackedSlices:
    """Lazy prep for a warm dict-cache block: zero-copy ``(lens, rows)``
    column windows into mmap'd cache chunks, materialized into the
    ``(rows uint32[cap, 16], lens uint8[nvalid], nvalid)`` staged form
    on a feed producer thread (``CandidateFeed._pack``) — the memcpy
    out of the page cache happens off the consumer's critical path,
    and N producers can materialize disjoint block ranges in parallel
    (the mmap is read-only and shared).

    ``materialize()`` reproduces EXACTLY what ``pack_candidates_fast``
    returns for the block's word slice on the cold path: accepted rows
    contiguous from 0 in stream order, zero rows beyond ``nvalid``,
    ``cap == batch_size`` (a host slice is never wider than one batch).
    """

    __slots__ = ("parts", "cap")

    def __init__(self, parts, cap: int):
        self.parts = parts   # [(lens uint8[k] view, rows u32[nv, 16] view)]
        self.cap = cap

    def materialize(self):
        packed = np.zeros((self.cap, 16), np.uint32)
        lens, r = [], 0
        for lens_all, rows in self.parts:
            nv = rows.shape[0]
            if nv:
                packed[r:r + nv] = rows
                lens.append(lens_all[lens_all > 0])
                r += nv
        lens = (np.concatenate(lens) if lens else np.zeros(0, np.uint8))
        return packed, lens, r


class PackedSpans:
    """Lazy prep for a cold dict block (``frame_spans``): the block's
    words as spans of decompressed dict chunks, packed by the native
    packer on a feed producer thread (``CandidateFeed._pack``), outside
    the interpreter lock.  ``materialize()`` returns what
    ``pack_candidates_fast`` returns for the block's words at
    ``capacity=cap``."""

    __slots__ = ("parts", "cap")

    def __init__(self, parts, cap: int):
        self.parts = parts   # [(buf, starts int64[k], lens int64[k])]
        self.cap = cap

    def materialize(self):
        from .. import native
        from .dictcache import _MAX_LEN, _MIN_LEN

        count = sum(len(starts) for _, starts, _ in self.parts)
        packed = np.zeros((max(self.cap, count), 16), np.uint32)
        lens = np.empty(count, np.uint8)
        r = 0
        for buf, starts, wlens in self.parts:
            n = native.pack_spans(buf, starts, wlens, _MIN_LEN, _MAX_LEN,
                                  packed[r:], lens[r:])
            if n is None:
                raise RuntimeError("the native packer is unavailable")
            r += n
        return packed, lens[:r], r


def frame_spans(spans, batch_size: int, skip: int = 0):
    """Frame one process's word stream given as ``(buf, starts, lens)``
    spans (``gen.DictStream.spans``, chained over a unit's dicts) into
    ``Block``s: after a resume ``skip`` of whole words, the ``(offset,
    count)`` geometry ``frame_blocks`` gives the same words at
    ``base_offset=skip``, with ``Block.words`` empty and ``Block.prep`` a
    lazy ``PackedSpans``.  A block may span two chunks or two dicts."""
    offset, parts, count = skip, [], 0
    for buf, starts, lens in spans:
        if skip:
            k = min(skip, len(starts))
            starts, lens, skip = starts[k:], lens[k:], skip - k
        while len(starts):
            k = min(batch_size - count, len(starts))
            parts.append((buf, starts[:k], lens[:k]))
            starts, lens, count = starts[k:], lens[k:], count + k
            if count == batch_size:
                yield Block(offset=offset, count=count, words=[],
                            prep=PackedSpans(parts, batch_size))
                offset, parts, count = offset + count, [], 0
    if count:
        yield Block(offset=offset, count=count, words=[],
                    prep=PackedSpans(parts, batch_size))


class RulesPrep:
    """Warm base-word block for the device rule-expansion seam
    (``M22000Engine._rules_flush``): the split rule sets, the expanded
    split into device-eligible bases vs host-fallback words, and the
    native pack already ran (and were cached) — the seam skips straight
    to the H2D upload.  ``rows``/``lens`` are the packed device layout
    of the ``nplain`` eligible bases in stream order (rows exactly what
    ``pack_candidates_fast(plain, 0, MAX_PSK_LEN)`` produces, lens the
    RAW byte lengths — rule semantics see the undecoded word);
    ``fallback`` is the block's ineligible words (> 63 bytes or
    ``HEX[`` carriers), also in stream order, routed to the host
    interpreter for every rule.  The ``rules_base`` class attribute is
    the marker the seam duck-types on.
    """

    __slots__ = ("rows", "lens", "nplain", "fallback")

    rules_base = True

    def __init__(self, rows, lens, nplain, fallback):
        self.rows = rows
        self.lens = lens
        self.nplain = nplain
        self.fallback = fallback

    def padded_rows(self, cap: int):
        """Rows zero-padded to the engine's ``cap`` — the warm twin of
        the seam's cold ``pack_candidates_fast(..., capacity=cap)``
        call (always a fresh native-endian array: the stored rows may
        be a read-only little-endian mmap view)."""
        out = np.zeros((cap, 16), np.uint32)
        out[:self.nplain] = self.rows[:self.nplain]
        return out


def rules_base_eligible(w: bytes) -> bool:
    """The device-expansion split predicate (must match
    ``M22000Engine._rules_flush``): overlong bases and anything that
    could put ``$HEX[...]`` syntax in front of the engine's unhex stage
    go to the host interpreter."""
    return len(w) <= 63 and b"HEX[" not in w


def frame_rules_packed(chunks, total: int, batch_size: int,
                       base_offset: int = 0, start: int = 0):
    """Frame a warm rules-base cache range into ``Block``s — the
    ``.rbase`` twin of ``frame_packed``: identical ``(offset, count)``
    geometry to ``frame_blocks`` over the same raw word stream
    (single-process framing; multi-host rules attacks keep the flat
    ``crack_rules`` path), with ``Block.prep`` carrying an eager
    ``RulesPrep`` instead of words.

    ``chunks`` yields ``(chunk_word_offset, marks uint8[nwords],
    rows u32[nplain, 16], fallback list)`` views
    (``dictcache.CachedRulesBase.chunks(start)``); ``marks[i]`` is the
    base length of word ``offset + i`` or ``0xFF`` for a fallback
    word.  ``start``/``base_offset`` follow ``frame_packed``.
    """
    it = iter(chunks)
    cur = None     # (chunk base, marks, rows, fb, plain-cumsum, fb-cumsum)
    pos = start
    while pos < total:
        c = min(batch_size, total - pos)
        lo, hi = pos, pos + c
        lens_parts, rows_parts, fbs = [], [], []
        a = lo
        while a < hi:
            while cur is None or cur[0] + len(cur[1]) <= a:
                cbase, marks, rows, fb = next(it)
                cur = (cbase, marks, rows, fb,
                       np.cumsum(marks != 0xFF), np.cumsum(marks == 0xFF))
            cbase, marks, rows, fb, pcum, fcum = cur
            b = min(hi, cbase + len(marks))
            i, j = a - cbase, b - cbase
            ps = int(pcum[i - 1]) if i else 0
            pe = int(pcum[j - 1]) if j else 0
            fs = int(fcum[i - 1]) if i else 0
            fe = int(fcum[j - 1]) if j else 0
            m = marks[i:j]
            lens_parts.append(m[m != 0xFF])
            rows_parts.append(rows[ps:pe])
            fbs.extend(fb[fs:fe])
            a = b
        lens = (np.concatenate(lens_parts) if lens_parts
                else np.zeros(0, np.uint8))
        nplain = len(lens)
        packed = np.zeros((nplain, 16), np.uint32)
        r = 0
        for rp in rows_parts:
            packed[r:r + len(rp)] = rp
            r += len(rp)
        yield Block(offset=base_offset + (pos - start), count=c, words=[],
                    prep=RulesPrep(packed, lens, nplain, fbs),
                    padded=(c == 0))
        pos += c


def frame_packed(chunks, total: int, batch_size: int, nproc: int = 1,
                 pid: int = 0, base_offset: int = 0, start: int = 0):
    """Frame a warm packed-dict word range into ``Block``s — the
    index-backed twin of ``frame_blocks``: identical ``(offset, count,
    padded)`` geometry for the same word stream and ``(batch_size,
    nproc, pid)``, but driven by the cache's chunk index instead of the
    decoded words (``Block.words`` stays empty; ``Block.prep`` carries
    a lazy ``PackedSlices``).

    ``chunks`` yields ``(chunk_word_offset, lens, rows)`` views
    (``CachedDict.chunks(start)``); ``total`` is the dict's word count;
    ``start`` is the first word index to serve (a resume/shard seek —
    an index lookup, not a prefix replay); ``base_offset`` is the
    GLOBAL stream offset of word ``start``.
    """
    it = iter(chunks)
    cur = None               # (chunk base, lens view, valid-cumsum, rows)
    gsize = batch_size * nproc
    pos = start
    while pos < total:
        c = min(gsize, total - pos)
        blk = _blk(c, batch_size, nproc)
        lo = pos + min(pid * blk, c)
        hi = pos + min(pid * blk + blk, c)
        parts = []
        a = lo
        while a < hi:
            while cur is None or cur[0] + len(cur[1]) <= a:
                cbase, lens_all, rows = next(it)
                cur = (cbase, lens_all, np.cumsum(lens_all != 0), rows)
            cbase, lens_all, vcum, rows = cur
            b = min(hi, cbase + len(lens_all))
            i, j = a - cbase, b - cbase
            vs = int(vcum[i - 1]) if i else 0
            ve = int(vcum[j - 1]) if j else 0
            parts.append((lens_all[i:j], rows[vs:ve]))
            a = b
        yield Block(offset=base_offset + (pos - start), count=c, words=[],
                    prep=PackedSlices(parts, batch_size), padded=(hi == lo))
        pos += c
        if c < gsize:
            return


def skip_stream(words, skip: int):
    """Resume fast-forward: consume up to ``skip`` words; returns how
    many were actually skipped (< ``skip`` on a short stream) — the
    count the client folds into its pass accounting."""
    if skip <= 0:
        return 0
    return sum(1 for _ in itertools.islice(iter(words), skip))

"""Persistent packed-dictionary cache: the O(1)-seek warm dict feed.

A copy of ``dwpa_tpu/feed/dictcache.py`` (the port keeps its own; the
on-disk format is byte for byte the same, so a cache written by either
package is read warm by the other).

The workload model (PAPER.md) re-cracks every new ESSID group against
the same server-published dict set, keyed by ``dicts.dhash`` — so the
host-side cost of a dict pass (gunzip + ``$HEX`` decode + native
packing, ``gen.DictStream`` + ``pack_candidates_fast``) is paid on
effectively 100%-recurring inputs, and ``DictStream(skip=N)`` replays
the whole gzip prefix to honor a resume.  This module caches the
RESULT of that work per dict, in the design language of ``pmkstore/``:
CRC-framed chunks in a per-dict segment file, torn-tail tolerance on
open, whole-file LRU eviction under a byte cap.

On-disk format (one file per dict, ``<root>/<dhash>.dcache``):

- 8-byte magic ``b"DWDCCH1\\n"`` + the dict's raw 16-byte md5 (dhash) —
  a cache file copied or renamed under another dict's key is detected
  and treated as a miss (dhash-mismatch invalidation);
- CRC-framed chunks: ``b"DCTF" | payload_len u32 LE | crc32 u32 LE |
  payload`` where the payload is ``word_offset u64 | nwords u32 |
  nvalid u32 | lens uint8[nwords] | pad-to-4 | rows u32 LE
  [nvalid * 16]``.  ``lens[i]`` is the DECODED length of word
  ``offset + i`` when it passes the 8..63 PSK filter, else 0, so a
  chunk self-describes both the word count the stream framing sees and
  the packed-row subset the engine stages — any ``(batch_size, nproc,
  pid, skip)`` geometry can be served from one cache by column
  slicing, and a ``(offset, count)`` seek is a bisect on the chunk
  index, never a prefix replay;
- a final ``b"DCTE"`` END frame (``total_words u64 | total_valid
  u64``) seals the file.  The load walk verifies every frame's CRC and
  the offset chain; a torn tail, a corrupt frame, or a missing END
  makes the whole entry a MISS — the feed falls back to cold
  streaming, so a damaged cache can slow a pass but never corrupt the
  word stream;
- writes go to ``<final>.tmp-<pid>`` and ``os.replace`` into place on
  commit, so concurrent writers and crashes leave either the old entry
  or a complete new one.

The writer additionally cross-checks the native packer's output
against a Python model of the decode/filter (``_valid_len``): any
disagreement abandons the cache write and the pass stays cold —
never-wrong-words is enforced at write time too, not just by CRC.

Producer-thread discipline (lint rule DW111): cache I/O belongs to the
feed's producer side (``dwpa_tpu_torch/feed/``); consumer-side engine
code receives pre-packed blocks and never opens cache segments.  The
feed sources take each dict's warm/cold decision through one call,
``DictCache.entry``.  Rows stay on the host here: a warm row reaches a
tensor only as a copy (``framing.PackedSlices.materialize``,
``RulesPrep.padded_rows``), never as a view of the mmap, because
eviction unlinks files under live readers.

Metrics (README "Dict cache"): ``dwpa_dictcache_hit_blocks_total`` /
``dwpa_dictcache_miss_blocks_total`` counters,
``dwpa_dictcache_bytes`` and ``dwpa_dictcache_words_per_s`` (labeled
``feed="warm"|"cold"``) gauges.
"""

import bisect
import mmap
import os
import re
import struct
import zlib

import numpy as np

from ..utils.fsio import fsync_dir

MAGIC = b"DWDCCH1\n"
#: the rules-base species (``<dhash>.rbase``): same framing, but the
#: payload memoizes the DEVICE RULE-EXPANSION split — raw base lengths
#: (no ``$HEX`` decode, no 8..63 filter: rules can shrink/grow any
#: base) with ``0xFF`` marking host-fallback words, packed rows for the
#: eligible bases only, and the fallback words verbatim — so a warm
#: rules unit skips both the split and the pack (``feed.framing
#: .RulesPrep`` / ``M22000Engine._rules_flush``)
RBASE_MAGIC = b"DWRBCH1\n"
FRAME_MAGIC = b"DCTF"
END_MAGIC = b"DCTE"
FRAME_HEADER = len(FRAME_MAGIC) + 8   # magic + payload_len u32 + crc32 u32
HEADER = len(MAGIC) + 16              # file magic + raw dhash

#: words per cached chunk — the seek granularity (a ``(offset, count)``
#: lookup scans at most one chunk's lens column) and the writer's
#: packing batch; 4096 words is <= ~260 KiB of rows per frame
CHUNK_WORDS = 4096

#: the WPA-PSK length filter the packer applies (m22000.py
#: MIN_PSK_LEN/MAX_PSK_LEN — duplicated as protocol constants so this
#: host-only module never imports the torch engine)
_MIN_LEN, _MAX_LEN = 8, 63

_DHASH_RE = re.compile(r"^[0-9a-f]{32}$")
_XDIGITS = frozenset(b"0123456789abcdefABCDEF")


def _valid_len(w: bytes) -> int:
    """Decoded length of ``w`` if it passes the PSK filter, else 0 —
    the Python model of ``native.pack_candidates_fast``'s per-word
    decision (pack_fast.cpp ``try_unhex`` + length filter), used to
    build the lens column and cross-check the native packer."""
    n = len(w)
    if 7 <= n <= 134 and w.startswith(b"$HEX[") and w.endswith(b"]"):
        k = n - 6
        if k % 2 == 0 and k // 2 <= 64 and all(c in _XDIGITS for c in w[5:-1]):
            n = k // 2
    return n if _MIN_LEN <= n <= _MAX_LEN else 0


class CachedDict:
    """One complete, mmap-backed packed dict — the warm read side.

    Chunk views are zero-copy ``np.frombuffer`` windows into the mmap;
    the mapping stays alive as long as any view does (numpy holds the
    buffer), so dropping a CachedDict mid-serve is safe and ``close``
    is only for tests that need the unmap to happen eagerly.
    """

    __slots__ = ("_mm", "_base", "_nwords", "_nvalid", "_lens_off",
                 "_rows_off", "total_words", "total_valid", "nbytes")

    def __init__(self, mm, base, nwords, nvalid, lens_off, rows_off,
                 total_words, total_valid):
        self._mm = mm
        self._base = base
        self._nwords = nwords
        self._nvalid = nvalid
        self._lens_off = lens_off
        self._rows_off = rows_off
        self.total_words = total_words
        self.total_valid = total_valid
        self.nbytes = len(mm)

    @classmethod
    def _load(cls, mm, dhash: str):
        """Frame-walk a cache file; None on ANY structural doubt (bad
        magic, dhash mismatch, bad CRC, broken offset chain, missing
        END) — the caller then treats the dict as cold."""
        if len(mm) < HEADER or mm[:len(MAGIC)] != MAGIC:
            return None
        if mm[len(MAGIC):HEADER] != bytes.fromhex(dhash):
            return None
        buf = memoryview(mm)
        pos, off_expect, valid_total = HEADER, 0, 0
        base, nwords, nvalid, lens_off, rows_off = [], [], [], [], []
        totals = None
        while pos + FRAME_HEADER <= len(mm):
            magic = bytes(buf[pos:pos + 4])
            plen, crc = struct.unpack_from("<II", buf, pos + 4)
            start, end = pos + FRAME_HEADER, pos + FRAME_HEADER + plen
            if magic not in (FRAME_MAGIC, END_MAGIC) or end > len(mm):
                break
            if zlib.crc32(buf[start:end]) & 0xFFFFFFFF != crc:
                break
            if magic == END_MAGIC:
                if plen == 16:
                    totals = struct.unpack_from("<QQ", buf, start)
                break
            if plen < 16:
                break
            o, nw, nv = struct.unpack_from("<QII", buf, start)
            if o != off_expect or plen != 16 + nw + (-nw % 4) + 64 * nv:
                break
            base.append(o)
            nwords.append(nw)
            nvalid.append(nv)
            lens_off.append(start + 16)
            rows_off.append(start + 16 + nw + (-nw % 4))
            off_expect = o + nw
            valid_total += nv
            pos = end
        if totals is None or totals != (off_expect, valid_total):
            return None
        return cls(mm, base, nwords, nvalid, lens_off, rows_off,
                   off_expect, valid_total)

    def chunks(self, start: int = 0):
        """Yield ``(chunk_word_offset, lens uint8[nwords],
        rows u32[nvalid, 16])`` zero-copy views from the chunk
        containing word index ``start`` onward — the O(1) seek: a
        bisect on the chunk index, no prefix replay."""
        i = max(0, bisect.bisect_right(self._base, start) - 1)
        for k in range(i, len(self._base)):
            nw, nv = self._nwords[k], self._nvalid[k]
            lens = np.frombuffer(self._mm, np.uint8, nw, self._lens_off[k])
            rows = np.frombuffer(self._mm, "<u4", nv * 16,
                                 self._rows_off[k]).reshape(nv, 16)
            yield self._base[k], lens, rows

    def close(self):
        """Eager unmap (tests only — raises BufferError while chunk
        views are still alive; production drops the reference and lets
        the views keep the mapping)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None


class DictCacheWriter:
    """Append-side of one dict's cache entry, fed by the cold tee.

    NEVER raises out of ``add_many``/``commit``/``abort``: a cache
    write failure (disk full, packer disagreement, native packer gone)
    only disables caching for this dict — the word stream the consumer
    sees is untouched.  Chunks are packed with the SAME native packer
    the cold path uses and cross-checked against ``_valid_len``; any
    mismatch abandons the entry.
    """

    #: file magic — the rules-base subclass swaps in its own species
    _MAGIC = MAGIC

    def __init__(self, cache, dhash: str, final_path: str):
        self._cache = cache
        self._final = final_path
        self._tmp = f"{final_path}.tmp-{os.getpid()}"
        self._buf = []
        self._off = 0        # words flushed so far
        self._nvalid = 0
        self.failed = False
        self.committed = False
        self._f = open(self._tmp, "wb")
        self._f.write(self._MAGIC + bytes.fromhex(dhash))

    def add_many(self, words):
        """Buffer a batch of post-DictStream words (order = stream
        order); full chunks are packed and framed out immediately."""
        if self.failed or self.committed:
            return
        try:
            self._buf.extend(words)
            while len(self._buf) >= CHUNK_WORDS:
                self._flush(self._buf[:CHUNK_WORDS])
                del self._buf[:CHUNK_WORDS]
        except Exception:
            self._fail()

    def _flush(self, words):
        from ..native import pack_candidates_fast

        lens = np.fromiter((_valid_len(w) for w in words), np.uint8,
                           count=len(words))
        fast = pack_candidates_fast(words, _MIN_LEN, _MAX_LEN,
                                    capacity=len(words))
        if fast is None:
            raise RuntimeError("native packer unavailable")
        rows, plens, nvalid = fast
        # cross-check: the cache must reproduce the cold path EXACTLY,
        # or it must not exist
        if (nvalid != int(np.count_nonzero(lens))
                or not np.array_equal(np.asarray(plens[:nvalid], np.uint8),
                                      lens[lens > 0])):
            raise RuntimeError("packer/lens-model disagreement")
        payload = (struct.pack("<QII", self._off, len(words), nvalid)
                   + lens.tobytes() + b"\x00" * (-len(words) % 4)
                   + rows[:nvalid].astype("<u4", copy=False).tobytes())
        self._frame(FRAME_MAGIC, payload)
        self._off += len(words)
        self._nvalid += nvalid

    def _frame(self, magic, payload):
        self._f.write(magic + struct.pack(
            "<II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload)

    def commit(self) -> bool:
        """Seal (END frame), fsync, and atomically publish the entry;
        returns False if the write failed anywhere along the way.

        The directory is fsynced after the replace so the publish
        itself survives power loss — without it the rename can vanish
        and leave the fsynced data orphaned under the tmp name.  (For a
        cache that only costs a re-stream, but the END-frame contract
        promises "either absent or complete", so the commit path keeps
        the full durable-rename idiom — see the fsync audit notes in
        ``utils.fsio``.)"""
        if self.failed or self.committed:
            return self.committed
        try:
            if self._buf:
                self._flush(self._buf)
                self._buf = []
            self._frame(END_MAGIC, struct.pack("<QQ", self._off, self._nvalid))
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
            os.replace(self._tmp, self._final)
            fsync_dir(os.path.dirname(os.path.abspath(self._final)))
            self.committed = True
            self._cache._committed()
            return True
        except Exception:
            self._fail()
            return False

    def abort(self):
        """Drop the partial entry (idempotent; no-op after commit)."""
        if self.committed:
            return
        self.failed = True
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
        try:
            os.unlink(self._tmp)
        except OSError:
            pass

    _fail = abort


class CachedRulesBase:
    """One complete, mmap-backed rules-base entry — the warm read side
    of the device rule-expansion feed (``RBASE_MAGIC`` species).

    Chunk payload: ``word_offset u64 | nwords u32 | nplain u32 | marks
    uint8[nwords] | pad-to-4 | rows u32 LE [nplain * 16] | fallback
    blob`` where ``marks[i]`` is the raw base length of word ``offset +
    i`` (eligible for device expansion) or ``0xFF`` (host-fallback
    word: > 63 bytes or a ``HEX[`` carrier), rows pack the eligible
    bases only, and the blob is ``len u32 LE | bytes`` per fallback
    word in stream order, zero-padded to 4.  END totals are
    ``(total_words, total_plain)``.
    """

    __slots__ = ("_mm", "_base", "_nwords", "_nplain", "_marks_off",
                 "_rows_off", "_fb_off", "_fb_end", "total_words",
                 "total_plain", "nbytes")

    def __init__(self, mm, base, nwords, nplain, marks_off, rows_off,
                 fb_off, fb_end, total_words, total_plain):
        self._mm = mm
        self._base = base
        self._nwords = nwords
        self._nplain = nplain
        self._marks_off = marks_off
        self._rows_off = rows_off
        self._fb_off = fb_off
        self._fb_end = fb_end
        self.total_words = total_words
        self.total_plain = total_plain
        self.nbytes = len(mm)

    @classmethod
    def _load(cls, mm, dhash: str):
        """Frame-walk; None on ANY structural doubt (miss semantics of
        ``CachedDict._load``)."""
        if len(mm) < HEADER or mm[:len(RBASE_MAGIC)] != RBASE_MAGIC:
            return None
        if mm[len(RBASE_MAGIC):HEADER] != bytes.fromhex(dhash):
            return None
        buf = memoryview(mm)
        pos, off_expect, plain_total = HEADER, 0, 0
        base, nwords, nplain = [], [], []
        marks_off, rows_off, fb_off, fb_end = [], [], [], []
        totals = None
        while pos + FRAME_HEADER <= len(mm):
            magic = bytes(buf[pos:pos + 4])
            plen, crc = struct.unpack_from("<II", buf, pos + 4)
            start, end = pos + FRAME_HEADER, pos + FRAME_HEADER + plen
            if magic not in (FRAME_MAGIC, END_MAGIC) or end > len(mm):
                break
            if zlib.crc32(buf[start:end]) & 0xFFFFFFFF != crc:
                break
            if magic == END_MAGIC:
                if plen == 16:
                    totals = struct.unpack_from("<QQ", buf, start)
                break
            if plen < 16:
                break
            o, nw, npl = struct.unpack_from("<QII", buf, start)
            rows_at = start + 16 + nw + (-nw % 4)
            if o != off_expect or npl > nw or rows_at + 64 * npl > end:
                break
            base.append(o)
            nwords.append(nw)
            nplain.append(npl)
            marks_off.append(start + 16)
            rows_off.append(rows_at)
            fb_off.append(rows_at + 64 * npl)
            fb_end.append(end)
            off_expect = o + nw
            plain_total += npl
            pos = end
        if totals is None or totals != (off_expect, plain_total):
            return None
        return cls(mm, base, nwords, nplain, marks_off, rows_off,
                   fb_off, fb_end, off_expect, plain_total)

    def _fallback(self, k) -> list:
        """Decode chunk ``k``'s fallback words from the blob."""
        nfb = self._nwords[k] - self._nplain[k]
        out, p, end = [], self._fb_off[k], self._fb_end[k]
        for _ in range(nfb):
            if p + 4 > end:
                raise ValueError("rbase fallback blob truncated")
            (n,) = struct.unpack_from("<I", self._mm, p)
            p += 4
            if p + n > end:
                raise ValueError("rbase fallback blob truncated")
            out.append(self._mm[p:p + n])
            p += n
        return out

    def chunks(self, start: int = 0):
        """Yield ``(chunk_word_offset, marks uint8[nwords],
        rows u32[nplain, 16], fallback list)`` from the chunk containing
        word index ``start`` onward — marks/rows zero-copy, fallback
        decoded per served chunk (feed-producer work)."""
        i = max(0, bisect.bisect_right(self._base, start) - 1)
        for k in range(i, len(self._base)):
            nw, npl = self._nwords[k], self._nplain[k]
            marks = np.frombuffer(self._mm, np.uint8, nw, self._marks_off[k])
            rows = np.frombuffer(self._mm, "<u4", npl * 16,
                                 self._rows_off[k]).reshape(npl, 16)
            yield self._base[k], marks, rows, self._fallback(k)

    def close(self):
        """Eager unmap (tests only; see ``CachedDict.close``)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None


class RulesBaseWriter(DictCacheWriter):
    """Append-side of one dict's ``.rbase`` entry, fed by the rules
    feed's cold tee.  Same never-raises / cross-checked / atomic-commit
    contract as ``DictCacheWriter``; only the per-chunk payload
    differs (split + pack of the DEVICE-ELIGIBLE bases, fallback words
    verbatim)."""

    _MAGIC = RBASE_MAGIC

    def _flush(self, words):
        from ..native import pack_candidates_fast

        marks = np.empty(len(words), np.uint8)
        plain, fb = [], []
        for i, w in enumerate(words):
            # MUST match M22000Engine._rules_flush's split (framing
            # .rules_base_eligible): raw length, no $HEX decode
            if len(w) > _MAX_LEN or b"HEX[" in w:
                marks[i] = 0xFF
                fb.append(w)
            else:
                marks[i] = len(w)
                plain.append(w)
        rows_b = b""
        if plain:
            fast = pack_candidates_fast(plain, 0, _MAX_LEN,
                                        capacity=len(plain))
            if fast is None:
                raise RuntimeError("native packer unavailable")
            rows, plens, nvalid = fast
            # cross-check: the cache must reproduce the cold seam's
            # pack EXACTLY, or it must not exist
            if (nvalid != len(plain)
                    or not np.array_equal(
                        np.asarray(plens[:nvalid], np.uint8),
                        marks[marks != 0xFF])):
                raise RuntimeError("packer/lens-model disagreement")
            rows_b = rows[:nvalid].astype("<u4", copy=False).tobytes()
        blob = b"".join(struct.pack("<I", len(w)) + w for w in fb)
        payload = (struct.pack("<QII", self._off, len(words), len(plain))
                   + marks.tobytes() + b"\x00" * (-len(words) % 4)
                   + rows_b + blob + b"\x00" * (-len(blob) % 4))
        self._frame(FRAME_MAGIC, payload)
        self._off += len(words)
        self._nvalid += len(plain)


#: rules species? -> (file extension, loader, writer class)
_SPECIES = {False: (".dcache", CachedDict._load, DictCacheWriter),
            True: (".rbase", CachedRulesBase._load, RulesBaseWriter)}


class DictCache:
    """Directory of per-dict packed cache files under a byte cap.

    ``entry(dhash, rules, fill)`` is the one warm/cold decision: a
    reader (CachedDict / CachedRulesBase) when a complete entry exists
    — a miss is absent, torn, corrupt, or keyed to different bytes —
    else a writer when one may be started.  Eviction is whole-file,
    oldest-mtime first — a reader touch bumps mtime, so the policy is
    LRU over dicts.  All I/O is feed-producer work.
    """

    def __init__(self, root: str, max_bytes: int = 4 << 30, registry=None):
        self.root = root
        self.max_bytes = int(max_bytes)
        os.makedirs(root, exist_ok=True)
        from ..native import pack_candidates_fast

        # one probe: without the native packer the cold path never
        # produces packed rows, so there is nothing coherent to cache
        self._native_ok = pack_candidates_fast(
            [b"probeword0"], _MIN_LEN, _MAX_LEN, capacity=1) is not None
        if registry is None:
            from ..obs import default_registry

            registry = default_registry()
        self.m_hit_blocks = registry.counter(
            "dwpa_dictcache_hit_blocks_total",
            "candidate blocks served from the packed-dict cache").labels()
        self.m_miss_blocks = registry.counter(
            "dwpa_dictcache_miss_blocks_total",
            "candidate blocks cold-streamed past the packed-dict cache"
        ).labels()
        self._m_bytes = registry.gauge(
            "dwpa_dictcache_bytes",
            "total on-disk bytes of packed-dict cache entries").labels()
        rate = registry.gauge(
            "dwpa_dictcache_words_per_s",
            "dict words/s produced by the last warm/cold dict pass")
        self.m_words_warm = rate.labels(feed="warm")
        self.m_words_cold = rate.labels(feed="cold")
        self._m_bytes.set(float(self._bytes_used()))

    def _path(self, dhash: str, ext: str = ".dcache") -> str:
        return os.path.join(self.root, dhash + ext)

    def _open(self, dhash: str, ext: str, loader):
        if not dhash or not _DHASH_RE.fullmatch(dhash):
            return None
        path = self._path(dhash, ext)
        try:
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None
        cd = loader(mm, dhash)
        if cd is None:
            mm.close()
            return None
        try:
            os.utime(path)
        except OSError:
            pass
        return cd

    def entry(self, dhash: str, rules: bool = False, fill: bool = True):
        """One dict's warm/cold decision, for the feed sources:
        ``(reader, None)`` when a complete entry exists (``.rbase`` when
        ``rules``), else ``(None, writer | None)`` — a writer only when
        ``fill`` (the pass streams the dict from word 0, so the tee sees
        all of it), the key is well formed and the native packer is
        available.  One open and frame walk per dict."""
        ext, loader, cls = _SPECIES[rules]
        rd = self._open(dhash, ext, loader)
        if (rd is not None or not fill or not self._native_ok or not dhash
                or not _DHASH_RE.fullmatch(dhash)):
            return rd, None
        try:
            return None, cls(self, dhash, self._path(dhash, ext))
        except OSError:
            return None, None

    # -- size accounting / eviction ----------------------------------------

    def _entries(self):
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.endswith((".dcache", ".rbase")):
                continue
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((st.st_mtime_ns, st.st_size, path))
        return out

    def _bytes_used(self) -> int:
        return sum(size for _, size, _ in self._entries())

    def _committed(self):
        """Post-publish hook from a writer: refresh the gauge and
        enforce the byte cap."""
        self.evict()

    def evict(self):
        """Unlink oldest-mtime entries until the directory fits the
        cap.  An entry being actively served keeps working — POSIX
        keeps the mmap's pages alive after the unlink."""
        entries = sorted(self._entries())
        total = sum(size for _, size, _ in entries)
        for _, size, path in entries:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
        self._m_bytes.set(float(total))

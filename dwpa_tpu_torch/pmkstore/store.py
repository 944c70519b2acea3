"""Persistent per-ESSID PMK store: the cross-unit PBKDF2 cache.

PBKDF2->PMK (8192 SHA-1 compressions per candidate) is most of the
arithmetic of a crack, yet the PMK for a given ``(ESSID, word)`` pair
never changes — popular ESSIDs recur across uploads, dictionaries overlap
heavily, and pass-2 re-runs replay pass-1 words.  This store turns that
repeat work into a disk hit, the airolib-ng / cowpatty ``genpmk``
precomputed-table idea rebuilt around the engine's framed candidate feed
(hashcat-brain dedupes attacked candidates server-side for the same
reason).  It is a copy of ``dwpa_tpu.pmkstore.store``: the on-disk format
is the same byte for byte, so a store written by either package serves
the other.

On-disk format, designed for crash-safety without fsync:

- one directory per ESSID (``<root>/<essid.hex()>/``), so the cache is
  per-ESSID by construction and an ESSID's working set is one directory;
- fixed-width 40-byte records: ``blake2b(word, digest_size=8)`` (8) +
  PMK (32, big-endian words — ``bo.words_to_bytes_be`` order);
- records are appended in CRC-framed batches:
  ``b"PMKF" | count u32 LE | crc32(payload) u32 LE | payload``.
  A crash can tear only the LAST frame of the newest segment; on open
  the frame walk stops at the first bad magic/length/CRC and the torn
  tail is SKIPPED, not fatal — every record in an intact frame keeps
  serving hits;
- segments (``seg-<pid>-<seq>.pmkseg``, 8-byte ``b"DWPMKS01"`` header)
  rotate at ``segment_bytes``; sealed segments are mmap'd and served
  through an in-memory ``digest -> (seq, offset)`` index, while the open
  segment's records are served from a small in-memory tail until it
  seals.  A reopened store never appends to an old segment (so a sealed
  file is immutable and its mmap can't go stale) — it starts a fresh one;
- eviction is whole-segment: when total on-disk bytes exceed
  ``max_bytes``, the oldest sealed segments (globally, by sequence
  number) are unlinked and their index entries dropped — the
  ``--pmk-cache-max-bytes`` cap, paid in coarse rotation units so the
  hot path never rewrites files.

Segment names carry the writing host's process index (``pid``), so
stores written by the hosts of a multi-host slice never share a writer.

Threading: producer threads call ``lookup_digests`` while the consumer
thread writes back through ``put_many`` after the engine's device fetch
(``M22000Engine._collect``); one RLock covers index/tail/segment
mutation.  Everything here is pure host work — no torch imports, by
design.

Metrics: ``dwpa_pmkstore_hits_total`` /
``dwpa_pmkstore_misses_total`` / ``dwpa_pmkstore_writes_total`` /
``dwpa_pmkstore_evictions_total`` counters, ``dwpa_pmkstore_bytes`` and
``dwpa_pmkstore_hit_ratio`` gauges.
"""

import hashlib
import mmap
import os
import re
import struct
import threading
import zlib

SEG_MAGIC = b"DWPMKS01"
FRAME_MAGIC = b"PMKF"
FRAME_HEADER = len(FRAME_MAGIC) + 8   # magic + count u32 + crc32 u32
DIGEST_LEN = 8
PMK_LEN = 32
RECORD = DIGEST_LEN + PMK_LEN         # 40 bytes, fixed width

_SEG_RE = re.compile(r"^seg-(\d+)-(\d+)\.pmkseg$")


def word_digest(word: bytes) -> bytes:
    """8-byte candidate key: blake2b truncated — 64 bits over even a
    billion-word cache keeps accidental collisions ~1e-11, and a
    collision costs one wrong PMK that the MIC/PMKID check rejects."""
    return hashlib.blake2b(word, digest_size=DIGEST_LEN).digest()


class _Segment:
    """One sealed, immutable, mmap-backed segment file."""

    __slots__ = ("path", "essid", "nbytes", "digests", "_mm", "_f")

    def __init__(self, path, essid, nbytes, digests, mm, f):
        self.path = path
        self.essid = essid
        self.nbytes = nbytes
        self.digests = digests  # [(digest, offset-of-pmk)] for eviction
        self._mm = mm
        self._f = f

    def read_pmk(self, off: int) -> bytes:
        return self._mm[off:off + PMK_LEN]

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._f is not None:
            self._f.close()
            self._f = None


class PMKStore:
    """Crash-safe, size-capped, per-ESSID on-disk PMK cache.

    ``lookup_digests``/``lookup`` are safe from feed producer threads
    (pure host reads under the store lock); ``put`` is the consumer
    thread's write-back seam.  ``pid`` tags this host's segments (default
    0 — passed by the client on a multi-host slice).
    """

    def __init__(self, root: str, max_bytes: int = 256 << 20,
                 segment_bytes: int = None, pid: int = 0, registry=None):
        self.root = root
        self.max_bytes = int(max_bytes)
        self.segment_bytes = int(segment_bytes
                                 or max(1 << 20, self.max_bytes // 8))
        self.pid = int(pid)
        self._lock = threading.RLock()
        self._index = {}   # essid -> {digest: (seq, pmk offset)}
        self._segments = {}  # seq -> _Segment (sealed, mmap-backed)
        self._tail = {}    # essid -> {digest: pmk} (open segment's records)
        self._open = {}    # essid -> (file, seq, nbytes written)
        self._seq = 0
        os.makedirs(root, exist_ok=True)
        if registry is None:
            from ..obs import default_registry

            registry = default_registry()
        self._m_hits = registry.counter(
            "dwpa_pmkstore_hits_total", "PMK cache lookups served from disk")
        self._m_miss = registry.counter(
            "dwpa_pmkstore_misses_total",
            "PMK cache lookups that fell through to PBKDF2")
        self._m_writes = registry.counter(
            "dwpa_pmkstore_writes_total", "PMK records written back")
        self._m_evict = registry.counter(
            "dwpa_pmkstore_evictions_total",
            "segments evicted under the size cap")
        self._m_bytes = registry.gauge(
            "dwpa_pmkstore_bytes", "PMK store on-disk bytes")
        self._m_ratio = registry.gauge(
            "dwpa_pmkstore_hit_ratio", "lifetime hit fraction of lookups")
        self._load()

    # -- open / load --------------------------------------------------------

    def _load(self):
        """Scan every ESSID dir, mmap intact segments, index their
        records.  Torn tails (bad magic/length/CRC) stop the frame walk
        for that segment — the prefix keeps serving.  Runs under the
        store lock like every other index mutation: the load is
        init-time today, but the index guard invariant (rule DW302) is
        cheaper to keep than to reason away."""
        found = []
        for name in sorted(os.listdir(self.root)):
            edir = os.path.join(self.root, name)
            if not os.path.isdir(edir):
                continue
            try:
                essid = bytes.fromhex(name)
            except ValueError:
                continue
            for fn in sorted(os.listdir(edir)):
                m = _SEG_RE.match(fn)
                if m:
                    found.append((int(m.group(2)), essid,
                                  os.path.join(edir, fn)))
        with self._lock:
            for seq, essid, path in sorted(found):
                self._seq = max(self._seq, seq + 1)
                self._load_segment(seq, essid, path)
        self._m_bytes.set(self._total_bytes())

    def _load_segment(self, seq: int, essid: bytes, path: str):
        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file (torn at creation): drop it
            f.close()
            return
        size = len(mm)
        pos = len(SEG_MAGIC)
        if mm[:pos] != SEG_MAGIC:
            mm.close()
            f.close()
            return
        idx = self._index.setdefault(essid, {})
        digests = []
        while pos + FRAME_HEADER <= size:
            if mm[pos:pos + 4] != FRAME_MAGIC:
                break  # torn tail: skip the rest, keep the prefix
            count, crc = struct.unpack_from("<II", mm, pos + 4)
            payload_off = pos + FRAME_HEADER
            payload_len = count * RECORD
            if payload_off + payload_len > size:
                break  # truncated mid-frame
            payload = mm[payload_off:payload_off + payload_len]
            if zlib.crc32(payload) != crc:
                break  # torn mid-record: CRC catches the partial write
            for i in range(count):
                off = payload_off + i * RECORD
                digest = mm[off:off + DIGEST_LEN]
                idx[digest] = (seq, off + DIGEST_LEN)
                digests.append((digest, off + DIGEST_LEN))
            pos = payload_off + payload_len
        self._segments[seq] = _Segment(path, essid, size, digests, mm, f)

    # -- lookups (producer-thread safe) -------------------------------------

    def lookup_digests(self, essid: bytes, digests) -> list:
        """``[pmk bytes | None, ...]`` aligned with ``digests``.  Counts
        hits/misses and refreshes the hit-ratio gauge."""
        out = []
        hits = 0
        with self._lock:
            tail = self._tail.get(essid)
            idx = self._index.get(essid)
            for d in digests:
                pmk = tail.get(d) if tail else None
                if pmk is None and idx is not None:
                    ref = idx.get(d)
                    if ref is not None:
                        seg = self._segments.get(ref[0])
                        if seg is not None:
                            pmk = seg.read_pmk(ref[1])
                if pmk is not None:
                    hits += 1
                out.append(pmk)
            self._m_hits.inc(hits)
            self._m_miss.inc(len(out) - hits)
        self._update_ratio()
        return out

    def lookup(self, essid: bytes, words) -> list:
        return self.lookup_digests(essid, [word_digest(w) for w in words])

    def _update_ratio(self):
        h = self._m_hits.labels().value
        m = self._m_miss.labels().value
        if h + m:
            self._m_ratio.set(h / (h + m))

    # -- write-back (consumer thread only) -----------------------------------

    def put(self, essid: bytes, words, pmks):
        """Append newly derived PMKs for ``words``.

        ``pmks``: a uint32[8, m] column matrix (the engine's device PMK
        layout, fetched host-side first) or an iterable of 32-byte PMK
        strings.  Already-cached digests are skipped, the rest land in
        ONE CRC frame; rotation and eviction run after the append.

        Deliberately flush-only, no fsync (fsync-audit decision, vs the
        found outbox / resume file which DO pay for it): this is a
        recompute cache on the hot crack path — a power loss tearing
        the last frame costs re-deriving those PMKs, never correctness,
        because the load walk stops at the first bad CRC.  An fsync per
        appended frame would serialize the crack loop on disk latency
        for data that is by definition reproducible.
        """
        pmk_list = self._pmk_bytes(pmks, len(words))
        with self._lock:
            tail = self._tail.setdefault(essid, {})
            idx = self._index.setdefault(essid, {})
            payload = bytearray()
            fresh = []
            for w, pmk in zip(words, pmk_list):
                d = word_digest(w)
                if d in tail or d in idx:
                    continue
                payload += d + pmk
                fresh.append((d, pmk))
            if not fresh:
                return
            f, seq, nbytes = self._open_segment(essid)
            frame_off = nbytes
            f.write(FRAME_MAGIC
                    + struct.pack("<II", len(fresh), zlib.crc32(payload))
                    + payload)
            f.flush()
            nbytes = frame_off + FRAME_HEADER + len(payload)
            self._open[essid] = (f, seq, nbytes)
            off = frame_off + FRAME_HEADER
            for d, pmk in fresh:
                tail[d] = pmk
                idx[d] = (seq, off + DIGEST_LEN)
                off += RECORD
            self._m_writes.inc(len(fresh))
            if nbytes >= self.segment_bytes:
                self._rotate(essid)
            self._evict()
            self._m_bytes.set(self._total_bytes())

    def put_many(self, items):
        """Append write-back for several ESSIDs at once: ``items`` iterates
        ``(essid, words, pmks)`` triples (one ``put`` each), so every
        group pays one frame append.  The engine's write-back lands one
        batch's groups here in one call."""
        for essid, words, pmks in items:
            self.put(essid, words, pmks)

    @staticmethod
    def _pmk_bytes(pmks, n: int) -> list:
        if isinstance(pmks, (list, tuple)):
            return list(pmks)
        import numpy as np

        # uint32[8, m] device layout -> per-word 32-byte big-endian PMKs
        blob = np.ascontiguousarray(
            np.asarray(pmks, dtype=np.uint32)[:, :n].T).astype(">u4").tobytes()
        return [blob[i * PMK_LEN:(i + 1) * PMK_LEN] for i in range(n)]

    # -- segments -----------------------------------------------------------

    def _open_segment(self, essid: bytes):
        ent = self._open.get(essid)
        if ent is not None:
            return ent
        edir = os.path.join(self.root, essid.hex())
        os.makedirs(edir, exist_ok=True)
        seq = self._seq
        self._seq += 1
        path = os.path.join(edir, f"seg-{self.pid}-{seq:010d}.pmkseg")
        f = open(path, "wb")
        f.write(SEG_MAGIC)
        f.flush()
        ent = (f, seq, len(SEG_MAGIC))
        self._open[essid] = ent
        return ent

    def _rotate(self, essid: bytes):
        """Seal the open segment: close, re-open read-only, mmap, move
        its records from the in-memory tail to mmap-served."""
        ent = self._open.pop(essid, None)
        if ent is None:
            return
        f, seq, _ = ent
        f.close()
        self._load_sealed(seq, essid, f.name)
        self._tail.pop(essid, None)

    def _load_sealed(self, seq: int, essid: bytes, path: str):
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        digests = [(d, ref[1]) for d, ref in self._index.get(essid, {}).items()
                   if ref[0] == seq]
        self._segments[seq] = _Segment(path, essid, len(mm), digests, mm, f)

    def _evict(self):
        """Drop the oldest sealed segments until back under the cap."""
        while self._total_bytes() > self.max_bytes and self._segments:
            seq = min(self._segments)
            seg = self._segments.pop(seq)
            idx = self._index.get(seg.essid, {})
            for d, _off in seg.digests:
                if idx.get(d, (None,))[0] == seq:
                    del idx[d]
            seg.close()
            try:
                os.unlink(seg.path)
            except OSError:
                pass
            self._m_evict.inc()

    def _total_bytes(self) -> int:
        sealed = sum(s.nbytes for s in self._segments.values())
        return sealed + sum(n for _f, _s, n in self._open.values())

    # -- lifecycle ----------------------------------------------------------

    def flush(self):
        with self._lock:
            for f, _seq, _n in self._open.values():
                f.flush()

    def close(self):
        with self._lock:
            for essid in list(self._open):
                self._rotate(essid)
            for seg in self._segments.values():
                seg.close()
            self._segments.clear()
            self._index.clear()
            self._tail.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

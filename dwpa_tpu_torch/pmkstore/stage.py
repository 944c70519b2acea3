"""Producer-side hit/miss split for store-backed candidate blocks.

The lookup runs as a PURE HOST stage on the feed's producer threads
(producers make no CUDA call, and store I/O never runs inside device
work): per framed block, the packed candidates are split per ESSID into
cache hits (their PMKs come back from the store as host bytes) and
misses (only those rows ship to the PBKDF2 kernel).  The consumer thread
stages the result (``M22000Engine._prepare_mixed``) and the engine's
mixed dispatch gathers the cached PMKs around the computed ones before
the verify ops — see ``parallel.step.mix_step``.

Shape discipline: the miss sub-batch is padded to one of at most THREE
static widths (``miss_widths``: ~B/8, ~B/2, B) — the same geometry as
``dwpa_tpu.pmkstore.stage``, where it bounds the XLA compiles; here it
bounds the distinct PBKDF2 launch shapes, and the padded width is what
the kernel hashes.
"""

from dataclasses import dataclass, field

import numpy as np

from .store import word_digest


def miss_widths(batch: int, n: int) -> tuple:
    """The static miss sub-batch widths for device batch ``batch`` split
    over ``n`` devices: at most 3 distinct values, each a positive
    multiple of ``n``, the largest exactly ``batch``.

    Geometric (~B/8, ~B/2, B) rather than evenly spaced: PBKDF2 cost is
    proportional to the PADDED width (pad rows hash like real ones), so
    the smallest bucket sets the warm-pass speedup ceiling — B/8 keeps a
    high-hit-ratio stream at ~8x while three widths keep the number of
    distinct shapes bounded."""
    def up(x):
        return max(n, -(-x // n) * n)

    return tuple(sorted({up(batch // 8), up(batch // 2), batch}))


def miss_width(batch: int, n: int, nmiss: int) -> int:
    """Smallest static width that holds ``nmiss`` miss rows."""
    for w in miss_widths(batch, n):
        if nmiss <= w:
            return w
    return batch


@dataclass
class EssidSplit:
    """One ESSID group's hit/miss view of a packed block.

    ``nmiss == 0``: all-hit — ``cached`` IS the full PMK matrix, no
    PBKDF2 at all.  ``nhit == 0``: all-miss — ``miss_rows`` is the full
    packed batch (width ``batch``), identical shapes to the plain path.
    Otherwise ``miss_rows`` holds the compacted misses padded to a
    static width and ``idx`` maps each batch column to its slot in
    ``concat([pmk_miss, cached], axis=1)`` (``mix_step``).
    ``miss_dev``, ``cached_dev`` and ``idx_dev`` are filled on the
    CONSUMER thread by ``M22000Engine._prepare_mixed`` (H2D staging is
    not producer work).
    """

    nmiss: int
    nhit: int
    miss_rows: np.ndarray = None   # uint32[width, 16]
    miss_lens: np.ndarray = None   # per miss row, for column trimming
    miss_words: list = field(default_factory=list)  # write-back alignment
    idx: np.ndarray = None         # int32[batch] gather map
    cached: np.ndarray = None      # uint32[8, batch], hit cols filled
    miss_dev: object = None        # staged device rows (consumer-side)
    cached_dev: object = None      # staged ``cached`` (consumer-side)
    idx_dev: object = None         # staged ``idx`` (consumer-side)


@dataclass
class MixedPrep:
    """A store-split block: what the feed's ``Block.prep`` carries when
    the engine's packer is store-aware (``M22000Engine.host_packer``)."""

    packed: np.ndarray    # uint32[cap, 16] full packed batch (hit decode)
    lens: np.ndarray      # uint8[nvalid]
    nvalid: int
    batch: int            # padded device batch width B
    entries: dict         # essid -> EssidSplit

    def device_tensors(self) -> list:
        """Every tensor ``M22000Engine._prepare_mixed`` staged for this
        block (the stager keeps their memory alive on the compute
        stream)."""
        return [t for ent in self.entries.values()
                for t in (ent.miss_dev, ent.cached_dev, ent.idx_dev)
                if t is not None]


def _decode_words(packed: np.ndarray, lens, nvalid: int) -> list:
    """Recover the candidate bytes from their packed key-block rows (the
    rows are the words, big-endian-packed and zero-padded)."""
    blob = np.ascontiguousarray(packed[:nvalid]).astype(">u4").tobytes()
    return [blob[64 * i:64 * i + int(lens[i])] for i in range(nvalid)]


def split_block(store, essids, packed, lens, nvalid: int, batch_size: int,
                n: int) -> MixedPrep:
    """Split one packed block into per-ESSID hit/miss sub-batches.

    Pure host work (producer-thread safe): word decode, digesting, store
    lookups, numpy shuffling.  ``essids`` is the engine's group snapshot;
    ``n`` the device count the batch is split over (1 for the port's one
    device; kept so the geometry equals ``dwpa_tpu``'s for any ``n``)."""
    B = max(batch_size, -(-nvalid // n) * n)
    words = _decode_words(packed, lens, nvalid)
    digests = [word_digest(w) for w in words]
    entries = {}
    for essid in essids:
        pmks = store.lookup_digests(essid, digests)
        miss_cols = [i for i, p in enumerate(pmks) if p is None]
        nmiss, nhit = len(miss_cols), nvalid - len(miss_cols)
        if nhit == 0:
            # all-miss: the plain path's exact shapes — full batch rows,
            # no scatter, so a cold store costs nothing but the lookup
            entries[essid] = EssidSplit(
                nmiss=nvalid, nhit=0, miss_rows=packed[:B], miss_lens=lens,
                miss_words=words)
            continue
        cached = np.zeros((8, B), np.uint32)
        for i, p in enumerate(pmks):
            if p is not None:
                cached[:, i] = np.frombuffer(p, dtype=">u4")
        if nmiss == 0:
            entries[essid] = EssidSplit(nmiss=0, nhit=nhit, cached=cached)
            continue
        width = miss_width(B, n, nmiss)
        cols = np.asarray(miss_cols, np.int64)
        miss_rows = np.zeros((width, 16), np.uint32)
        miss_rows[:nmiss] = packed[cols]
        # gather map: miss columns read the computed sub-batch, everything
        # else (hits AND padding) reads the cached matrix at its own column
        idx = width + np.arange(B, dtype=np.int32)
        idx[cols] = np.arange(nmiss, dtype=np.int32)
        entries[essid] = EssidSplit(
            nmiss=nmiss, nhit=nhit, miss_rows=miss_rows,
            miss_lens=np.asarray(lens)[cols],
            miss_words=[words[i] for i in miss_cols], idx=idx, cached=cached)
    return MixedPrep(packed=packed, lens=lens, nvalid=nvalid, batch=B,
                     entries=entries)

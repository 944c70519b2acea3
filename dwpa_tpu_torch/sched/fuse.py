"""Mixed-ESSID batch fusion: pack several small work units into one
full device batch (pure host work).

A volunteer's typical work unit is one ESSID group and a dictionary of
about a thousand words.  Cracked alone, such a unit pads its candidates
to the engine's batch width and pays PBKDF2 and every per-batch fixed
cost for dead lanes.  Fusion lays several units' candidates out
unit-major in ONE batch and ships a 4-byte ``unit_id`` per lane; on the
device ``parallel.step.fused_pmk_step`` gathers each lane's salt blocks
from a per-unit table and the PBKDF2 kernel runs in its per-lane-salt
mode.

Widths: a fused batch is padded to one of at most THREE static widths
(``fused_widths``: about B/8, B/2 and B), and the salt table to the
fixed ``max_units`` bucket.  PBKDF2 costs in proportion to the padded
width, so the smallest bucket sets what a lone underfilled wave pays,
and the layouts equal the JAX package's lane for lane.

PMK-store composition: the hit/miss split runs PER UNIT before fusion
(each unit's candidates are looked up under its own ESSID), the fused
compute batch carries only the misses, and the engine gathers the
cached PMKs around the computed ones through the same ``mix_step`` the
single-unit mixed path uses.

Every array here is a host numpy array in the JAX package's layout and
dtype (uint32 rows and tables, int32 ``unit_id`` and ``idx``); the
engine converts at the upload.
"""

from dataclasses import dataclass, field

import numpy as np

from ..models.m22000 import (MAX_PSK_LEN, MIN_PSK_LEN, essid_salt_blocks,
                             essid_salt_lanes)
from ..oracle import m22000 as oracle
from ..pmkstore.store import word_digest
from ..utils import bytesops as bo


def fused_widths(batch: int, n: int) -> tuple:
    """The static fused-batch widths for device batch ``batch`` over
    ``n`` devices: at most 3 distinct values, each a positive multiple
    of ``n``, the largest exactly ``batch``.  The port runs one device,
    so its callers pass ``n = 1``."""
    def up(x):
        return max(n, -(-x // n) * n)

    return tuple(sorted({up(batch // 8), up(batch // 2), batch}))


def fused_width(batch: int, n: int, total: int) -> int:
    """Smallest static fused width that holds ``total`` candidate lanes."""
    for w in fused_widths(batch, n):
        if total <= w:
            return w
    return batch


def pack_salted_lanes(pairs, batch_size: int, n: int):
    """Derive-only mixed-ESSID packing (the server pre-crack path).

    ``pairs``: list of ``(essid, word)`` with words already decoded and
    length-valid (8..63 bytes); at most ``batch_size`` of them.  Returns
    ``(rows uint32[W, 16], salt1 uint32[W, 16], salt2 uint32[W, 16],
    nvalid)`` padded to the static fused width, ready for the per-lane
    rank-2 salt mode of ``pmk_kernel``.  Unlike ``fuse_units`` there is
    no unit table and no store split — the caller demuxes lanes itself —
    so the same ESSID may occupy many lanes.  Dead padding lanes repeat
    lane 0 (word and salt), never introducing a new salt row.
    """
    if not pairs:
        raise ValueError("pack_salted_lanes needs at least one lane")
    if len(pairs) > batch_size:
        raise ValueError(
            f"{len(pairs)} lanes overflow fused batch {batch_size}")
    W = fused_width(batch_size, n, len(pairs))
    rows = np.zeros((W, 16), np.uint32)
    salt1 = np.zeros((W, 16), np.uint32)
    salt2 = np.zeros((W, 16), np.uint32)
    rows[:len(pairs)] = bo.pack_passwords_be(
        [w for _, w in pairs]).astype(np.uint32)
    salt1[:len(pairs)], salt2[:len(pairs)] = essid_salt_lanes(
        [e for e, _ in pairs])
    if len(pairs) < W:
        rows[len(pairs):] = rows[0]
        salt1[len(pairs):] = salt1[0]
        salt2[len(pairs):] = salt2[0]
    return rows, salt1, salt2, len(pairs)


@dataclass
class FusedUnit:
    """One unit's lane window inside a fused batch.

    Logical lanes ``[lo, lo + nvalid)`` hold the unit's candidates
    (unit-major layout); compute (miss) lanes ``[mlo, mlo + nmiss)``
    index the compacted PBKDF2 sub-batch — equal to the logical window
    when no PMK store split the unit.  ``words`` aligns decode and
    ``miss_words`` store write-back; ``count`` is the unit's GLOBAL
    candidate coverage for this batch (resume framing: checkpoints
    advance by ``count``, exactly like ``feed.framing.Block``)."""

    key: bytes
    lo: int
    nvalid: int
    words: list
    count: int
    mlo: int = 0
    nmiss: int = 0
    miss_words: list = field(default_factory=list)


@dataclass
class FusedBatch:
    """One packed mixed-ESSID device batch (host arrays only — the upload
    is consumer-thread work, ``M22000Engine._dispatch_fused``)."""

    width: int             # logical fused width W (static table)
    miss_width: int        # compute width Wm (static table; == W sans store)
    nmiss: int             # real compute lanes
    total: int             # real logical lanes across units
    miss_rows: np.ndarray  # uint32[Wm, 16] packed PBKDF2 input
    miss_lens: np.ndarray  # uint8[nmiss] for column trimming
    unit_id: np.ndarray    # int32[Wm] per-lane salt-table row
    table1: np.ndarray     # uint32[U, 16] per-unit salt block 1
    table2: np.ndarray     # uint32[U, 16] per-unit salt block 2
    idx: np.ndarray = None     # int32[W] mix gather map (None: all-miss)
    cached: np.ndarray = None  # uint32[8, W] hit PMKs at their lanes
    units: list = field(default_factory=list)  # [FusedUnit]

    @property
    def fill(self) -> float:
        """Fraction of logical lanes holding real candidates."""
        return self.total / self.width if self.width else 0.0


def _pack_words(words):
    """Decode + length-filter + pack one unit's candidates (pure host).

    Returns ``(rows uint32[nvalid, 16], lens uint8[nvalid], decoded)``.
    Prefers the native fused pass; the Python fallback matches
    ``M22000Engine._prepare``'s semantics ($HEX decode, 8..63 filter).
    """
    from ..native import pack_candidates_fast

    fast = pack_candidates_fast(words, MIN_PSK_LEN, MAX_PSK_LEN)
    if fast is not None:
        packed, lens, nvalid = fast
        blob = np.ascontiguousarray(packed[:nvalid]).astype(">u4").tobytes()
        decoded = [blob[64 * i:64 * i + int(lens[i])] for i in range(nvalid)]
        return packed[:nvalid], lens[:nvalid], decoded
    decoded = [oracle.hc_unhex(w) for w in words]
    decoded = [w for w in decoded if MIN_PSK_LEN <= len(w) <= MAX_PSK_LEN]
    if not decoded:
        return (np.zeros((0, 16), np.uint32), np.zeros(0, np.uint8), [])
    rows = bo.pack_passwords_be(decoded).astype(np.uint32)
    lens = np.asarray([len(w) for w in decoded], np.uint8)
    return rows, lens, decoded


def fuse_units(parts, batch_size: int, n: int, max_units: int,
               store=None, salts=None):
    """Fuse per-unit candidate lists into one ``FusedBatch``.

    ``parts``: list of ``(key, words, count)`` — unit key (its ESSID),
    raw candidate bytes, and the block's global candidate coverage.
    Keys must be unique (the caller defers a colliding unit to the next
    wave).  ``salts``: optional ``{key: (salt1, salt2)}`` snapshot (the
    engine's ``_salts``); missing keys derive via ``essid_salt_blocks``.

    Pure host work: packing, store lookups (mmap/dict reads), numpy
    shuffling — safe on a producer thread.
    """
    if not parts:
        raise ValueError("fuse_units needs at least one unit part")
    if len(parts) > max_units:
        raise ValueError(f"{len(parts)} units > fuse_max_units={max_units}")
    keys = [k for k, _, _ in parts]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate unit keys in one fused batch: {keys}")

    packed = [(k, *_pack_words(words), count) for k, words, count in parts]
    total = sum(len(words) for _, _, _, words, _ in packed)
    W = fused_width(batch_size, n, total)
    if total > W:
        raise ValueError(f"{total} candidates overflow fused batch {W}")

    # Per-unit hit/miss split BEFORE fusion: each unit's candidates are
    # looked up under its own ESSID; only misses reach the compute batch.
    units, miss_segs, miss_len_segs, uid_segs = [], [], [], []
    cached = np.zeros((8, W), np.uint32) if store is not None else None
    hit_lanes = []  # logical lanes whose PMK comes from the store
    lo = mlo = 0
    for uid, (key, rows, lens, words, count) in enumerate(packed):
        nv = len(words)
        if store is not None and nv:
            pmks = store.lookup_digests(key, [word_digest(w) for w in words])
        else:
            pmks = [None] * nv
        miss_cols = [i for i, p in enumerate(pmks) if p is None]
        for i, p in enumerate(pmks):
            if p is not None:
                cached[:, lo + i] = np.frombuffer(p, dtype=">u4")
                hit_lanes.append(lo + i)
        nm = len(miss_cols)
        if nm:
            cols = np.asarray(miss_cols, np.int64)
            miss_segs.append(rows[cols])
            miss_len_segs.append(np.asarray(lens)[cols])
            uid_segs.append(np.full(nm, uid, np.int32))
        units.append(FusedUnit(
            key=key, lo=lo, nvalid=nv, words=words, count=count,
            mlo=mlo, nmiss=nm,
            miss_words=[words[i] for i in miss_cols] if nm < nv else words))
        lo += nv
        mlo += nm

    nmiss = mlo
    all_miss = not hit_lanes
    # All-miss: the compacted layout IS the logical layout, so the
    # compute width is the logical width and no mix gather runs — the
    # plain fused path costs nothing when the store is cold or absent.
    Wm = W if all_miss else fused_width(batch_size, n, max(nmiss, 1))
    miss_rows = np.zeros((Wm, 16), np.uint32)
    if nmiss:
        miss_rows[:nmiss] = np.concatenate(miss_segs)
    miss_lens = (np.concatenate(miss_len_segs) if nmiss
                 else np.zeros(0, np.uint8))
    unit_id = np.zeros(Wm, np.int32)
    if nmiss:
        unit_id[:nmiss] = np.concatenate(uid_segs)

    idx = None
    if not all_miss:
        # Gather map over concat([pmk_miss, cached], axis=1): miss lanes
        # read their compacted compute slot, hit lanes AND padding read
        # the cached matrix at their own column (mix_step's contract).
        idx = Wm + np.arange(W, dtype=np.int32)
        hit = np.zeros(W, bool)
        hit[np.asarray(hit_lanes, np.int64)] = True
        m = 0
        for u in units:
            for i in range(u.nvalid):
                lane = u.lo + i
                if not hit[lane]:
                    idx[lane] = m
                    m += 1
        if m != nmiss:
            raise AssertionError(f"gather map covers {m} of {nmiss} misses")

    # Per-unit salt tables, padded to the FIXED max_units bucket (repeat
    # row 0), so the table's shape never depends on the wave's unit count.
    s1_rows, s2_rows = [], []
    for key, *_rest in packed:
        s = (salts or {}).get(key) or essid_salt_blocks(key)
        s1_rows.append(np.asarray(s[0], np.uint32))
        s2_rows.append(np.asarray(s[1], np.uint32))
    pad = max_units - len(s1_rows)
    table1 = np.stack(s1_rows + [s1_rows[0]] * pad)
    table2 = np.stack(s2_rows + [s2_rows[0]] * pad)

    return FusedBatch(
        width=W, miss_width=Wm, nmiss=nmiss, total=total,
        miss_rows=miss_rows, miss_lens=miss_lens, unit_id=unit_id,
        table1=table1, table2=table2, idx=idx, cached=cached, units=units)

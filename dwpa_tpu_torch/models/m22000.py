"""m22000 (WPA PMKID / EAPOL 4-way) cracking engine on torch.

Candidate PSKs -> PBKDF2-HMAC-SHA1 -> PMK -> PMKID-HMAC or PRF+MIC
verification with nonce-error correction, on one device.  The executable
spec is the hashlib oracle (``oracle/m22000.py``); every hit the device
reports is re-checked by it before it becomes a ``Found``.

Layout of the device work:

- PBKDF2 is the hand-written CUDA kernel for a CUDA batch
  (``ops/pbkdf2_cuda.py``) and its plain torch version for a CPU batch.
  The ESSID salt blocks are data, so one kernel serves every ESSID.
- Verification takes the per-net constants (PRF message variants, padded
  EAPOL blocks, target words) as int32 tensors with any leading batch of
  nets, and computes every net and every nonce-correction variant as one
  ``[N, V, B]`` batch of eager torch ops (``parallel/step.py``).
- All byte wrangling happens on the host in numpy; the device sees only
  fixed-shape int32 word tensors.
"""

import struct
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..native import pack_candidates_fast
from ..ops import hmac as hm
from ..ops.aes import aes128_cmac
from ..ops.common import bswap32, shr32, to_numpy, to_torch
from ..ops.pbkdf2 import pbkdf2_sha1_pmk
from ..ops.pbkdf2_cuda import pbkdf2_sha1_pmk_cuda
from ..oracle import m22000 as oracle
from ..parallel.device import resolve_device
from ..utils import bytesops as bo
from . import hashline as hl

# Minimum/maximum WPA passphrase length (IEEE 802.11i).
MIN_PSK_LEN = 8
MAX_PSK_LEN = 63

DEFAULT_NC = 8  # client-side hashcat window (--nonce-error-corrections=8)


# ---------------------------------------------------------------------------
# Host-side per-net preparation
# ---------------------------------------------------------------------------


def essid_salt_blocks(essid: bytes):
    """The two PBKDF2 single-block salt messages ``essid || INT32_BE(i)``.

    ESSIDs are <= 32 bytes so ``essid + 4`` always fits one padded SHA-1
    block (after the 64-byte HMAC key block).  Returned as uint32[16]
    numpy arrays.
    """
    out = []
    for i in (1, 2):
        tail = essid + struct.pack(">I", i)
        blk = bo.padded_blocks(tail, 64 + len(tail))[0]
        out.append(np.asarray(blk, dtype=np.uint32))
    return out[0], out[1]


def essid_salt_lanes(essids):
    """Stacked per-lane salt tables for a mixed-ESSID batch: row ``b`` of
    each uint32[B, 16] array is ``essid_salt_blocks(essids[b])`` (the
    rank-2 salt mode of the PMK kernel)."""
    cache = {}
    lanes1, lanes2 = [], []
    for essid in essids:
        pair = cache.get(essid)
        if pair is None:
            pair = cache[essid] = essid_salt_blocks(essid)
        lanes1.append(pair[0])
        lanes2.append(pair[1])
    return np.stack(lanes1), np.stack(lanes2)


def _hmac_msg_blocks(data: bytes, little_endian: bool = False) -> np.ndarray:
    """Pad an HMAC inner message (keyed by one 64-byte block) -> [nb, 16]."""
    return np.asarray(
        bo.message_blocks(data, little_endian, prefix_len=64), dtype=np.uint32
    )


def _nc_variants(h: hl.Hashline, nc: int):
    """(last4, delta, endian) list honoring message_pair gating bits."""
    variants = [(h.anonce[28:32], 0, None)]
    if h.message_pair & hl.MP_APLESS:
        return variants  # M1/M2 from the AP's own frame: nonce is exact
    endians = []
    if h.message_pair & hl.MP_LE:
        endians.append("LE")
    if h.message_pair & hl.MP_BE:
        endians.append("BE")
    if not endians:
        endians = ["LE", "BE"]
    last_le = struct.unpack_from("<I", h.anonce, 28)[0]
    last_be = struct.unpack_from(">I", h.anonce, 28)[0]
    for i in range(1, (nc >> 1) + 2):
        for e in endians:
            if e == "LE":
                variants.append((struct.pack("<I", (last_le + i) & 0xFFFFFFFF), i, "LE"))
                variants.append((struct.pack("<I", (last_le - i) & 0xFFFFFFFF), -i, "LE"))
            else:
                variants.append((struct.pack(">I", (last_be + i) & 0xFFFFFFFF), i, "BE"))
                variants.append((struct.pack(">I", (last_be - i) & 0xFFFFFFFF), -i, "BE"))
    return variants


@dataclass
class PreppedNet:
    """Device constants for one hashline (int32 tensors, uint32 bits)."""

    line: hl.Hashline
    keyver: int                      # 1 | 2 | 3 | 100 (PMKID)
    target: torch.Tensor             # [4] (PMKID/MIC words; LE for keyver 1)
    # PMKID path
    pmkid_block: torch.Tensor = None   # [16]
    # EAPOL path
    variants: tuple = ()               # ((delta, endian), ...) aligned with prf_blocks
    prf_blocks: torch.Tensor = None    # [V, 2, 16] PRF inner-message variants
    eapol_blocks: torch.Tensor = None  # [E, 16] (keyver 1: LE words, 2: BE)
    # keyver 3 (AES-128-CMAC MIC)
    cmac_full: torch.Tensor = None     # [F, 16] byte values
    cmac_last: torch.Tensor = None     # [16] byte values (10*-padded)
    cmac_last_complete: bool = False
    cmac_target: torch.Tensor = None   # [16] byte values


_ARRAY_FIELDS = ("target", "pmkid_block", "prf_blocks", "eapol_blocks",
                 "cmac_full", "cmac_last", "cmac_target")


def prepped_from_numpy(fields: dict, device=None) -> PreppedNet:
    """A ``PreppedNet`` from numpy constants (uint32 arrays, as the JAX
    package's ``PreppedNet`` holds them): each array becomes an int32
    tensor with the same bits on ``device``.  ``fields["line"]`` may be a
    parsed hashline of either package or the raw line."""
    dev = resolve_device(device)
    kw = dict(fields)
    line = kw["line"]
    if not isinstance(line, hl.Hashline):
        line = hl.parse(getattr(line, "raw", line))
    kw["line"] = line
    for f in _ARRAY_FIELDS:
        if kw.get(f) is not None:
            kw[f] = to_torch(kw[f], dev)
    kw["variants"] = tuple(tuple(v) for v in kw.get("variants", ()))
    kw["cmac_last_complete"] = bool(kw.get("cmac_last_complete", False))
    return PreppedNet(**kw)


def prep_net(h: hl.Hashline, nc: int = DEFAULT_NC, device=None) -> PreppedNet:
    """Precompute every per-net constant the device ops need."""
    if h.hash_type == hl.TYPE_PMKID:
        msg = b"PMK Name" + h.mac_ap + h.mac_sta
        return prepped_from_numpy(dict(
            line=h,
            keyver=100,
            target=np.asarray(bo.be_words(h.pmkid_or_mic), dtype=np.uint32),
            pmkid_block=_hmac_msg_blocks(msg)[0],
        ), device)

    keyver = h.keyver
    if keyver not in (1, 2, 3):
        raise ValueError(f"uncrackable key descriptor version {keyver}")
    m, n, ap_off = oracle.nonce_pairs(h)
    variants = _nc_variants(h, nc)
    prf = []
    for last4, _, _ in variants:
        nv = n[: ap_off + 28] + last4 + n[ap_off + 32:]
        if keyver == 3:
            msg = oracle.PRF_LABEL_V3 + m + nv + b"\x80\x01"
        else:
            msg = oracle.PRF_LABEL_V12 + m + nv + b"\x00"
        prf.append(_hmac_msg_blocks(msg))
    fields = dict(
        line=h,
        keyver=keyver,
        target=np.asarray(
            bo.le_words(h.pmkid_or_mic) if keyver == 1 else bo.be_words(h.pmkid_or_mic),
            dtype=np.uint32,
        )[:4],
        variants=tuple((d, e) for _, d, e in variants),
        prf_blocks=np.stack(prf),
    )
    if keyver == 3:
        ep = h.eapol
        nblk = max(1, (len(ep) + 15) // 16)
        complete = len(ep) > 0 and len(ep) % 16 == 0
        last = ep[(nblk - 1) * 16:]
        if not complete:
            last = last + b"\x80" + b"\x00" * (15 - len(last))
        fields.update(
            cmac_full=np.frombuffer(ep[: (nblk - 1) * 16], dtype=np.uint8)
            .reshape(nblk - 1, 16).astype(np.uint32),
            cmac_last=np.frombuffer(last, dtype=np.uint8).astype(np.uint32),
            cmac_last_complete=complete,
            cmac_target=np.frombuffer(h.pmkid_or_mic, dtype=np.uint8).astype(np.uint32),
        )
    else:
        fields["eapol_blocks"] = _hmac_msg_blocks(h.eapol, little_endian=(keyver == 1))
    return prepped_from_numpy(fields, device)


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def _pmk_impl(pw_words, salt1, salt2):
    """PBKDF2 batch -> int32[8, B]: the CUDA kernel for a CUDA batch, the
    plain torch version for a CPU batch, nothing else.

    ``pw_words`` is column-trimmed ([B, W], W in {4, 8, 16}): the host
    ships only the columns real candidates occupy and the zero tail of
    the HMAC key block is rebuilt by the PBKDF2 itself.  ``salt1``/
    ``salt2`` are int32[16] (one ESSID) or int32[B, 16] (one per lane).
    """
    if pw_words.is_cuda:
        return pbkdf2_sha1_pmk_cuda(pw_words, salt1, salt2)
    if pw_words.device.type == "cpu":
        return pbkdf2_sha1_pmk(pw_words, salt1, salt2)
    raise ValueError(f"no PBKDF2 for device {pw_words.device}")



def _pmk_key_block(pmk):
    return [pmk[i] for i in range(8)] + [0] * 8


def _col(t, extra):
    """A constant word with leading net dims ``[*L]`` -> ``[*L, 1 x extra]``,
    so it broadcasts against ``[*L, ..., B]`` batch words."""
    return t.reshape(tuple(t.shape) + (1,) * extra)


def _eq4(out, target, extra):
    m = out[0] == _col(target[..., 0], extra)
    for i in range(1, 4):
        m = m & (out[i] == _col(target[..., i], extra))
    return m


def _block_words(blocks, extra):
    """[*L, nb, 16] constant blocks -> nb lists of 16 broadcastable words."""
    return [[_col(blocks[..., k, j], extra) for j in range(16)]
            for k in range(blocks.shape[-2])]


def _pmkid_impl(pmk, msg_block, target):
    """PMKID match.  ``pmk``: int32[8, B]; ``msg_block``: [*L, 16];
    ``target``: [*L, 4] for any leading net dims ``L``.  -> bool[*L, B]."""
    ist, ost = hm.hmac_sha1_precompute(_pmk_key_block(pmk))
    out = hm.hmac_sha1_blocks(ist, ost, _block_words(msg_block[..., None, :], 1))
    return _eq4(out, target, 1)


def eapol_match(pmk, prf_blocks, eapol_blocks, target, *, keyver):
    """MIC match for keyver 1/2 over all NC variants.

    ``pmk``: int32[8, B]; ``prf_blocks``: [*L, V, 2, 16];
    ``eapol_blocks``: [*L, E, 16]; ``target``: [*L, 4].
    Returns bool[*L, V, B].
    """
    ist, ost = hm.hmac_sha1_precompute(_pmk_key_block(pmk))
    prf = hm.hmac_sha1_blocks(ist, ost, _block_words(prf_blocks, 1))
    eap = _block_words(eapol_blocks, 2)
    kck = list(prf[:4])
    if keyver == 1:
        ii, oo = hm.hmac_md5_precompute([bswap32(w) for w in kck] + [0] * 12)
        out = hm.hmac_md5_blocks(ii, oo, eap)
    else:
        ii, oo = hm.hmac_sha1_precompute(kck + [0] * 12)
        out = hm.hmac_sha1_blocks(ii, oo, eap)
    return _eq4(out, target, 2)


def eapol_cmac_match(pmk, prf_blocks, cmac_full, cmac_last, target, *, last_complete):
    """AES-128-CMAC MIC match (keyver 3, WPA2 802.11w).

    ``prf_blocks``: [*L, V, 2, 16]; ``cmac_full``: [*L, F, 16];
    ``cmac_last``/``target``: [*L, 16] byte values.  -> bool[*L, V, B].
    """
    ist, ost = hm.hmac_sha256_precompute(_pmk_key_block(pmk))
    prf = hm.hmac_sha256_blocks(ist, ost, _block_words(prf_blocks, 1))
    kck_bytes = []
    for w in prf[:4]:
        kck_bytes += [shr32(w, 24), shr32(w, 16) & 0xFF, shr32(w, 8) & 0xFF, w & 0xFF]
    lead = cmac_last.dim() - 1
    full = cmac_full.permute(lead, lead + 1, *range(lead))  # [F, 16, *L]
    mac = aes128_cmac(torch.stack(kck_bytes), full, cmac_last.movedim(-1, 0),
                      last_complete)
    return (mac == _col(target.movedim(-1, 0), 2)).all(dim=0)


def net_match(pmk, net: PreppedNet):
    """Verify one prepped net -> bool[V, B]."""
    if net.keyver == 100:
        return _pmkid_impl(pmk, net.pmkid_block, net.target)[None, :]
    if net.keyver == 3:
        return eapol_cmac_match(pmk, net.prf_blocks, net.cmac_full, net.cmac_last,
                                net.cmac_target, last_complete=net.cmac_last_complete)
    return eapol_match(pmk, net.prf_blocks, net.eapol_blocks, net.target,
                       keyver=net.keyver)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Found:
    """One cracked net, shaped like the reference verifier's return value
    ``[PSK, NC, BE/LE, PMK]``."""

    line: hl.Hashline
    psk: bytes
    nc: int            # signed NC delta (0 = exact)
    endian: str        # "LE" | "BE" | "" (exact / PMKID)
    pmk: bytes


def _trim_cols(max_len: int) -> int:
    """Word columns to ship for a batch whose longest word is ``max_len``
    bytes, bucketed to {4, 8, 16}; the PBKDF2 rebuilds the zero tail of
    the 16-word HMAC key block.  Typical dict words (<= 16 bytes) ship a
    quarter of the full row."""
    need = -(-max_len // 4)
    for w in (4, 8):
        if need <= w:
            return w
    return 16


class _PackedWords:
    """Lazy pws view over packed rows: ``[b]`` rebuilds the candidate
    bytes from its packed key block and length, so a word is only
    materialized for the rare hit columns."""

    __slots__ = ("words", "lens")

    def __init__(self, words, lens):
        self.words = words
        self.lens = lens

    def __getitem__(self, b):
        return bo.words_to_bytes_be(self.words[b])[: int(self.lens[b])]


class _Pipeline:
    """Dispatch/sync pipeline of the crack path.

    Holds up to ``engine.PIPELINE_DEPTH`` dispatched batches; ``push``
    finishes the oldest once the depth is exceeded, so the hits-gate
    sync always trails the dispatch frontier.  ``on_batch`` fires in
    stream order.
    """

    def __init__(self, engine, on_batch=None):
        import collections

        self.engine = engine
        self.on_batch = on_batch
        self.pending = collections.deque()  # (dispatched, raw), oldest first
        self.founds = []

    @property
    def active(self) -> bool:
        return bool(self.pending)

    def push(self, dispatched, raw: int):
        self.pending.append((dispatched, raw))
        if len(self.pending) > self.engine.PIPELINE_DEPTH:
            self.finish_one()

    def skip(self, raw: int):
        """A consumed-but-undispatchable batch: drain first so the report
        keeps stream order."""
        self.drain()
        if self.on_batch is not None:
            self.on_batch(raw, [])

    def finish_one(self):
        dispatched, raw = self.pending.popleft()
        new = self.engine._collect(dispatched)
        self.founds.extend(new)
        if self.on_batch is not None:
            self.on_batch(raw, new)

    def drain(self):
        while self.pending:
            self.finish_one()


class M22000Engine:
    """Crack a set of m22000 hashlines with batches of candidate PSKs.

    Nets are grouped by ESSID, so one PBKDF2 per (candidate, ESSID) feeds
    the PMKID/MIC checks of every net sharing that ESSID.  Per batch the
    only device->host sync is one hit-count scalar; the found matrix and
    PMKs cross to the host only on a batch that holds a find, and every
    device hit is re-checked by the oracle before it becomes a ``Found``.
    """

    def __init__(self, lines, nc: int = DEFAULT_NC, batch_size: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.nc = nc
        self.groups = {}  # essid -> list[PreppedNet] (live/uncracked view)
        self.skipped = []
        # Steps are built once per ESSID group over its FULL original
        # membership and kept for the engine's lifetime: a find masks its
        # net on the host in _collect instead of rebuilding the step.
        self._full = {}   # essid -> original list[PreppedNet]
        self._steps = {}  # essid -> CrackStep (parallel.step.build_crack_step)
        # Per-stage wall-clock accumulators: host pack + H2D enqueue /
        # device dispatch / gate sync + decode.  For feed-prepacked
        # blocks "prepare" counts only the residual on-thread work (the
        # device staging); producer-side pack time lives in the feed's
        # ``feed:produce`` spans instead, so the two never double-count.
        self.stage_times = {"prepare": 0.0, "dispatch": 0.0, "collect": 0.0}
        for line in lines:
            try:
                h = line if isinstance(line, hl.Hashline) else hl.parse(line)
                net = prep_net(h, nc=nc, device=self.device)
            except ValueError:
                self.skipped.append(line)
                continue
            self.groups.setdefault(h.essid, []).append(net)
        self._full = {e: list(g) for e, g in self.groups.items()}
        self._salts = {e: essid_salt_blocks(e) for e in self.groups}

    @property
    def nets(self):
        return [n for group in self.groups.values() for n in group]

    def remove(self, found: Found):
        """Drop a cracked net (and empty groups) from further batches."""
        group = self.groups.get(found.line.essid)
        if not group:
            return
        group[:] = [n for n in group if n.line is not found.line]
        if not group:
            del self.groups[found.line.essid]
            del self._salts[found.line.essid]
            self._steps.pop(found.line.essid, None)
            self._full.pop(found.line.essid, None)

    def _step_for(self, essid: bytes):
        """The crack step for one ESSID group, built once over the group's
        full original membership (see __init__)."""
        from ..parallel.step import build_crack_step

        step = self._steps.get(essid)
        if step is None:
            s1, s2 = self._salts[essid]
            step = build_crack_step(list(self._full[essid]), s1, s2, self.device)
            self._steps[essid] = step
        return step

    def _h2d(self, rows, stager=None):
        """Start the copy of contiguous uint32 ``rows`` to the device as
        int32 words: on the stager's side stream when one is given, else
        through pinned memory with a non-blocking copy on the current
        stream.  On the CPU the rows stay a host tensor."""
        if stager is not None:
            return stager.h2d(rows)
        t = torch.from_numpy(rows.view(np.int32))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prepare(self, passwords):
        """Host stage: decode, filter, pad, pack, and start the async H2D.

        Returns ``(pws, nvalid, pw_words)`` or None if nothing valid.  On
        a GPU the rows go through pinned memory with a non-blocking copy,
        so calling this while earlier batches run overlaps the transfer
        with compute (see ``crack``).
        """
        t0 = time.perf_counter()
        plist = passwords if isinstance(passwords, list) else list(passwords)
        if not plist:
            return None
        # Native fast path: $HEX decode + length filter + pack fused in
        # one C pass (native/pack_fast.cpp).  Falls back to the Python
        # pipeline when the library is unavailable or the batch isn't
        # plain bytes.
        fast = pack_candidates_fast(plist, MIN_PSK_LEN, MAX_PSK_LEN,
                                    capacity=max(self.batch_size, len(plist)))
        if fast is not None:
            self.stage_times["prepare"] += time.perf_counter() - t0
            return self._prepare_staged(*fast)

        # $HEX[...] notation decodes to raw bytes before hashing, matching
        # the server's candidate handling (hc_unhex).
        pws = [oracle.hc_unhex(p) for p in plist]
        pws = [p for p in pws if MIN_PSK_LEN <= len(p) <= MAX_PSK_LEN]
        if not pws:
            return None
        nvalid = len(pws)
        lens = np.fromiter((len(p) for p in pws), np.int64, count=nvalid)
        if nvalid < self.batch_size:
            pws = pws + [b"\x00" * MIN_PSK_LEN] * (self.batch_size - nvalid)
        packed = bo.pack_passwords_be(pws)
        w = _trim_cols(int(lens.max()))
        rows = self._h2d(np.ascontiguousarray(packed[:, :w]))
        self.stage_times["prepare"] += time.perf_counter() - t0
        return _PackedWords(packed, lens), nvalid, rows

    def host_packer(self):
        """Pure-host packing closure for feed producer threads.

        Captures the batch geometry as a plain int so the closure touches
        no engine or device state from the thread — decode, filter and
        pack only; the consumer thread stages the result via
        ``_prepare_staged``.  Returns None for a block when the native
        packer is unavailable (the block then takes the full ``_prepare``
        path on the consumer thread, unchanged semantics).
        ``pack(words, pre=...)`` accepts an already-packed
        ``(rows, lens, nvalid)`` and returns it as is (the feed detects
        this via ``pack.supports_pre``).
        """
        bs = self.batch_size

        def pack(words, pre=None):
            if pre is not None:
                return pre
            return pack_candidates_fast(words, MIN_PSK_LEN, MAX_PSK_LEN,
                                        capacity=max(bs, len(words)))

        pack.supports_pre = True
        return pack

    def _prepare_staged(self, packed, lens, nvalid, stager=None):
        """Consumer-side residual of ``_prepare`` for a feed-prepacked
        block: only the device staging (column trim + async H2D, on the
        stager's side stream when one is given) — the packing already
        happened on a producer thread and is accounted to the feed's
        ``feed:produce`` spans, so ``stage_times["prepare"]`` accumulates
        just this residual.
        """
        t0 = time.perf_counter()
        if nvalid == 0:
            return None
        # Size the device batch from the post-filter count: an oversize
        # batch full of invalid words must not inflate the shape.
        target = max(self.batch_size, nvalid)
        w = _trim_cols(int(lens.max()))
        rows = self._h2d(np.ascontiguousarray(packed[:target, :w]), stager)
        self.stage_times["prepare"] += time.perf_counter() - t0
        return _PackedWords(packed, lens), nvalid, rows

    def _prepare_block(self, block, stager=None):
        """Prep one feed block (``feed.framing.Block``): the staged fast
        path when a producer prepacked it, full ``_prepare`` otherwise.
        Blocks for on-device mask generation and PMK-store mixed blocks
        are refused until their slices land."""
        prep = getattr(block, "prep", None)
        if prep is None:
            return self._prepare(block.words)
        if hasattr(prep, "mask_gen"):
            raise NotImplementedError(
                "on-device mask generation is not ported yet "
                "(ROADMAP later slice 7)")
        if hasattr(prep, "materialize"):
            # a lazy packed prep (framing.PackedSlices) normally
            # materializes on the feed's producer threads; blocks
            # consumed without a feed materialize here instead
            prep = prep.materialize()
        if not isinstance(prep, tuple):
            raise NotImplementedError(
                "PMK-store mixed blocks are not ported yet "
                "(ROADMAP later slice 4)")
        return self._prepare_staged(*prep, stager=stager)

    def _dispatch(self, prep):
        """Enqueue the crack step for every live ESSID group (no host sync).

        The step always runs over the group's full original membership
        (cracked nets included — their extra MIC checks are noise next to
        the shared PBKDF2); _collect masks the dead rows.
        """
        t0 = time.perf_counter()
        pws, nvalid, pw_words = prep
        outs = [(self._full[essid], self._step_for(essid)(pw_words))
                for essid in list(self.groups)]
        self.stage_times["dispatch"] += time.perf_counter() - t0
        return pws, nvalid, outs

    def _decode(self, group, found, pmk_col, pws, live) -> list:
        """Decode one found matrix ([N, V_max, B]) into Found records.

        ``pmk_col(b) -> uint32[8]`` gives a hit column's PMK words.
        ``live`` is the id-set of uncracked nets, shared across a batch's
        groups.
        """
        founds = []
        for ni, net in enumerate(group):
            if id(net.line) not in live:
                continue  # already cracked; the step still computes it
            nf = found[ni]  # [V_max, B]
            for b in np.flatnonzero(nf.any(axis=0)):
                psk = pws[b]
                delta, endian = (0, None)
                if net.keyver != 100:
                    delta, endian = net.variants[int(nf[:, b].argmax())]
                if oracle.check_key_m22000(net.line, [psk], nc=self.nc) is None:
                    continue  # device false positive: reject like the server would
                founds.append(Found(line=net.line, psk=psk, nc=delta,
                                    endian=endian or "",
                                    pmk=bo.words_to_bytes_be(pmk_col(int(b)))))
                live.discard(id(net.line))
                break  # one PSK per net is enough
        return founds

    def _collect(self, dispatched) -> list:
        """Sync stage: gate on hits, decode founds, prune cracked nets."""
        t0 = time.perf_counter()
        pws, nvalid, outs = dispatched
        founds = []
        live = {id(n.line) for g in self.groups.values() for n in g}
        # The hits gate: one scalar per group, fetched together, is the
        # only device->host sync on an all-miss batch.
        hits = torch.stack([out[0] for _, out in outs]).tolist() if outs else []
        for h, (group, (_, found_dev, pmk_dev)) in zip(hits, outs):
            if h == 0:
                continue
            found = found_dev.cpu().numpy().copy()  # writable, not the step's
            found[:, :, nvalid:] = False
            cols = np.flatnonzero(found.any(axis=(0, 1)))
            if not len(cols):
                continue
            # Only the hit columns' PMKs cross to the host.
            idx = torch.from_numpy(cols).to(pmk_dev.device)
            pmk_cols = to_numpy(pmk_dev.index_select(1, idx))
            slot = {int(b): i for i, b in enumerate(cols)}
            founds += self._decode(group, found, lambda b: pmk_cols[:, slot[b]],
                                   pws, live)
        for f in founds:
            self.remove(f)
        self.stage_times["collect"] += time.perf_counter() - t0
        return founds

    def crack_batch(self, passwords) -> list:
        """One batch of candidate byte-strings -> list[Found]."""
        prep = self._prepare(passwords)
        if prep is None:
            return []
        return self._collect(self._dispatch(prep))

    #: Dispatched batches kept in flight ahead of the sync point: while
    #: batch N's gate is read, N+1..N+3 are queued on the device.
    PIPELINE_DEPTH = 3

    def crack(self, candidates, on_batch=None) -> list:
        """Stream candidates in engine-sized batches until exhausted.

        Software pipeline (``_Pipeline``), ``PIPELINE_DEPTH + 1`` deep:
        while the device works on batch N, the host packs and enqueues the
        next ``PIPELINE_DEPTH`` batches, and the hits-gate sync trails the
        dispatch frontier by ``PIPELINE_DEPTH`` batches.

        ``on_batch(consumed, founds)`` is invoked after each batch
        completes, in stream order (consumed = raw candidates in that
        batch, founds = its Found list).
        """
        pipe = _Pipeline(self, on_batch)
        batch = []

        def submit(b):
            prep = self._prepare(b)  # async H2D starts here
            if prep is not None and self.groups:
                pipe.push(self._dispatch(prep), len(b))
            else:
                pipe.skip(len(b))

        for pw in candidates:
            if not self.groups and not pipe.active:
                break
            batch.append(pw)
            if len(batch) == self.batch_size:
                submit(batch)
                batch = []
        if batch:
            submit(batch)
        pipe.drain()
        return pipe.founds

    def crack_blocks(self, blocks, on_batch=None) -> list:
        """Crack a framed candidate-block stream (``dwpa_tpu_torch.feed``).

        The feed-era twin of ``crack``: instead of slicing a flat word
        iterable itself, the engine consumes ``Block``s whose
        ``(offset, count)`` framing was fixed by the producer — so
        ``on_batch(consumed, founds)`` reports each block's global
        candidate coverage (its count), which is what the client's
        resume checkpoint needs.

        Staging is double-buffered (``feed.staging.DeviceStager``): the
        next block's candidate H2D is enqueued on a side stream before
        this block's steps dispatch, and the ``_Pipeline`` trails the
        hits-gate sync ``PIPELINE_DEPTH`` batches behind — packing
        (producer threads), upload (stager) and gate latency (pipeline)
        all hide behind PBKDF2 compute.
        """
        from ..feed.staging import DeviceStager

        pipe = _Pipeline(self, on_batch)
        for block, prep in DeviceStager(self, blocks):
            if not self.groups and not pipe.active:
                break
            if prep is not None and self.groups:
                pipe.push(self._dispatch(prep), block.count)
            else:
                pipe.skip(block.count)
        pipe.drain()
        return pipe.founds

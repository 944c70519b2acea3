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
  EAPOL blocks, target words) as int32 tensors with a leading axis of
  nets, and computes every net and every nonce-correction variant as one
  ``[N, V, B]`` batch (``parallel/step.py``): the hand-written CUDA
  kernels K3 (``ops/verify_cuda.py``, one launch per verify part) for a
  CUDA PMK matrix, their plain torch versions (``ops/verify.py``) for a
  CPU one.
- All byte wrangling happens on the host in numpy; the device sees only
  fixed-shape int32 word tensors.  A rules attack
  (``crack_rules_blocks``) uploads each base block once and mangles it on
  the device by every rule (``rules/device.py``) ahead of PBKDF2 and
  verify (``parallel/step.py`` ``build_rules_step``).  A mask attack
  (``crack_mask``) generates its candidates on the device
  (``gen/mask.py`` ``device_mask_words``) and uploads none.
- With a PMK store attached (``pmk_store=``, ``dwpa_tpu_torch.pmkstore``)
  each block is split on the feed's producer threads into cache hits and
  misses; PBKDF2 runs on the misses only, the cached PMKs are gathered in
  around them (``parallel/step.py`` ``mix_step``), and the new PMKs are
  written back after the hits gate.
- Several small work units fuse into one batch (``crack_fused``,
  ``sched/fuse.py``): each lane carries its unit's row of a per-unit
  salt table, PBKDF2 takes per-lane salts, every unit's verify runs over
  the one PMK matrix, and each unit decodes only its own lane window.
- Per-device streams (``crack_streams``, ``crack_rules_streams``,
  ``parallel/streams.py``) give each device, or each CUDA stream of one
  card, a twin of this engine that cracks whole blocks from a shared
  queue; founds and ``on_batch`` stay in global stream order.
- In a multi-process slice (``parallel/mesh.py``) each process cracks
  its share of every batch on its own device; one all-reduce of the
  hits-gate scalars makes every process take the same branch, and on a
  hit the processes exchange hit columns and candidate bytes (host data
  only) so every process decodes identical founds in global column
  order.
"""

import contextlib
import functools
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..gen.mask import device_mask_words, mask_blocks, mask_words
from ..native import pack_candidates_fast
from ..ops import verify as vf
from ..ops import verify_prep
from ..ops.common import to_numpy, to_torch
from ..ops.pbkdf2 import pbkdf2_sha1_pmk
from ..ops.pbkdf2_cuda import pbkdf2_sha1_pmk_cuda
from ..ops.verify_cuda import cmac_match_cuda, eapol_match_cuda, pmkid_match_cuda
from ..oracle import m22000 as oracle
from ..parallel.device import resolve_device
from ..parallel.mesh import (allgather_host, allreduce_sum_host,
                             process_count, process_index)
from ..pmkstore.stage import MixedPrep, split_block
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


def _on_device(what, cuda_fn, plain_fn, x, *args, **kwargs):
    """``cuda_fn`` (a hand-written kernel) for a CUDA tensor ``x``,
    ``plain_fn`` (its plain torch version) for a CPU one; any other
    device raises.  No fallback: a kernel's failure is the caller's."""
    if x.is_cuda:
        return cuda_fn(x, *args, **kwargs)
    if x.device.type == "cpu":
        return plain_fn(x, *args, **kwargs)
    raise ValueError(f"no {what} for device {x.device}")


def _pmk_impl(pw_words, salt1, salt2, iterations=4096):
    """PBKDF2 batch -> int32[8, B]: the CUDA kernel for a CUDA batch, the
    plain torch version for a CPU batch, nothing else.

    ``pw_words`` is column-trimmed ([B, W], W in {4, 8, 16}): the host
    ships only the columns real candidates occupy and the zero tail of
    the HMAC key block is rebuilt by the PBKDF2 itself.  ``salt1``/
    ``salt2`` are int32[16] (one ESSID) or int32[B, 16] (one per lane,
    the mixed-ESSID mode of ``parallel.step.fused_pmk_step``).
    ``iterations`` is 4096 for a PMK; tests hold the kernel to its plain
    version at fewer.
    """
    return _on_device("PBKDF2", pbkdf2_sha1_pmk_cuda, pbkdf2_sha1_pmk, pw_words, salt1, salt2,
                      iterations)


def pmk_kernel(pw_words, salt1, salt2, iterations=4096):
    """``(pw_words int32[B, W], salt1 int32[16] | int32[B, 16], salt2
    likewise) -> int32[8, B]``: the public PBKDF2 entry on tensors
    (``_pmk_impl``), for callers that derive PMKs without verifying
    them, such as a mixed-ESSID batch from ``sched.fuse.pack_salted_lanes``."""
    return _pmk_impl(pw_words, salt1, salt2, iterations)


def _pmkid_impl(pmk, msg_block, target, *prep):
    """PMKID match.  ``pmk``: int32[8, B]; ``msg_block``: [N, 16];
    ``target``: [N, 4] (or one net's [16] and [4]); ``prep``: K3's
    derived constants of these nets (``ops/verify_prep.derive``, which a
    crack step builds once), which the kernel requires and the plain
    version does not read.  -> bool[N, B].

    K3 (``ops/verify_cuda``) for a CUDA ``pmk``, the plain version
    (``ops/verify``, any leading net dims) for a CPU one, nothing else."""
    return _on_device("verify", functools.partial(pmkid_match_cuda, prep=prep),
                      vf.pmkid_plain, pmk, msg_block, target)


def eapol_match(pmk, prf_blocks, eapol_blocks, target, *prep, keyver):
    """MIC match for keyver 1/2 over all NC variants, routed like
    :func:`_pmkid_impl`.

    ``pmk``: int32[8, B]; ``prf_blocks``: [N, V, 2, 16];
    ``eapol_blocks``: [N, E, 16]; ``target``: [N, 4]; ``prep``: K3's
    derived constants as in :func:`_pmkid_impl`.
    Returns bool[N, V, B].
    """
    return _on_device("verify", functools.partial(eapol_match_cuda, prep=prep),
                      vf.eapol_match_plain, pmk, prf_blocks, eapol_blocks, target,
                      keyver=keyver)


def eapol_cmac_match(pmk, prf_blocks, cmac_full, cmac_last, target, *prep, last_complete):
    """AES-128-CMAC MIC match (keyver 3, WPA2 802.11w), routed like
    :func:`_pmkid_impl`.

    ``prf_blocks``: [N, V, 2, 16]; ``cmac_full``: [N, F, 16];
    ``cmac_last``/``target``: [N, 16] byte values; ``prep`` as in
    :func:`eapol_match`.  -> bool[N, V, B].
    """
    return _on_device("verify", functools.partial(cmac_match_cuda, prep=prep),
                      vf.eapol_cmac_match_plain, pmk, prf_blocks, cmac_full, cmac_last, target,
                      last_complete=last_complete)


def net_match(pmk, net: PreppedNet):
    """Verify one prepped net -> bool[V, B].  On the card it derives the
    net's K3 constants (``ops/verify_prep.derive``) on every call: a
    check of one net, not a crack path."""
    if net.keyver == 100:
        consts = (net.pmkid_block, net.target)
        return _pmkid_impl(pmk, *consts, *_net_prep(pmk, "pmkid", (), consts))[None, :]
    if net.keyver == 3:
        consts = (net.prf_blocks, net.cmac_full, net.cmac_last, net.cmac_target)
        static = (bool(net.cmac_last_complete),)
        return eapol_cmac_match(pmk, *consts, *_net_prep(pmk, "cmac", static, consts),
                                last_complete=static[0])
    consts = (net.prf_blocks, net.eapol_blocks, net.target)
    return eapol_match(pmk, *consts, *_net_prep(pmk, "eapol", (net.keyver,), consts),
                       keyver=net.keyver)


def _net_prep(pmk, kind, static, consts):
    """One net's K3 constants with a net axis of 1, for the kernel; none
    for the plain version."""
    if not pmk.is_cuda:
        return ()
    return verify_prep.derive(kind, static, tuple(c[None] for c in consts))


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
    quarter of the full row.

    A multi-process slice always ships full rows, as the JAX package's
    does: every process stages the same row shape whatever its share's
    longest word."""
    if process_count() > 1:
        return 16
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


class _RuleWords:
    """pws view for a device-mangled batch: column ``b`` decodes by
    applying the host rule to the base word — the executable spec — so
    hit decode never trusts the device transform."""

    __slots__ = ("base", "rule")

    def __init__(self, base, rule):
        self.base = base
        self.rule = rule

    def __getitem__(self, b):
        out = self.rule.apply(self.base[b])
        if out is None or not MIN_PSK_LEN <= len(out) <= MAX_PSK_LEN:
            return None  # rejected/out-of-range: column was zeroed on device
        return out


class _BaseWords:
    """Lazy base-word list over packed rows + lengths (the warm rules
    cache keeps bases in packed device layout; the fallback split
    guarantees they are HEX-free, so a packed row round-trips
    losslessly).  Supports ``len``/indexing/iteration like the raw word
    list it replaces, materializing bytes only on demand."""

    __slots__ = ("rows", "lens", "n")

    def __init__(self, rows, lens, n):
        self.rows = rows
        self.lens = lens
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, b):
        if not 0 <= b < self.n:
            raise IndexError(b)
        return bo.words_to_bytes_be(self.rows[b])[: int(self.lens[b])]


class _ShiftedWords:
    """pws view for one unit's lane window inside a fused batch: batch
    column ``b`` maps to the unit's own candidate list at ``b - lo``;
    columns outside the window (other units' lanes, padding) decode to
    None so ``_decode`` skips them even if a demux mask ever slipped."""

    __slots__ = ("words", "lo")

    def __init__(self, words, lo):
        self.words = words
        self.lo = lo

    def __getitem__(self, b):
        i = b - self.lo
        return self.words[i] if 0 <= i < len(self.words) else None


class _MaskWords:
    """pws stand-in for on-device mask generation: column ``b`` is the
    word at keyspace index ``start + b``, computed on demand on the host,
    so a word is only materialized for the rare hit columns.  ``col0`` is
    column 0's place in the block: a process of a multi-process slice
    generates the block's columns from ``col0`` on, and its hit columns
    are global columns ``col0 + b``."""

    __slots__ = ("mask", "custom", "start", "col0")

    def __init__(self, mask, custom, start, col0=0):
        self.mask = mask
        self.custom = custom
        self.start = start
        self.col0 = col0

    def __getitem__(self, b):
        return next(mask_words(self.mask, self.custom,
                               skip=self.start + b, limit=1))


class _RulesCtx:
    """Shared per-attack context for the device-expansion seam
    (``M22000Engine._rules_flush``): the split rule sets, the expanded
    stream's rule count, and the attack's telemetry."""

    def __init__(self, rules, registry=None, tracer=None):
        from ..obs.metrics import default_registry
        from ..obs.spans import SpanTracer, default_tracer
        from ..rules.device import device_supported, encode_rule

        self.rules = list(rules)
        self.dev_rules = [(r, encode_rule(r)) for r in self.rules
                          if device_supported(r)]
        self.host_rules = [r for r in self.rules
                           if not device_supported(r)]
        self.n_rules = len(self.rules)
        reg = registry if registry is not None else default_registry()
        if tracer is None:
            tracer = default_tracer() if registry is None \
                else SpanTracer(registry)
        self.tracer = tracer
        self.m_device = reg.counter(
            "dwpa_rules_device_expanded_total",
            "(word, rule) pairs expanded on device by the rules seam")
        fb = reg.counter(
            "dwpa_rules_host_fallback_total",
            "(word, rule) pairs routed to the host rule interpreter, "
            "by reason (purge = unsupported op, overflow = length/HEX)")
        self.m_purge = fb.labels(reason="purge")
        self.m_overflow = fb.labels(reason="overflow")
        cols = reg.counter(
            "dwpa_rules_k1_columns_total",
            "K1 columns this process launched for the rules seam, by fill "
            "(candidate = the column carries a (word, rule) pair or a "
            "valid host-tail candidate, pad = a packed device column whose "
            "pair the host expands, or a host-tail batch's padding)")
        self.m_cols_cand = cols.labels(fill="candidate")
        self.m_cols_pad = cols.labels(fill="pad")

    def span(self, name: str):
        return self.tracer.span(name)

    def launched(self, groups: int, columns: int, candidates: int):
        """Count one dispatch's K1 columns: ``columns`` a group, of which
        ``candidates`` carry one, for each of ``groups`` ESSID groups."""
        self.m_cols_cand.inc(groups * candidates)
        self.m_cols_pad.inc(groups * (columns - candidates))


class _BlockAgg:
    """Demux per-sub-batch pipeline events back into per-BLOCK reports.

    A rules block expands into several dispatched sub-batches (fused
    rule chunks + the host-expanded tail); ``_Pipeline`` fires its
    callback once per sub-batch, in stream order, but block callers
    (``crack_rules_blocks`` and the client resume checkpoint behind it)
    need exactly one ``on_batch(consumed, founds)`` per base block.
    ``begin``/``emit``/``close`` bracket each block's emissions;
    ``record`` (installed as the pipeline callback) attributes every
    event to the oldest incompletely-fired block — emission order IS
    event order because the pipeline is FIFO — and a block fires once
    closed and fully collected.  A block that emitted nothing (wholly
    inside the resume prefix, or nothing dispatchable) reports nothing."""

    def __init__(self, on_batch):
        import collections

        self.on_batch = on_batch
        self.blocks = collections.deque()
        self.cur = None

    def begin(self):
        self.cur = {"emitted": 0, "fired": 0, "got": 0,
                    "founds": [], "closed": False}
        self.blocks.append(self.cur)

    def emit(self):
        self.cur["emitted"] += 1

    def record(self, raw, new):
        for b in self.blocks:
            if b["fired"] < b["emitted"]:
                b["fired"] += 1
                b["got"] += raw
                b["founds"].extend(new)
                break
        self._fire()

    def close(self):
        self.cur["closed"] = True
        self.cur = None
        self._fire()

    def _fire(self):
        while self.blocks:
            b = self.blocks[0]
            if not b["closed"] or b["fired"] < b["emitted"]:
                return
            self.blocks.popleft()
            if b["emitted"] and self.on_batch is not None:
                self.on_batch(b["got"], b["founds"])


class _ResumeWindow:
    """The resume window of a rules attack: ``window(consumed)`` takes up
    to ``consumed`` candidates from the ``left`` still to skip and returns
    how many the sub-batch must REPORT (0 = wholly inside the completed
    prefix: don't dispatch)."""

    def __init__(self, skip: int):
        self.left = int(skip)

    def __call__(self, consumed: int) -> int:
        take = min(self.left, consumed)
        self.left -= take
        return consumed - take


class _Clock:
    """The engine's stage clock where it has no tracer: the ``seconds``
    of a ``with`` body, as a span's (no span is opened)."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


#: ``dwpa_engine_gate_inflight_batches`` buckets: 0 (the gate drained
#: the device) up to ``PIPELINE_DEPTH`` + 1
INFLIGHT_BUCKETS = (0, 1, 2, 3, 4)


class _Gate:
    """A dispatched batch's hits gate (``M22000Engine._arm_gate``).

    ``hits``: the batch's group hit scalars stacked (None without a
    group).  On a card they are a pinned host copy enqueued behind the
    batch's launches, and ``event`` is the one CUDA event recorded after
    that copy on the batch's stream: every host read of the batch waits
    on it alone, never on the stream's tail.  On the CPU ``event`` is
    None and ``hits`` is the scalars' own tensor.
    """

    __slots__ = ("hits", "event")

    def __init__(self, hits, event=None):
        self.hits = hits
        self.event = event


@dataclass
class _Batch:
    """A dispatched batch as ``_collect`` takes it: the hit columns'
    words ``pws`` and their count ``nvalid``, ``(group, step output)``
    for each live group in ``outs``, its hits ``gate``; a rules chunk's
    per-process column count ``b_shard``, a PMK-store block's
    ``writeback`` list of ``(essid, miss PMKs, miss words, nmiss)``."""

    pws: object
    nvalid: int
    outs: list
    gate: _Gate
    b_shard: int = None
    writeback: list = None


class _Pipeline:
    """Dispatch/sync pipeline of the crack path.

    Holds up to ``engine.PIPELINE_DEPTH`` dispatched batches; ``push``
    finishes the oldest once the depth is exceeded.  Its hits gate waits
    on that batch's own CUDA event (``M22000Engine._gate``), so the
    batches dispatched after it stay queued on the card while the host
    decodes, reports and stages the next block.  ``on_batch`` fires in
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
    only device->host read is its hit-count scalars, and on a card it
    waits on the batch's own event; the found matrix and PMKs cross to
    the host only on a batch that holds a find (on a card on a side
    stream, behind the same event), and every device hit is re-checked
    by the oracle before it becomes a ``Found``.

    ``tracer`` (an ``obs.spans.SpanTracer``, optional): the consumer loop
    reports to it as ``engine:dispatch`` and ``engine:collect`` spans
    (``engine:gate`` and ``engine:decode`` inside the latter), and its
    registry takes the engine's counters: the batches still running on
    the card when the hits gate returns
    (``dwpa_engine_gate_inflight_batches``, a card only) and the bytes a
    decode copies to the host (``dwpa_engine_found_fetch_bytes_total``).
    Without one the engine opens no span and counts nothing.
    """

    def __init__(self, lines, nc: int = DEFAULT_NC, batch_size: int = 4096,
                 device=None, pmk_store=None, tracer=None):
        self.device = resolve_device(device)
        # Optional persistent PBKDF2 cache (dwpa_tpu_torch.pmkstore): the
        # feed packer splits blocks into cache hits/misses on the producer
        # threads, the mixed dispatch computes only the misses, and
        # _collect writes newly derived PMKs back after the device fetch.
        self.pmk_store = pmk_store
        self.batch_size = int(batch_size)
        self.nc = nc
        self.groups = {}  # essid -> list[PreppedNet] (live/uncracked view)
        self.skipped = []
        # Steps are built once per ESSID group over its FULL original
        # membership and kept for the engine's lifetime: a find masks its
        # net on the host in _collect instead of rebuilding the step.
        self._full = {}   # essid -> original list[PreppedNet]
        self._steps = {}  # essid -> CrackStep (parallel.step.build_crack_step)
        self._rules_steps = {}  # essid -> fused rules step (build_rules_step)
        # Per-stage wall-clock accumulators: host pack + H2D enqueue /
        # device dispatch / gate sync + decode.  For feed-prepacked
        # blocks "prepare" counts only the residual on-thread work (the
        # device staging); producer-side pack time lives in the feed's
        # ``feed:produce`` spans instead, so the two never double-count.
        # ``dispatch`` and ``collect`` add the seconds of their regions'
        # ``engine:dispatch`` / ``engine:collect`` spans: one clock read.
        self.stage_times = {"prepare": 0.0, "dispatch": 0.0, "collect": 0.0}
        self.tracer = tracer
        # a card's side stream for a collect's reads (``_fetching``)
        self._fetch_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._inflight = None   # the gates' CUDA events, one a dispatched batch
        self._inflight_lock = threading.Lock()
        self._m_inflight = self._m_fetch = None
        if tracer is not None:
            reg = tracer.registry
            self._m_fetch = reg.counter(
                "dwpa_engine_found_fetch_bytes_total",
                "bytes a hit decode copies to the host (found matrix, "
                "hit PMK columns)").labels()
            if self.device.type == "cuda":
                self._inflight = []
                self._m_inflight = reg.histogram(
                    "dwpa_engine_gate_inflight_batches",
                    "dispatched batches still running on the device when "
                    "the hits gate returns", buckets=INFLIGHT_BUCKETS).labels()
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

    def _span(self, name: str):
        """The consumer-loop span ``name`` on the engine's tracer, or a
        bare clock without one; either gives ``seconds``."""
        return _Clock() if self.tracer is None else self.tracer.span(name)

    def _arm_gate(self, scalars) -> _Gate:
        """After a batch's launches, inside its ``engine:dispatch`` span:
        the batch's hits gate over its group hit ``scalars``.  On a card
        the stacked scalars are copied ``non_blocking`` into pinned host
        memory and one CUDA event is recorded after the copy on the
        current stream (a device stream's own); that event is also the
        batch's in-flight marker for ``dwpa_engine_gate_inflight_batches``."""
        hits = torch.stack(scalars) if scalars else None
        if self.device.type != "cuda":
            return _Gate(hits)
        if hits is not None:
            hits = torch.empty(hits.shape, dtype=hits.dtype,
                               pin_memory=True).copy_(hits, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        if self._inflight is not None:
            with self._inflight_lock:
                self._inflight.append(ev)
        return _Gate(hits, ev)

    def _gate(self, gate: _Gate) -> list:
        """Read a batch's hits gate: its group hit counts, in a slice
        summed over the slice with one all-reduce (every process takes
        the same branch).  On a card it waits on the batch's own event
        and reads the pinned scalars, and enqueues nothing, so the
        batches dispatched after it keep the card busy; on the CPU it
        reads the scalars as they are.

        With a tracer on a card, the dispatched batches whose event has
        not completed (a non-blocking query) when the gate returns are
        still on the device: their number is one in-flight sample, and
        the completed ones are dropped."""
        with self._span("engine:gate"):
            if gate.event is not None:
                gate.event.synchronize()
            hits = [] if gate.hits is None else gate.hits.tolist()
            if process_count() > 1 and hits:
                hits = allreduce_sum_host(np.asarray(hits, np.int64)).tolist()
        if self._inflight is not None:
            with self._inflight_lock:
                self._inflight[:] = [ev for ev in self._inflight if not ev.query()]
                n = len(self._inflight)
            self._m_inflight.observe(n)
        return hits

    def _fetching(self, gate: _Gate):
        """The context a collect's device reads of its batch run in (the
        hit decode's found matrix, PMK columns and their gather, the
        PMK-store write-back): on a card the engine's side stream, made
        to wait on the batch's gate event first, so each copy waits for
        its own batch and overlaps the queued ones on the copy engine
        instead of draining the card.  The batch's record holds its
        device tensors until the collect returns, and every read there
        is a blocking copy that syncs the side stream alone.  On the
        CPU an empty context."""
        if gate.event is None:
            return contextlib.nullcontext()
        self._fetch_stream.wait_event(gate.event)
        return torch.cuda.stream(self._fetch_stream)

    def _fetched(self, *arrays):
        """Count host copies of a hit decode's device data."""
        if self._m_fetch is not None:
            self._m_fetch.inc(sum(a.nbytes for a in arrays))

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
            self._rules_steps.pop(found.line.essid, None)
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

    def _rules_step_for(self, essid: bytes):
        """The fused expand + crack step (build_rules_step) for one ESSID
        group — same full-membership / lifetime contract as _step_for."""
        from ..parallel.step import build_rules_step

        step = self._rules_steps.get(essid)
        if step is None:
            s1, s2 = self._salts[essid]
            step = build_rules_step(list(self._full[essid]), s1, s2, self.device)
            self._rules_steps[essid] = step
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
            return self._padding_prep(t0)
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
            return self._padding_prep(t0)
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
        ``(rows, lens, nvalid)`` and skips the packer (the feed detects
        this via ``pack.supports_pre``).

        With a ``pmk_store`` attached the closure additionally splits the
        packed block into per-ESSID cache hits and misses
        (``pmkstore.stage.split_block`` — store lookups are mmap/dict
        reads, still pure host work) and returns a ``MixedPrep`` the
        engine's mixed dispatch consumes.  Single-process only, as in the
        JAX package: a slice's engines keep the plain path.
        """
        bs = self.batch_size
        store = self.pmk_store if process_count() == 1 else None
        essids = list(self._salts) if store is not None else None

        def pack(words, pre=None):
            fast = pre
            if fast is None:
                fast = pack_candidates_fast(words, MIN_PSK_LEN, MAX_PSK_LEN,
                                            capacity=max(bs, len(words)))
            if fast is None or store is None or fast[2] == 0:
                return fast
            return split_block(store, essids, *fast, bs, 1)

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
            return self._padding_prep(t0, stager)
        # Size the device batch from the post-filter count: an oversize
        # batch full of invalid words must not inflate the shape.
        target = max(self.batch_size, nvalid)
        w = _trim_cols(int(lens.max()))
        rows = self._h2d(np.ascontiguousarray(packed[:target, :w]), stager)
        self.stage_times["prepare"] += time.perf_counter() - t0
        return _PackedWords(packed, lens), nvalid, rows

    def _prepare_block(self, block, stager=None):
        """Prep one feed block (``feed.framing.Block``): on-device
        generation for a mask block, the store-split mixed path when the
        producer looked the block up in the PMK store, the staged fast
        path when it merely prepacked it, full ``_prepare`` otherwise."""
        prep = getattr(block, "prep", None)
        if prep is None:
            return self._prepare(block.words)
        if hasattr(prep, "mask_gen"):
            # on-device mask generation (gen.mask.MaskPrep): no host
            # bytes at all — generate exactly the block's keyspace slice
            # on this engine's device (a short last block only its own
            # rows; in a slice, this process's ceil(count / nproc)
            # columns of it)
            t0 = time.perf_counter()
            lo, mine = 0, block.count
            if process_count() > 1:
                per = -(-block.count // process_count())
                lo = process_index() * per
                mine = max(0, min(per, block.count - lo))
                if mine == 0:
                    return self._padding_prep(t0, stager)
            pw_words = device_mask_words(prep.mask, prep.start + lo, mine,
                                         prep.custom, device=self.device)
            self.stage_times["prepare"] += time.perf_counter() - t0
            return (_MaskWords(prep.mask, prep.custom, prep.start + lo, lo),
                    mine, pw_words)
        if hasattr(prep, "materialize"):
            # a lazy packed prep (framing.PackedSlices) normally
            # materializes on the feed's producer threads; blocks
            # consumed without a feed materialize here instead
            prep = prep.materialize()
        if isinstance(prep, MixedPrep):
            return self._prepare_mixed(prep, stager)
        return self._prepare_staged(*prep, stager=stager)

    def _prepare_mixed(self, mp, stager=None):
        """Consumer-side staging of a store-split block: start the async
        H2D of each group's compacted miss sub-batch (column-trimmed like
        ``_prepare_staged``) and of its cached-PMK matrix and gather map,
        on the stager's side stream when one is given.  Same
        ``stage_times["prepare"]`` accounting as the staged path — the
        split itself ran on a producer thread and lives in
        ``feed:produce`` spans."""
        t0 = time.perf_counter()
        for ent in mp.entries.values():
            if ent.nmiss:
                w = _trim_cols(int(ent.miss_lens.max()))
                ent.miss_dev = self._h2d(
                    np.ascontiguousarray(ent.miss_rows[:, :w]), stager)
            if ent.nhit:
                ent.cached_dev = self._h2d(ent.cached, stager)
                if ent.nmiss:
                    ent.idx_dev = self._h2d(ent.idx, stager)
        self.stage_times["prepare"] += time.perf_counter() - t0
        return _PackedWords(mp.packed, mp.lens), mp.nvalid, mp

    def _padding_prep(self, t0, stager=None):
        """All-padding batch for a process whose share holds no valid
        word.

        In a multi-process slice every process must collect the same
        batches in the same order (each collect joins the global hits
        gate); if this process skipped a batch its peers dispatched, the
        gate's all-reduce would pair different batches.  A batch of zero
        rows keeps the count equal, and ``nvalid = 0`` masks every column
        at decode.  Single-process engines keep the cheap skip (None).
        """
        if process_count() <= 1:
            return None
        rows = np.zeros((self.batch_size, _trim_cols(MIN_PSK_LEN)), np.uint32)
        pw_words = self._h2d(rows, stager)
        self.stage_times["prepare"] += time.perf_counter() - t0
        return [], 0, pw_words

    def _dispatch(self, prep):
        """Enqueue the crack step for every live ESSID group (no host sync).

        The step always runs over the group's full original membership
        (cracked nets included — their extra MIC checks are noise next to
        the shared PBKDF2); _collect masks the dead rows.
        """
        pws, nvalid, pw_words = prep
        with self._span("engine:dispatch") as sp:
            writeback = None
            if isinstance(pw_words, MixedPrep):
                outs, writeback = self._dispatch_mixed(pw_words)
            else:
                outs = [(self._full[essid], self._step_for(essid)(pw_words))
                        for essid in list(self.groups)]
            gate = self._arm_gate([out[0] for _, out in outs])
        self.stage_times["dispatch"] += sp.seconds
        return _Batch(pws, nvalid, outs, gate, writeback=writeback)

    def _dispatch_mixed(self, mp):
        """Mixed hit/miss dispatch (PMK store): per group, PBKDF2 runs
        only on the compacted miss sub-batch, cached PMKs are gathered
        around the computed ones into the full ``int32[8, B]`` matrix
        (``parallel.step.mix_step``), and the group's verify runs
        unchanged on that matrix — an all-hit block dispatches NO PBKDF2
        work.  Returns ``(outs, writeback)``: the write-back list (miss
        PMK device tensors + their words) is what ``_collect`` flushes to
        the store AFTER the hits gate, on the consumer thread."""
        from ..parallel.step import mix_step

        outs, writeback = [], []
        for essid in list(self.groups):
            step = self._step_for(essid)
            ent = mp.entries[essid]
            if ent.nmiss == 0:
                pmk = ent.cached_dev
            else:
                pmk_miss = step.compute_pmk(ent.miss_dev)
                writeback.append((essid, pmk_miss, ent.miss_words, ent.nmiss))
                pmk = (pmk_miss if ent.nhit == 0 else
                       mix_step(pmk_miss, ent.cached_dev, ent.idx_dev))
            outs.append((self._full[essid], step.verify(pmk)))
        return outs, writeback

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
                if psk is None:
                    continue  # outside a fused unit's window (_ShiftedWords)
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

    def _decode_rules(self, group, bits_dev, pws, nvalid, b_local, live) -> list:
        """Decode a fused rules chunk's bit-packed found-any mask.

        ``bits_dev``: int32[R, ceil(B/32)], bit b of word b>>5 = column b
        matched SOME net (build_rules_step).  For each set bit the host
        re-derives which net, the NC delta/endian and the PMK by running
        the ORACLE on the candidate that the host rule makes of the base
        word (``_RuleWords``) — finds are rare and the oracle is the
        executable spec, so this is both cheap and authoritative.

        ``b_local`` is the dispatch's per-process column count.  In a
        multi-process slice each process holds the mask of its own row
        slice; one allgather of the masks (host data) gives every process
        the global mask, and since every process holds the global base
        words (``crack_rules``' contract) each decodes every column
        itself — identical founds, no candidate exchange.
        """
        founds = []
        mine = to_numpy(bits_dev)
        self._fetched(mine)
        bits = allgather_host(mine)  # [nproc, R, ceil(b_local/32)]
        assert bits.shape[0] * b_local >= nvalid, (bits.shape, b_local, nvalid)
        for r in range(bits.shape[1]):
            if not bits[:, r].any():
                continue  # no hits for this rule
            hit = np.concatenate([
                np.unpackbits(np.ascontiguousarray(part[r]).view(np.uint8),
                              bitorder="little")[:b_local]
                for part in bits])
            for b in np.flatnonzero(hit[:nvalid]):
                psk = pws[r][int(b)]
                if psk is None:
                    continue  # zeroed column (reject/overflow)
                for net in group:
                    if id(net.line) not in live:
                        continue
                    chk = oracle.check_key_m22000(net.line, [psk], nc=self.nc)
                    if chk is None:
                        continue  # device false positive for this net
                    _, delta, endian, pmk = chk
                    founds.append(Found(line=net.line, psk=psk, nc=delta or 0,
                                        endian=endian or "", pmk=pmk))
                    live.discard(id(net.line))
        return founds

    def _gather_find_data(self, found_dev, pmk_dev, pws, nvalid):
        """Multi-process hit decode (rare path): ``(found, pmk_col, psks)``
        over the slice's hit columns in global column order.

        Each process masks its own padding (columns ``>= nvalid``), then
        the slice runs two fixed-shape allgathers of host data: first
        every process's hit-column count and row width, then one padded
        row per hit column — its global column, candidate bytes, PMK
        words and found bits.  Global column ``p * width + b`` is the JAX
        package's layout (``width`` the largest row count; a mask block's
        share carries its own ``col0``).  Every process then decodes the
        same compact matrix ``found[N, V, K]``, ``pmk_col(k)`` and
        ``psks[k]``, so every engine prunes the same nets.
        """
        found = found_dev.cpu().numpy().copy()  # writable, not the step's
        self._fetched(found)
        found[:, :, nvalid:] = False
        n, v, width = found.shape
        cols = np.flatnonzero(found.any(axis=(0, 1)))
        meta = allgather_host(np.asarray([len(cols), width], np.int64))
        base = getattr(pws, "col0", None)
        if base is None:
            base = process_index() * int(meta[:, 1].max())
        rowlen = 5 + MAX_PSK_LEN + 32 + n * v   # col(4) len(1) psk pmk bits
        ex = np.zeros((max(1, int(meta[:, 0].max())), rowlen), np.uint8)
        if len(cols):
            idx = torch.from_numpy(cols).to(pmk_dev.device)
            pmk_cols = to_numpy(pmk_dev.index_select(1, idx))
            self._fetched(pmk_cols)
            for i, b in enumerate(cols):
                psk = pws[int(b)]
                ex[i, 0:4] = np.frombuffer(struct.pack("<I", base + int(b)), np.uint8)
                ex[i, 4] = len(psk)
                ex[i, 5:5 + len(psk)] = np.frombuffer(psk, np.uint8)
                o = 5 + MAX_PSK_LEN
                ex[i, o:o + 32] = pmk_cols[:, i].astype("<u4").view(np.uint8)
                ex[i, o + 32:] = found[:, :, b].reshape(-1)
        allex = allgather_host(ex)
        rows = np.concatenate([part[:int(c)] for part, c in zip(allex, meta[:, 0])])
        gcols = rows[:, 0:4].copy().view("<u4").reshape(-1)
        rows = rows[np.argsort(gcols, kind="stable")]
        o = 5 + MAX_PSK_LEN
        found_c = rows[:, o + 32:].reshape(-1, n, v).transpose(1, 2, 0).astype(bool)
        pmk_c = rows[:, o:o + 32].copy().view("<u4")            # [K, 8]
        psks = [bytes(r[5:5 + int(r[4])]) for r in rows]
        return found_c, lambda k: pmk_c[k], psks

    def _collect(self, rec: _Batch) -> list:
        """Sync stage: gate on hits, decode founds, prune cracked nets,
        then write a mixed block's new PMKs back to the store.

        The hits gate (``_gate``), one scalar per group read together, is
        the only device->host read on an all-miss batch; the decode's and
        the write-back's reads run behind the batch's own event
        (``_fetching``).  In a multi-process slice the gate is global, so
        every process takes the same branch and joins the same hit
        exchange."""
        with self._span("engine:collect") as sp:
            founds = []
            live = {id(n.line) for g in self.groups.values() for n in g}
            hits = self._gate(rec.gate)
            with self._fetching(rec.gate):
                for h, (group, out) in zip(hits, rec.outs):
                    if h:
                        with self._span("engine:decode"):
                            founds += self._decode_hits(group, out, rec.pws, rec.nvalid,
                                                        rec.b_shard, live)
                for f in founds:
                    self.remove(f)
                if rec.writeback and self.pmk_store is not None:
                    # PMK-store write-back: the one place newly derived
                    # PMKs leave the device outside a find.  It runs on
                    # the consumer thread after the hits gate, one store
                    # call per batch; the [8, nmiss] miss matrices are an
                    # intentional per-batch D2H — they turn the NEXT
                    # unit's repeats into hits.
                    self.pmk_store.put_many(
                        (essid, words, to_numpy(pmk[:, :nmiss]))
                        for essid, pmk, words, nmiss in rec.writeback)
        self.stage_times["collect"] += sp.seconds
        return founds

    def _decode_hits(self, group, out, pws, nvalid, b_shard, live) -> list:
        """The founds of one group the hits gate flagged: its found
        matrix (a rules chunk's bit mask) and hit PMK columns fetched,
        in a slice exchanged, then decoded and checked by the oracle."""
        if len(out) == 2:  # fused rules chunk: (hits, packed found-any)
            return self._decode_rules(group, out[1], pws, nvalid, b_shard, live)
        _, found_dev, pmk_dev = out
        if process_count() > 1:
            found, pmk_col, psks = self._gather_find_data(
                found_dev, pmk_dev, pws, nvalid)
            return self._decode(group, found, pmk_col, psks, live)
        found = found_dev.cpu().numpy().copy()  # writable, not the step's
        self._fetched(found)
        found[:, :, nvalid:] = False
        cols = np.flatnonzero(found.any(axis=(0, 1)))
        if not len(cols):
            return []
        # Only the hit columns' PMKs cross to the host.
        idx = torch.from_numpy(cols).to(pmk_dev.device)
        pmk_cols = to_numpy(pmk_dev.index_select(1, idx))
        self._fetched(pmk_cols)
        slot = {int(b): i for i, b in enumerate(cols)}
        return self._decode(group, found, lambda b: pmk_cols[:, slot[b]], pws, live)

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
        next ``PIPELINE_DEPTH`` batches.  Batch N's hits gate waits on
        N's own CUDA event, ``PIPELINE_DEPTH`` batches behind the
        dispatch frontier, so those batches stay queued on the card
        while the host decodes N, reports it and packs the next batch.

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
        this block's steps dispatch, and the ``_Pipeline`` reads each
        block's hits gate ``PIPELINE_DEPTH`` blocks behind dispatch,
        waiting on that block's own CUDA event.  So packing (producer
        threads), upload (stager) and the consumer thread's own work
        between gates (decode, ``on_batch``'s checkpoint, the next pull
        and staging) all hide behind the PBKDF2 compute of the blocks
        still queued.
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

    def _twin_factory(self):
        """``factory(device)`` building this engine's twin on one device
        over the SAME hashline objects, so a find on one stream prunes
        the net on every other (``remove`` matches by line identity)."""
        lines = [n.line for n in self.nets]

        def _default_factory(device):
            return type(self)(lines, nc=self.nc, batch_size=self.batch_size,
                              device=device, pmk_store=self.pmk_store,
                              tracer=self.tracer)

        return _default_factory

    def crack_streams(self, blocks, on_batch=None, *, devices=None,
                      registry=None, tracer=None, engine_factory=None,
                      max_attempts=2) -> list:
        """Crack a framed block stream as independent device streams.

        The stream twin of ``crack_blocks`` (``parallel/streams.py``):
        each stream gets its own single-device engine and crunches WHOLE
        blocks pulled from a shared queue, under its own CUDA stream —
        no global barrier, so a straggler only slows its own stream.
        ``on_batch(consumed, founds)`` keeps the ``crack_blocks``
        contract exactly: one call per block, in global stream order,
        with the block's global count.  Found lists match the lockstep
        path's (ordered demux dedups by net; first block wins).

        ``devices`` defaults to every local CUDA device for a CUDA
        engine (one stream on a one-card host) and this engine's device
        otherwise; a device may be named twice to run two streams on it.
        A block that fails on every stream raises ``StreamError``.
        Single-process only: a multi-process slice needs the lockstep
        global hits gate.  ``engine_factory(device)`` overrides the
        per-stream engine for tests and benches.
        """
        from ..parallel.streams import StreamExecutor, stream_devices

        if process_count() > 1:
            raise RuntimeError(
                "crack_streams is single-process only — a multi-process "
                "slice keeps the lockstep path (parallel/streams.py)")
        if devices is None:
            devices = stream_devices(self.device)
        ex = StreamExecutor(engine_factory or self._twin_factory(), devices,
                            registry=registry, tracer=tracer,
                            max_attempts=max_attempts)
        founds = ex.run(blocks, on_batch=on_batch)
        for f in founds:
            self.remove(f)  # keep this (parent) engine's live view in sync
        return founds

    def crack_mask(self, mask: str, skip: int = 0, limit: int = None,
                   custom: dict = None, on_batch=None) -> list:
        """Mask attack with on-device candidate generation.

        Unlike ``crack``, no candidate bytes ever exist on the host: each
        block is generated by ``gen.mask.device_mask_words`` in
        ``_prepare_block`` and fed straight to the crack steps, so the
        only host work per batch is an O(positions) digit vector and the
        hits-gate scalar.  Words are materialized from their keyspace
        index only for the rare hit columns.  ``skip``/``limit`` slice the
        keyspace exactly like ``gen.mask.mask_words`` (hashcat -s/-l
        semantics).  A thin front over ``crack_blocks`` with
        ``gen.mask.mask_blocks``'s ``MaskPrep`` stream.
        """
        return self.crack_blocks(
            mask_blocks(mask, self.batch_size, skip=skip, limit=limit,
                        custom=custom),
            on_batch=on_batch)

    def crack_fused(self, parts, on_batch=None, max_units=8, tracer=None,
                    on_fused=None) -> list:
        """Crack several small work units as fused mixed-ESSID batches.

        ``parts``: iterable of ``(essid, words[, count])`` — one entry
        per (work unit, ESSID) pair, where ``words`` is the unit's raw
        candidate list for that ESSID and ``count`` its global coverage
        (defaults to ``len(words)``; the resume-framing analog of
        ``feed.framing.Block.count``).  Units are buffered and packed
        into full device batches (``sched.fuse.fuse_units``): up to
        ``max_units`` units per batch, flushed early when the next part
        would overflow ``batch_size`` or reuse a pending ESSID (one
        salt-table row per ESSID per batch).  Oversize parts split into
        engine-sized chunks and ride the same machinery.

        Serially, every ~1k-word unit pads to the batch width and pays
        the per-batch fixed costs alone; fused, eight such units share
        one PBKDF2 launch and one hits-gate sync.

        ``on_batch(essid, consumed, founds)`` fires per PART in stream
        order — same at-least-once checkpoint seam as ``crack_blocks``,
        keyed by ESSID so a multi-unit caller can demux.  ``on_fused``
        (optional) receives each ``FusedBatch`` before dispatch — the
        executor's fill/units-per-batch metrics hook.  ``tracer``
        (optional ``obs.spans.SpanTracer``) wraps packing in
        ``sched:fuse`` and sync/demux in ``sched:demux`` spans.
        """
        import collections

        from ..sched.fuse import fuse_units

        if process_count() > 1:
            raise RuntimeError(
                "unit fusion is single-process only (a multi-process slice "
                "takes the serial per-unit path)")
        pipe_founds = []
        inflight = collections.deque()  # dispatched records, oldest first
        pending = []                    # buffered (essid, words, count)
        raw = 0                         # candidate estimate of pending

        def finish_one():
            fb, outs, wb, gate, _staged = inflight.popleft()
            pipe_founds.extend(
                self._collect_fused(fb, outs, wb, gate, on_batch, tracer))

        def flush():
            nonlocal pending, raw
            if not pending:
                return
            parts_now, pending, raw = pending, [], 0
            with (tracer.span("sched:fuse") if tracer else contextlib.nullcontext()):
                fb = fuse_units(parts_now, self.batch_size, 1, max_units,
                                store=self.pmk_store, salts=self._salts)
            if on_fused is not None:
                on_fused(fb)
            if fb.total == 0:
                # Every candidate was invalid: nothing to dispatch, but
                # the units' coverage must still reach the checkpoint.
                if on_batch is not None:
                    for u in fb.units:
                        on_batch(u.key, u.count, [])
                return
            inflight.append(self._dispatch_fused(fb))
            if len(inflight) > self.PIPELINE_DEPTH:
                finish_one()

        for part in parts:
            key, words = part[0], list(part[1])
            count = part[2] if len(part) > 2 else len(words)
            if not self.groups and not inflight:
                break  # everything cracked; stop consuming the stream
            if key not in self.groups:
                # Unit for an already-cracked (or unknown) ESSID: consume
                # it so the caller's checkpoint advances past it.
                if on_batch is not None:
                    on_batch(key, count, [])
                continue
            # Oversize unit: split into engine-sized chunks; each chunk
            # fuses (alone — a full chunk flushes whatever is pending).
            while len(words) > self.batch_size:
                chunk, words = words[:self.batch_size], words[self.batch_size:]
                count -= len(chunk)
                flush()
                pending, raw = [(key, chunk, len(chunk))], len(chunk)
                flush()
            if (raw + len(words) > self.batch_size
                    or any(k == key for k, _, _ in pending)
                    or len(pending) >= max_units):
                flush()
            pending.append((key, words, count))
            raw += len(words)
        flush()
        while inflight:
            finish_one()
        return pipe_founds

    def _dispatch_fused(self, fb):
        """Launch one fused batch (no host sync): ONE per-lane-salt
        PBKDF2 over the compacted miss lanes (``fused_pmk_step`` — the
        ``unit_id`` gather resolves each lane's salt on the device), the
        ``mix_step`` gather when the PMK store contributed hits, then
        every live unit's verify over the SAME [8, W] PMK matrix.  A
        unit's verify sees other units' lanes too — their PMKs were
        derived under a different ESSID, so they cannot match (and
        ``_collect_fused`` masks the columns anyway).  An all-hit batch
        launches no PBKDF2.  The record holds every staged tensor until
        ``_collect_fused`` has read the batch's hits gate."""
        from ..parallel.step import fused_pmk_step, mix_step

        with self._span("engine:dispatch") as sp:
            wb = None
            if fb.nmiss == 0 and fb.cached is not None:
                pmk = self._h2d(fb.cached)
                staged = (pmk,)
            else:
                w = _trim_cols(int(fb.miss_lens.max()))
                staged = tuple(self._h2d(a) for a in (
                    np.ascontiguousarray(fb.miss_rows[:, :w]), fb.unit_id,
                    fb.table1, fb.table2))
                pmk_miss = fused_pmk_step(*staged)
                entries = [(u.key, u.mlo, u.nmiss, u.miss_words)
                           for u in fb.units if u.nmiss]
                wb = (pmk_miss, entries)
                pmk = pmk_miss
                if fb.idx is not None:
                    cached, idx = self._h2d(fb.cached), self._h2d(fb.idx)
                    staged += (cached, idx)
                    pmk = mix_step(pmk_miss, cached, idx)
            outs = []
            for u in fb.units:
                group = self._full.get(u.key)
                if group is None:  # group cracked out from under the stream
                    outs.append((u, None, None))
                    continue
                outs.append((u, group, self._step_for(u.key).verify(pmk)))
            gate = self._arm_gate([out[0] for _, _, out in outs if out is not None])
        self.stage_times["dispatch"] += sp.seconds
        return fb, outs, wb, gate, staged

    def _collect_fused(self, fb, outs, wb, gate, on_batch, tracer) -> list:
        """Sync + demux one fused batch: every live unit's hit scalar
        comes back in ONE read of the batch's hits ``gate`` (``_gate``, as
        in ``_collect``; the decode and write-back read behind its event,
        ``_fetching``); a unit with hits has its found matrix masked
        down to its OWN lane window ``[lo, lo + nvalid)`` before decode
        (a hit in unit A must never surface as unit B's find — the
        columns outside the window belong to other units), cracked nets
        are pruned, new PMKs go back to the store in one ``put_many``,
        and ``on_batch`` fires per unit in layout order."""
        with self._span("engine:collect") as sp:
            founds = []
            by_unit = {id(u): [] for u, _, _ in outs}
            live = {id(n.line) for g in self.groups.values() for n in g}
            with (tracer.span("sched:demux") if tracer else contextlib.nullcontext()):
                real = [(u, g, out) for u, g, out in outs if out is not None]
                hits = self._gate(gate)
                with self._fetching(gate):
                    for h, (u, group, out) in zip(hits, real):
                        if h:
                            with self._span("engine:decode"):
                                new = self._decode_unit(u, group, out, live)
                            by_unit[id(u)].extend(new)
                            founds.extend(new)
                    for f in founds:
                        self.remove(f)
                    if wb is not None and self.pmk_store is not None:
                        # Store write-back (consumer thread, after the hits
                        # gate): each unit's slice of the fused miss PMK
                        # matrix lands under its own ESSID, one store call
                        # per batch.
                        pmk_miss, entries = wb
                        pmk_host = to_numpy(pmk_miss[:, :fb.nmiss])
                        self.pmk_store.put_many(
                            (key, miss_words, pmk_host[:, mlo:mlo + nm])
                            for key, mlo, nm, miss_words in entries)
            if on_batch is not None:
                for u in fb.units:
                    on_batch(u.key, u.count, by_unit[id(u)])
        self.stage_times["collect"] += sp.seconds
        return founds

    def _decode_unit(self, u, group, out, live) -> list:
        """The founds of one fused unit the hits gate flagged: its found
        matrix masked down to its own lane window ``[lo, lo + nvalid)``
        (the other columns are other units' candidates and padding),
        then the hit PMK columns fetched and decoded."""
        _, found_dev, pmk_dev = out
        found = found_dev.cpu().numpy().copy()  # writable, not the step's
        self._fetched(found)
        found[:, :, :u.lo] = False
        found[:, :, u.lo + u.nvalid:] = False
        cols = np.flatnonzero(found.any(axis=(0, 1)))
        if not len(cols):
            return []
        idx = torch.from_numpy(cols).to(pmk_dev.device)
        pmk_cols = to_numpy(pmk_dev.index_select(1, idx))
        self._fetched(pmk_cols)
        slot = {int(b): i for i, b in enumerate(cols)}
        return self._decode(group, found, lambda b: pmk_cols[:, slot[b]],
                            _ShiftedWords(u.words, u.lo), live)

    def _rules_flush(self, ctx, batch, account, gbatch, nproc, pid,
                     push, skip):
        """One base-word flush through the device-expansion seam.

        The shared body of every rules dispatch path (the flat
        ``crack_rules``, block-framed ``crack_rules_blocks``, and the
        per-device stream adapter ``_RulesStreamEngine``): split the
        batch into device-eligible bases vs host-fallback words, plan the
        fused rule chunks (``simulate_lens`` overflow routing + per-chunk
        resume accounting), pack and upload the base block ONCE, dispatch
        every chunk, then host-expand the fallback tail through the
        normal packed path.  ``batch`` is either a raw word list or a
        warm ``feed.framing.RulesPrep`` (pre-split, pre-packed bases —
        the dict cache's base-block layout), in which case both the split
        and the pack are skipped.  ``push(record, report)`` /
        ``skip(report)`` receive the dispatched sub-batches in stream
        order; ``account(consumed)`` owns the caller's resume window.

        ``gbatch`` is the global base words per flush (``batch_size x
        nproc``); in a multi-process slice every process packs the same
        global batch and uploads only its ``1/nproc`` row slice
        (``pid``), and the host tail is sliced the same way.
        """
        from ..parallel.step import RULES_CHUNK
        from ..rules.device import simulate_lens, stack_rules

        rules = ctx.rules
        dev_rules, host_rules = ctx.dev_rules, ctx.host_rules
        base_dev = lens_dev = None
        with ctx.span("rules:expand"):
            if hasattr(batch, "rules_base"):
                # Warm base block: the fallback split and the pack
                # already ran (and were cached); bases stay in packed
                # layout, words materialize lazily on hits.
                pre = batch
                nplain = pre.nplain
                plain = _BaseWords(pre.rows, pre.lens, nplain)
                lens_np = np.asarray(pre.lens[:nplain], dtype=np.int32)
                fallback = [(w, None) for w in pre.fallback]
            else:
                plain, fallback = [], []
                for w in batch:
                    # Host-fallback words: overlong bases, and anything
                    # that could put "$HEX[...]" syntax in front of the
                    # engine's unhex stage (the host paths unhex AFTER
                    # rule application, so the device must not hash such
                    # words literally).  The substring check also catches
                    # bases a rule could extend into a valid wrapper;
                    # synthesizing "HEX[" itself from unrelated
                    # characters via chained inserts remains a
                    # documented, pathological divergence.
                    if len(w) > MAX_PSK_LEN or b"HEX[" in w:
                        fallback.append((w, None))  # None = every rule
                    else:
                        plain.append(w)
                pre = None
                nplain = len(plain)
                lens_np = None
            plan = []  # (chunk, expanded pairs, candidates to report)
            if nplain and self.groups and dev_rules:
                # Per-chunk accounting and host-overflow routing run
                # BEFORE any device work: a resume window covering the
                # whole batch must not pay the H2D upload, and the
                # overflow pairs belong to the host tail regardless.
                # ``expanded`` excludes the overflow pairs deferred to the
                # host tail — each candidate is counted exactly once, or
                # skip-by-count resume would overshoot.
                if lens_np is None:
                    lens_np = np.asarray([len(w) for w in plain], np.int32)
                # Pad to the global batch size like _prepare, so every
                # base block has one shape (and splits evenly over the
                # slice's processes); this process runs rows [lo, hi).
                cap = max(gbatch, -(-nplain // nproc) * nproc)
                lo, hi = pid * (cap // nproc), (pid + 1) * (cap // nproc)
                rows_mine = max(0, min(hi, nplain) - lo)  # real rows of the slice
                for c0 in range(0, len(dev_rules), RULES_CHUNK):
                    chunk = dev_rules[c0:c0 + RULES_CHUNK]
                    overflow = overflow_mine = 0
                    for rule, _steps in chunk:
                        _, hostneed = simulate_lens(rule, lens_np)
                        if hostneed.any():
                            pairs = [(plain[i], rule)
                                     for i in np.flatnonzero(hostneed)]
                            fallback.extend(pairs)
                            overflow += len(pairs)
                            overflow_mine += int(hostneed[lo:hi].sum())
                    expanded = nplain * len(chunk) - overflow
                    # the expanded pairs in this process's rows
                    mine = len(chunk) * rows_mine - overflow_mine
                    plan.append((chunk, expanded, account(expanded), mine))
            if any(rep for _, _, rep, _ in plan):
                t0 = time.perf_counter()
                if pre is not None:
                    rows = pre.padded_rows(cap)  # a copy, never the mmap
                else:
                    packed = pack_candidates_fast(plain, 0, MAX_PSK_LEN, cap)
                    if packed is None:  # no native lib: plain Python pack
                        rows = np.zeros((cap, 16), np.uint32)
                        rows[:nplain] = bo.pack_passwords_be(plain)
                    else:
                        rows, _, n = packed  # lens_np above is the source
                        assert n == nplain  # min_len=0: no compaction
                lens_pad = np.zeros(cap, np.int32)
                lens_pad[:nplain] = lens_np
                # Every process packed the identical global batch; ship
                # only this process's row slice.
                base_dev = self._h2d(np.ascontiguousarray(rows[lo:hi]))
                lens_dev = self._h2d(np.ascontiguousarray(lens_pad[lo:hi]))
                self.stage_times["prepare"] += time.perf_counter() - t0
        if base_dev is not None:
            # Chunked fused dispatch: each chunk expands its rules over
            # the slice's real rows and runs PBKDF2 + verify over the
            # packed candidates, per group, with ONE hits gate.  Nothing
            # is compiled per shape, so a short last chunk is stacked at
            # its own length instead of being padded with noop rules.
            for chunk, expanded, report, mine in plan:
                if not self.groups:
                    break
                if report == 0:
                    continue  # chunk wholly inside the resume prefix
                stack = stack_rules([s for _, s in chunk], len(chunk))
                pws = [_RuleWords(plain, r) for r, _ in chunk]
                with self._span("engine:dispatch") as sp:
                    outs = [(self._full[essid],
                             self._rules_step_for(essid)(base_dev, lens_dev, stack,
                                                         rows_mine))
                            for essid in list(self.groups)]
                    gate = self._arm_gate([out[0] for _, out in outs])
                self.stage_times["dispatch"] += sp.seconds
                ctx.m_device.inc(expanded)
                ctx.launched(len(outs), rows_mine * len(chunk), mine)
                push(_Batch(pws, nplain, outs, gate, b_shard=cap // nproc), report)
        # Host-expanded tail: unsupported rules over plain words, plus the
        # per-(word, rule) fallbacks collected above.  ``consumed`` counts
        # attempted (word, rule) pairs — rejects included, mirroring how
        # the device chunks count them.
        out = []
        pairs_pending = 0

        def submit_host(cands, consumed):
            report = account(consumed)
            if report == 0:
                return  # batch wholly inside the resume prefix
            if nproc > 1:
                # The tail stream is the identical global expansion on
                # every process; each dispatches its contiguous 1/nproc
                # block (an empty block still dispatches padding via
                # _prepare, keeping the slice's collects paired).
                blk = -(-len(cands) // nproc)
                cands = cands[pid * blk:(pid + 1) * blk]
            prep = self._prepare(cands)
            if prep is not None and self.groups:
                ctx.launched(len(self.groups), prep[2].shape[0], prep[1])
                push(self._dispatch(prep), report)
            else:
                skip(report)

        def tail(w, rr):
            nonlocal out, pairs_pending
            pairs_pending += 1
            o = rr.apply(w)
            if o is not None:
                out.append(o)
                if len(out) >= gbatch:
                    submit_host(out, pairs_pending)
                    out, pairs_pending = [], 0

        for w, r in fallback:
            ctx.m_overflow.inc(len(rules) if r is None else 1)
            for rr in (rules if r is None else [r]):
                tail(w, rr)
        if host_rules and nplain:
            ctx.m_purge.inc(nplain * len(host_rules))
            for w in plain:
                for rr in host_rules:
                    tail(w, rr)
        if out or pairs_pending:
            submit_host(out, pairs_pending)

    def crack_rules(self, words, rules, on_batch=None, skip: int = 0, *,
                    registry=None, tracer=None) -> list:
        """Rules attack with ON-DEVICE mangling over a flat word iterable.

        The flat twin of ``crack_rules_blocks``: the engine frames the
        words itself at the global batch size (``batch_size x nproc``)
        and runs each flush through the ``_rules_flush`` seam.
        ``on_batch(consumed, founds)`` fires per dispatched SUB-batch
        (a fused chunk covers base words x chunk rules at once); stream
        order is fixed (base batch major, then device rule chunks in
        order, then the batch's host-expanded tail), so skip offsets
        interchange with ``crack_rules_blocks``'.

        Multi-process contract — unlike ``crack``'s local-shard feed:
        every process passes the SAME global word stream and the same
        ``skip``.  Each process then packs the global batch but uploads
        only its 1/nproc row slice, and the find decode gathers the
        bit-packed masks so every process re-derives identical founds
        from the global column index, with no candidate exchange.
        Host-expanded tails slice the identical global tail per process,
        so the slice's collects stay paired with no extra collective.

        ``skip``: resume fast-forward — sub-batches wholly inside the
        window are not dispatched; a straddling one is re-dispatched in
        full but reports only its unskipped remainder.
        """
        nproc, pid = process_count(), process_index()
        gbatch = self.batch_size * nproc
        ctx = _RulesCtx(rules, registry=registry, tracer=tracer)
        pipe = _Pipeline(self, on_batch)
        account = _ResumeWindow(skip)

        def flush(batch):
            self._rules_flush(ctx, batch, account, gbatch, nproc, pid,
                              pipe.push, pipe.skip)

        batch = []
        for w in words:
            if not self.groups and not pipe.active:
                break
            batch.append(w)
            # Flush at the GLOBAL batch size: each process uploads a
            # batch_size slice of it.
            if len(batch) == gbatch:
                flush(batch)
                batch = []
        if batch and (self.groups or pipe.active):
            flush(batch)
        pipe.drain()
        return pipe.founds

    def crack_rules_blocks(self, blocks, rules, on_batch=None,
                           skip: int = 0, *, registry=None,
                           tracer=None) -> list:
        """Rules attack with ON-DEVICE mangling (``rules/device.py``) over
        a framed base-word block stream (``feed.RulesFeedSource``; cold
        blocks carry raw word lists, warm ones the dict cache's pre-split,
        pre-packed ``RulesPrep`` base layout).

        The host uploads each base block ONCE (packed + lengths) and
        every device-eligible rule mangles it on the device — candidate
        H2D drops by the rule count, as hashcat's GPU rule engine does.
        Per block, through the ``_rules_flush`` seam:

        - words a rule can't cover on device ($HEX/overlong bases, the
          rare length-overflow (word, rule) pairs flagged by
          ``simulate_lens``, rules with unsupported ops) are expanded by
          the host interpreter and fed through the normal packed path —
          same pipeline, same stream;
        - hit columns decode by applying the HOST rule to the base word
          (``_RuleWords``) and re-checking with the oracle, so the device
          transform is never trusted for results.

        Stream order is fixed (block major, then device rule chunks in
        order, then the block's host-expanded tail), and equals the JAX
        engine's ``crack_rules`` over the same words when blocks are
        framed at ``batch_size`` words.  ``on_batch(consumed, founds)``
        fires once per BLOCK in stream order, where ``consumed`` counts
        EXPANDED (word x rule) candidates — the resume domain.

        ``skip`` counts expanded candidates.  A block wholly inside the
        resume window is dropped in O(1) — its coverage is exactly
        ``count x len(rules)`` because the seam counts every (word, rule)
        pair exactly once (device chunks + host tail, rejects included) —
        without packing or device work; the straddling block replays
        at-least-once and reports only its remainder.

        Multi-process: pass GLOBAL blocks (every process the same
        stream), the ``crack_rules`` contract.
        """
        nproc, pid = process_count(), process_index()
        gbatch = self.batch_size * nproc
        ctx = _RulesCtx(rules, registry=registry, tracer=tracer)
        agg = _BlockAgg(on_batch)
        pipe = _Pipeline(self, agg.record)
        account = _ResumeWindow(skip)

        def push(rec, report):
            agg.emit()
            pipe.push(rec, report)

        def skipf(report):
            agg.emit()
            pipe.skip(report)

        for block in blocks:
            if not self.groups and not pipe.active:
                break
            exp = block.count * ctx.n_rules
            if account.left >= exp:
                # O(1) whole-block drop: the expanded-count invariant
                # makes the block's total coverage count x n_rules
                # without splitting, packing or expanding it.
                account.left -= exp
                continue
            prep = getattr(block, "prep", None)
            batch = prep if hasattr(prep, "rules_base") else block.words
            agg.begin()
            self._rules_flush(ctx, batch, account, gbatch, nproc, pid,
                              push, skipf)
            agg.close()
        pipe.drain()
        return pipe.founds

    def crack_rules_streams(self, blocks, rules, on_batch=None,
                            skip: int = 0, *, devices=None, registry=None,
                            tracer=None, engine_factory=None,
                            max_attempts=2) -> list:
        """Rules attack as independent per-device streams.

        The stream twin of ``crack_rules_blocks`` (and the rules analog
        of ``crack_streams``): each stream gets its own single-device
        engine wrapped in the rules seam adapter (``_RulesStreamEngine``)
        and pulls WHOLE base blocks from the shared queue, expanding
        rules on its own device directly ahead of its own PBKDF2
        dispatch.  ``on_batch(consumed, founds)`` fires once per base
        block in global stream order with the block's EXPANDED coverage
        — ``crack_rules_blocks``' framing, so resume offsets interop
        across the rules entry points.  Blocks wholly inside ``skip``
        are dropped before they reach the queue (O(1) per block); the
        straddler carries its in-block expanded skip immutably, so a
        crash requeue replays it deterministically.

        Single-process only (``crack_streams``' contract).
        ``engine_factory(device)`` overrides the per-stream INNER engine
        (the seam adapter still wraps it).
        """
        from ..parallel.streams import StreamExecutor, stream_devices

        if process_count() > 1:
            raise RuntimeError(
                "crack_rules_streams is single-process only — a "
                "multi-process slice keeps the lockstep crack_rules path")
        ctx = _RulesCtx(rules, registry=registry, tracer=tracer)
        if devices is None:
            devices = stream_devices(self.device)
        inner = engine_factory or self._twin_factory()

        def factory(device):
            return _RulesStreamEngine(inner(device), ctx)

        def wrapped():
            pos, skip_left = 0, int(skip)
            for block in blocks:
                exp = block.count * ctx.n_rules
                if skip_left >= exp:
                    skip_left -= exp
                    pos += exp
                    continue
                prep = getattr(block, "prep", None)
                base = prep if hasattr(prep, "rules_base") else block.words
                yield _RulesBlock(pos + skip_left, exp - skip_left,
                                  base, skip_left)
                pos += exp
                skip_left = 0

        ex = StreamExecutor(factory, devices, registry=registry,
                            tracer=tracer, max_attempts=max_attempts)
        founds = ex.run(wrapped(), on_batch=on_batch)
        for f in founds:
            self.remove(f)  # keep this (parent) engine's live view in sync
        return founds


class _RulesBlock:
    """Work item for the per-device rules streams: a base-word block in
    EXPANDED (word x rule) coordinates.

    ``offset``/``count`` frame the block's expanded remainder in the
    global candidate stream (``StreamExecutor`` orders on_batch demux by
    them and reports ``count`` as the consumed amount — identical to
    ``crack_rules_blocks`` framing).  ``base`` is the raw base-word list
    or a warm ``RulesPrep``; ``skip_pairs`` is the immutable in-block
    expanded resume offset — immutable so a crash requeue replays the
    straddling block deterministically on the surviving stream.
    """

    __slots__ = ("offset", "count", "base", "skip_pairs")

    def __init__(self, offset, count, base, skip_pairs=0):
        self.offset = offset
        self.count = count
        self.base = base
        self.skip_pairs = skip_pairs


class _RulesStreamEngine:
    """Adapter giving a single-device engine the block protocol
    ``parallel.streams.DeviceStream`` drives, with rules expansion done
    ON this stream's device via the shared ``_rules_flush`` seam.

    ``_prepare_block`` runs the whole seam for the block (split, pack,
    per-chunk fused dispatch, host tail) on the stream's thread and CUDA
    stream, and buffers the dispatched records; ``_dispatch`` is the
    identity (the device work was queued during prepare — the stream
    still overlaps blocks because results are only waited on in
    ``_collect``, ``PIPELINE_DEPTH`` blocks later).  ``_collect`` drains
    the block's records in order through the inner engine's decode.
    """

    def __init__(self, inner, ctx):
        self.inner = inner
        self.ctx = ctx
        self.device = inner.device
        self.tracer = inner.tracer
        self.PIPELINE_DEPTH = inner.PIPELINE_DEPTH

    @property
    def groups(self):
        return self.inner.groups

    @property
    def nets(self):
        return self.inner.nets

    def remove(self, found):
        self.inner.remove(found)

    def _prepare_block(self, block, stager=None):
        eng = self.inner
        recs = []
        eng._rules_flush(self.ctx, block.base, _ResumeWindow(block.skip_pairs),
                         eng.batch_size, 1, 0,
                         lambda rec, rep: recs.append(rec), lambda rep: None)
        return recs

    def _dispatch(self, recs):
        return recs

    def _collect(self, recs):
        founds = []
        for rec in recs:
            founds.extend(self.inner._collect(rec))
        return founds

"""The crack step: PBKDF2 -> verify for one ESSID group on one device.

``build_crack_step`` returns one callable that runs the whole pipeline for
a candidate batch: the PBKDF2 kernel over ``[B, W]`` packed rows, then
every net's PMKID/MIC check, then a hit count that the host reads as its
only per-batch sync before it fetches the (rare) positives.

Nets are grouped by verify signature (kind, static parameters, constant
shapes).  Each group's constants are stacked along a leading net axis,
padded to a power-of-two bucket (for the card, K3's derived constants
are built from them then, once: ``ops/verify_prep.py``), and verified as
one ``[N, V, B]`` batch
— one launch of the K3 verify kernel for a CUDA PMK matrix, its plain
torch version for a CPU one (``models/m22000``); nets and
nonce-correction variants are tensor dimensions, never Python loops.
The step keeps two seams, ``compute_pmk`` and ``verify``, so a PMK
matrix that arrived by another route (the PMK store's ``mix_step``) can
be verified unchanged.
"""

import numpy as np
import torch

from ..models import m22000 as m
from ..ops.common import to_torch
from ..ops.verify_prep import derive


def pmk_step(pw_words, salt1, salt2):
    """``(pw_words[B, W], salt1[16], salt2[16]) -> pmk int32[8, B]`` on the
    batch's device.  Salts are data, so one kernel serves every ESSID."""
    return m._pmk_impl(pw_words, salt1, salt2)


def fused_pmk_step(pw_words, unit_id, table1, table2, iterations=4096):
    """``(pw_words int32[Wm, w], unit_id int32[Wm], table1 int32[U, 16],
    table2 int32[U, 16]) -> pmk int32[8, Wm]``: the mixed-ESSID fused
    PBKDF2 step.

    Each lane gathers its OWN salt blocks from the per-unit tables on the
    device (``index_select`` gives contiguous [Wm, 16] rows), and the
    PBKDF2 kernel runs in its per-lane-salt mode — the upload for mixing
    ESSIDs in one batch is 4 bytes a lane of ``unit_id``, not 128 bytes a
    lane of salt blocks.  ``iterations`` is 4096 for a PMK.
    """
    return m._pmk_impl(pw_words, table1.index_select(0, unit_id),
                       table2.index_select(0, unit_id), iterations)


def _gate(found, mask):
    """found bool[N, V, B], mask bool[N] -> (exact hit count, found).

    The mask zeroes the bucket-pad rows out of both the count and the
    returned matrix, keeping ``hits`` an exact match count and pad rows
    all-False for consumers.
    """
    found = found & mask[:, None, None]
    return found.sum(dtype=torch.int32), found


# One descriptor per verify code path — the single place that ties
# together (a) the static parameters extracted from a net, (b) the
# PreppedNet fields stacked for the device, and (c) the batched match
# function.  _partition, build_crack_step and verify_step all read this
# table.  Each match fn: (pmk[8, B], static tuple, *stacked consts with a
# leading net axis N, *K3's derived constants) -> bool[N, V, B]; the
# derived constants (ops/verify_prep.derive) follow the fields in a CUDA
# part, built once per part by _part_consts.
_KINDS = {
    "pmkid": (
        lambda net: (),
        ("pmkid_block", "target"),
        lambda pmk, st, blk, tgt, *prep: m._pmkid_impl(pmk, blk, tgt, *prep)[:, None],
    ),
    "eapol": (
        lambda net: (net.keyver,),
        ("prf_blocks", "eapol_blocks", "target"),
        lambda pmk, st, prf, eap, tgt, *prep: m.eapol_match(pmk, prf, eap, tgt, *prep,
                                                            keyver=st[0]),
    ),
    "cmac": (
        lambda net: (bool(net.cmac_last_complete),),
        ("prf_blocks", "cmac_full", "cmac_last", "cmac_target"),
        lambda pmk, st, prf, full, last, tgt, *prep: m.eapol_cmac_match(
            pmk, prf, full, last, tgt, *prep, last_complete=st[0]
        ),
    ),
}


def _kind_of(net) -> str:
    if net.keyver == 100:
        return "pmkid"
    return "cmac" if net.keyver == 3 else "eapol"


def verify_step(kind, static):
    """``(pmk[8, B], mask[N], *stacked consts) -> (hits, found[N, V, B])``
    for the code path selected by ``kind``/``static``."""
    _, _, match = _KINDS[kind]

    def verify(pmk, mask, *consts):
        return _gate(match(pmk, static, *consts), mask)

    return verify


def _bucket(n: int) -> int:
    """Pad net counts to powers of two (a few stacked shapes per group size)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_nets(arrs):
    """Stack per-net tensors and pad the net axis to its bucket by
    repeating the last row.  Pad rows are dead weight whose hits
    ``_gate``'s mask excludes from both the count and the matrix."""
    stacked = torch.stack(arrs)
    pad = _bucket(len(arrs)) - len(arrs)
    if pad:
        stacked = torch.cat([stacked, stacked[-1:].expand(pad, *stacked.shape[1:])])
    return stacked


def _kernel_reads(consts):
    """Whether K3 verifies these constants (a CUDA part) and so reads its
    derived constants; the plain versions never do."""
    return consts[0].is_cuda


def _part_consts(kind, static, group):
    """One verify part's constants: the ``_KINDS`` fields of the nets in
    ``group`` stacked and bucket-padded, then, for the card, K3's derived
    constants built from them, once (``ops/verify_prep.derive``)."""
    consts = tuple(_pad_nets([getattr(g, f) for g in group]) for f in _KINDS[kind][1])
    return consts + derive(kind, static, consts) if _kernel_reads(consts) else consts


def _partition(nets):
    """Group net indices by verify signature (kind, static params,
    constant shapes)."""
    parts = {}
    for i, net in enumerate(nets):
        kind = _kind_of(net)
        statics, fields, _ = _KINDS[kind]
        sig = (kind, statics(net),
               tuple(tuple(getattr(net, f).shape) for f in fields))
        parts.setdefault(sig, []).append(i)
    return parts


def _assemble_step(struct, v_max, inv):
    """``(*found parts) -> found[N, v_max, B]``: slice off bucket padding,
    zero-pad variant axes, concatenate, restore input order (``inv`` is a
    device index tensor, or None when the parts are already in order)."""

    def assemble(*fnds):
        rows = []
        for fnd, (n, v) in zip(fnds, struct):
            fnd = fnd[:n]
            if v < v_max:
                fnd = torch.cat([fnd, fnd.new_zeros((n, v_max - v, fnd.shape[2]))], dim=1)
            rows.append(fnd)
        found = rows[0] if len(rows) == 1 else torch.cat(rows)
        return found if inv is None else torch.index_select(found, 0, inv)

    return assemble


class CrackStep:
    """``step(pw_words[B, W]) -> (hits, found[N, V_max, B], pmk[8, B])``.

    ``found`` is in the order of the nets the step was built over, with
    variant axes zero-padded so the per-net matrices stack.  The halves
    ``compute_pmk`` and ``verify`` are seams: ``step(pw)`` is
    ``self.verify(self.compute_pmk(pw))``, so replacing either on an
    instance reroutes the whole step.
    """

    def __init__(self, parts, asm, salt1, salt2):
        self.parts = parts  # [(verify fn, consts)]
        self.asm = asm
        self.salt1 = salt1
        self.salt2 = salt2

    def compute_pmk(self, pw_words):
        return pmk_step(pw_words, self.salt1, self.salt2)

    def verify(self, pmk):
        hits = None
        fnds = []
        for fn, consts in self.parts:
            h, fnd = fn(pmk, *consts)
            hits = h if hits is None else hits + h
            fnds.append(fnd)
        found = fnds[0] if self.asm is None else self.asm(*fnds)
        return hits, found, pmk

    def __call__(self, pw_words):
        return self.verify(self.compute_pmk(pw_words))


def mix_step(pmk_miss, cached, idx):
    """``(pmk_miss int32[8, Mb], cached int32[8, B], idx int32[B]) ->
    pmk int32[8, B]``: the PMK-store mixed-block assembly, a plain gather.

    ``pmk_miss`` is the PBKDF2 output of the compacted miss sub-batch,
    ``cached`` the host-built matrix with cache-hit PMKs at their batch
    columns, and ``idx`` the gather map over ``cat([pmk_miss, cached], 1)``
    (misses read their computed slot, hits and padding read ``cached`` at
    their own column — ``pmkstore.stage.split_block`` builds it).
    """
    return torch.cat((pmk_miss, cached), 1).index_select(1, idx)


#: Rules per fused rules dispatch (build_rules_step).  The engine plans,
#: accounts for and reports a base block's device rules chunk by chunk,
#: so the chunk size fixes the ``on_batch`` sequence and the resume
#: offsets; it equals the JAX package's so both streams count alike.
RULES_CHUNK = 8


def _pack_bits(any_b):
    """bool[B] -> int32[ceil(B/32)] with bit b of word b>>5 = column b (the
    uint32 words of the JAX step, carried as int32)."""
    pad = (-any_b.shape[0]) % 32
    if pad:
        any_b = torch.cat([any_b, any_b.new_zeros(pad)])
    weights = torch.ones(32, dtype=torch.int64, device=any_b.device) << torch.arange(
        32, dtype=torch.int64, device=any_b.device)
    words = (any_b.reshape(-1, 32).to(torch.int64) * weights).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def build_rules_step(nets, salt1, salt2, device):
    """The fused rules crack step for one ESSID group on ``device``.

    Returns ``step(base int32[B, 16], lens int32[B], steps int32[R, S, 3])
    -> (hits, bits)``: each of the R rules mangles the uploaded base batch
    on the device (``rules.device``), feeds PBKDF2 (``m._pmk_impl``: K1 on
    a CUDA batch) and every net's verify, and one int32 scalar ``hits``
    counts the chunk's matches — the host's only sync on an all-miss
    chunk.  ``bits`` int32[R, ceil(B/32)] is the bit-packed any-net
    match mask of each rule (bit b of word b>>5 = column b); the engine
    re-derives the net, NC delta and PMK of the rare hit columns with the
    host oracle.  ``steps`` is host data: the rule programs drive a Python
    loop of torch ops, so nothing is built per rule or per ESSID.
    """
    from ..rules.device import expand_bytes, repack, unpack

    parts = []
    for sig, idxs in _partition(nets).items():
        kind, static = sig[0], sig[1]
        group = [nets[i] for i in idxs]
        mask = torch.zeros(_bucket(len(group)), dtype=torch.bool, device=device)
        mask[: len(group)] = True
        parts.append((_KINDS[kind][2], static, mask, _part_consts(kind, static, group)))
    s1, s2 = to_torch(salt1, device), to_torch(salt2, device)

    def step(base, lens, steps):
        steps = np.asarray(steps)
        words = unpack(base)
        hits = torch.zeros((), dtype=torch.int32, device=base.device)
        bits = []
        for rsteps in steps:
            b, _, valid = expand_bytes(words, lens, rsteps)
            pmk = pmk_step(repack(b, valid), s1, s2)
            any_b = None
            for match, static, mask, consts in parts:
                fnd = match(pmk, static, *consts) & mask[:, None, None]
                hits = hits + fnd.sum(dtype=torch.int32)
                a = fnd.any(dim=1).any(dim=0)  # [B]
                any_b = a if any_b is None else any_b | a
            bits.append(_pack_bits(any_b))
        return hits, torch.stack(bits)

    return step


def build_crack_step(nets, salt1, salt2, device):
    """The crack step for one ESSID group on ``device``.

    ``nets``: list of PreppedNet sharing one ESSID (constants on
    ``device``); ``salt1``/``salt2``: the group's uint32[16] salt blocks.
    Everything the step needs is moved to the device here, once, so a
    batch enqueues device work without a host sync.
    """
    v_max = max(1 if n.keyver == 100 else len(n.variants) for n in nets)
    parts = []
    order = []   # original net index per concatenated found row
    struct = []  # (real net count, variant count) per part
    for sig, idxs in _partition(nets).items():
        kind, static = sig[0], sig[1]
        group = [nets[i] for i in idxs]
        mask = torch.zeros(_bucket(len(group)), dtype=torch.bool, device=device)
        mask[: len(group)] = True
        consts = (mask,) + _part_consts(kind, static, group)
        parts.append((verify_step(kind, static), consts))
        v = 1 if kind == "pmkid" else len(group[0].variants)
        struct.append((len(group), v))
        order.extend(idxs)
    inv = None
    if order != sorted(order):
        inv = torch.from_numpy(np.argsort(np.asarray(order))).to(device)
    # Fast path: one part, no bucket padding, full variant width, input
    # order — the verify output IS the final found matrix.
    trivial = (
        len(parts) == 1
        and struct[0] == (len(nets), v_max)
        and _bucket(len(nets)) == len(nets)
        and inv is None
    )
    asm = None if trivial else _assemble_step(tuple(struct), v_max, inv)
    return CrackStep(parts, asm, to_torch(salt1, device), to_torch(salt2, device))

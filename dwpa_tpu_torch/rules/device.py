"""On-device hashcat rule mangling, in torch (the GPU-rule-engine seat).

hashcat runs its rule engine on the accelerator: the host uploads the
base wordlist once and every rule's mangling happens on the device, so
candidate upload is divided by the rule count.  The host interpreter
(``rules/engine.py``) is the behavioural spec; this module runs the same
language over a batch of packed key rows, on the batch's device.  It is
the counterpart of ``dwpa_tpu/rules/device.py``, whose numpy half
(encoding, step buckets, the length simulation) is copied here as is.

Design — rules are data, not code:

- A rule is encoded as an int32[S, 3] array of (opcode, arg1, arg2)
  steps.  The step program is host data, so the interpreter is a Python
  loop over the steps with a list lookup per opcode, and every op takes
  its arguments as Python ints.  One set of torch ops serves every rule;
  nothing is built per rule.
- Words are held as one uint8 lane per byte (uint8[B, W], W=64), so every
  op is an elementwise map or a gather along the byte axis.  uint8
  arithmetic wraps mod 256, as the host's ``& 0xFF`` does.
- Semantics are bit-identical to rules/engine.py: same position
  conventions, same out-of-range no-ops, same reject filters (a rejected
  word's row is zeroed; the engine's oracle re-check keeps decode
  honest).  The single unsupported op is ``@`` (purge — data-dependent
  compaction); rules containing it fall back to host expansion.
- Length overflow: hashcat words may grow to 256 bytes mid-rule (host
  MAX_WORD); device lanes stop at W=64.  Growth is length-deterministic
  for every supported op, so the host pre-computes each rule's length
  trajectory (``simulate_lens``) and routes the rare overflowing
  (word, rule) pairs to host expansion; the device independently flags
  them (ok=False) so its output stays correct if a caller skips the
  simulation.
"""

import numpy as np
import torch

from .engine import _POS, MAX_WORD, Rule

#: Device lane width per word: intermediate rule results up to 64 bytes
#: stay on device; the final 8..63 PSK filter applies afterwards.  Growth
#: past it is length-deterministic, so the host routes those rare
#: (word, rule) pairs to its own interpreter (see simulate_lens).
W = 64

#: Final WPA PSK length bounds (models/m22000.py MIN/MAX_PSK_LEN).
_MIN_OUT, _MAX_OUT = 8, 63

# Op table order — _BRANCHES below and the encoder agree on these codes.
_OPS = [
    ":", "l", "u", "c", "C", "t", "T", "r", "d", "f", "{", "}", "[", "]",
    "D", "x", "O", "i", "o", "'", "$", "^", "s", "z", "Z", "q", "k", "K",
    "*", "L", "R", "+", "-", ".", ",", "y", "Y", "e", "E", "p",
    "<", ">", "_", "!", "/", "(", ")", "=", "%",
]
_OPCODE = {c: i for i, c in enumerate(_OPS)}

#: ops whose single arg is a position/count (0-9A-Z)
_POS1 = set("TD'zZLR+-.,yY<>_p")
#: ops whose single arg is a literal char
_CHR1 = set("$^!/()e")
#: (position, char) pairs
_POS_CHR = set("io=%")
#: (position, position) pairs
_POS_POS = set("xO*")
#: (char, char) pairs
_CHR_CHR = set("s")


def device_supported(rule: Rule) -> bool:
    """True when every step of ``rule`` runs on device (everything in
    the fast-kernel op set except ``@``)."""
    return all(op in _OPCODE for op, _ in rule.steps)


def encode_rule(rule: Rule) -> np.ndarray:
    """Rule -> int32[S, 3] (opcode, arg1, arg2) step array (device data)."""
    rows = []
    for op, args in rule.steps:
        a1 = a2 = 0
        if op in _POS1:
            a1 = _POS[args[0]]
        elif op in _CHR1:
            a1 = args.encode("latin1")[0]
        elif op == "E":
            a1 = 0x20  # title-case with the fixed space separator
        elif op in _POS_CHR:
            a1 = _POS[args[0]]
            a2 = args[1].encode("latin1")[0]
        elif op in _POS_POS:
            a1, a2 = _POS[args[0]], _POS[args[1]]
        elif op in _CHR_CHR:
            enc = args.encode("latin1")
            a1, a2 = enc[0], enc[1]
        rows.append((_OPCODE[op], a1, a2))
    if not rows:
        rows.append((0, 0, 0))  # ":" — empty rule is the noop
    return np.asarray(rows, dtype=np.int32)


def step_bucket(n: int) -> int:
    """Pad step counts to powers of two (pad steps are ':' noops), as the
    JAX package does so its interpreter's compile cache hits across rules
    of nearby length; here it only fixes the stacked shape."""
    b = 1
    while b < n:
        b *= 2
    return b


def simulate_lens(rule: Rule, lens: np.ndarray):
    """Length trajectory of ``rule`` over a batch's length vector.

    Returns ``(out_lens, hostneed)``: final lengths (int64) and a bool
    mask of columns whose INTERMEDIATE length ever exceeded the device
    lane width W — those (word, rule) pairs must be host-expanded (the
    host's 256-byte MAX_WORD allows shrink-back the device cannot
    represent).  Pure numpy; every supported op's length effect is
    content-independent, which is what makes this exact.
    """
    L = lens.astype(np.int64)
    hostneed = np.zeros(L.shape, dtype=bool)
    for op, args in rule.steps:
        if op in ("d", "f", "q"):
            L2 = 2 * L
        elif op == "p":
            L2 = (1 + _POS[args[0]]) * L
        elif op in ("z", "Z"):
            L2 = np.where(L > 0, L + _POS[args[0]], L)
        elif op in ("y", "Y"):
            n = _POS[args[0]]
            L2 = np.where(n <= L, L + n, L)
        elif op == "i":
            L2 = np.where(_POS[args[0]] <= L, L + 1, L)
        elif op == "x":
            p, m = _POS[args[0]], _POS[args[1]]
            L2 = np.where(p + m <= L, m, L)
        elif op == "O":
            p, m = _POS[args[0]], _POS[args[1]]
            L2 = np.where(p + m <= L, L - m, L)
        elif op == "D":
            L2 = np.where(_POS[args[0]] < L, L - 1, L)
        elif op in ("[", "]"):
            L2 = np.maximum(L - 1, 0)
        elif op == "'":
            L2 = np.minimum(L, _POS[args[0]])
        elif op in ("$", "^"):
            L2 = L + 1
        else:
            L2 = L
        hostneed |= L2 > W
        L = np.where(L2 > MAX_WORD, 0, L2)  # host rejects >256 outright
    return L, hostneed


def stack_rules(steps_list, n_rules: int) -> np.ndarray:
    """Pad a chunk of encoded rules to one int32[n_rules, S, 3] stack.

    S = the chunk's max step bucket; missing steps and missing rules
    pad with ':' noops (the interpreter skips noop steps).
    """
    S = step_bucket(max(s.shape[0] for s in steps_list))
    stack = np.zeros((n_rules, S, 3), dtype=np.int32)
    for r, s in enumerate(steps_list):
        stack[r, : s.shape[0]] = s
    return stack


# ---------------------------------------------------------------------------
# The interpreter (torch)
# ---------------------------------------------------------------------------
#
# Every op maps (b uint8[B, W], L int32[B], ok bool[B], a1, a2) ->
# (b, L, ok) with ``a1``/``a2`` Python ints, and never writes its inputs in
# place.  ``iota`` is the [1, W] byte-position row.  Gather indices are
# built once per step, as a [1, W] row (a column selection) or a [B, W]
# map, and clipped to the lanes, as ``jnp.take_along_axis`` over a clipped
# index does in the JAX interpreter.


def _isup(b):
    return (b >= 65) & (b <= 90)


def _islo(b):
    return (b >= 97) & (b <= 122)


def _tog(b):
    return torch.where(_islo(b), b - 32, torch.where(_isup(b), b + 32, b))


def _low(b):
    return torch.where(_isup(b), b + 32, b)


def _up(b):
    return torch.where(_islo(b), b - 32, b)


def _c8(b, v):
    """Byte constant ``v`` as a 0-dim uint8 tensor beside ``b``."""
    return torch.full((), v & 0xFF, dtype=torch.uint8, device=b.device)


def _gather(b, idx):
    """``b[row, clip(idx)]``: a [1, W] index selects the same columns of
    every row, a [B, W] index is a per-row gather."""
    idx = idx.clamp(0, W - 1).long()
    if idx.shape[0] == 1:
        return b.index_select(1, idx[0])
    return torch.gather(b, 1, idx)


def _grow(b, L, ok, newL):
    """Apply a length increase; overflowing rows die (ok=False, len 0 —
    simulate_lens routes them to host expansion)."""
    over = newL > W
    return b, torch.where(over, 0, newL), ok & ~over


def _cond(c, newb, newL, b, L):
    """Per-row conditional op: c bool[B]."""
    return torch.where(c[:, None], newb, b), torch.where(c, newL, L)


def _cond_grow(c, out, newL, b, L, ok):
    """A conditional length increase whose overflowing rows die."""
    over = newL > W
    nb, nL = _cond(c & ~over, out, newL, b, L)
    return nb, torch.where(over, 0, nL), ok & ~over


def _iota(b):
    return torch.arange(W, dtype=torch.int32, device=b.device)[None, :]


def _noop(b, L, ok, a1, a2):
    return b, L, ok


def _f_l(b, L, ok, a1, a2):
    return _low(b), L, ok


def _f_u(b, L, ok, a1, a2):
    return _up(b), L, ok


def _f_c(b, L, ok, a1, a2):
    return torch.where(_iota(b) == 0, _up(b), _low(b)), L, ok


def _f_C(b, L, ok, a1, a2):
    return torch.where(_iota(b) == 0, _low(b), _up(b)), L, ok


def _f_t(b, L, ok, a1, a2):
    return _tog(b), L, ok


def _f_T(b, L, ok, a1, a2):
    return torch.where(_iota(b) == a1, _tog(b), b), L, ok


def _f_r(b, L, ok, a1, a2):
    return _gather(b, L[:, None] - 1 - _iota(b)), L, ok


def _f_d(b, L, ok, a1, a2):
    iota, Lc = _iota(b), L[:, None]
    out = _gather(b, torch.where(iota < Lc, iota, iota - Lc))
    return _grow(out, L, ok, 2 * L)


def _f_f(b, L, ok, a1, a2):
    iota, Lc = _iota(b), L[:, None]
    out = _gather(b, torch.where(iota < Lc, iota, 2 * Lc - 1 - iota))
    return _grow(out, L, ok, 2 * L)


def _f_rotl(b, L, ok, a1, a2):
    Ls = torch.clamp(L, min=1)[:, None]
    return _gather(b, (_iota(b) + 1) % Ls), L, ok


def _f_rotr(b, L, ok, a1, a2):
    Ls = torch.clamp(L, min=1)[:, None]
    return _gather(b, (_iota(b) + Ls - 1) % Ls), L, ok


def _f_delfirst(b, L, ok, a1, a2):
    return _gather(b, _iota(b) + 1), torch.clamp(L - 1, min=0), ok


def _f_dellast(b, L, ok, a1, a2):
    return b, torch.clamp(L - 1, min=0), ok


def _f_D(b, L, ok, a1, a2):
    iota = _iota(b)
    out = _gather(b, torch.where(iota < a1, iota, iota + 1))
    nb, nL = _cond(a1 < L, out, L - 1, b, L)
    return nb, nL, ok


def _f_x(b, L, ok, a1, a2):
    out = _gather(b, _iota(b) + a1)
    nb, nL = _cond(a1 + a2 <= L, out, torch.full_like(L, a2), b, L)
    return nb, nL, ok


def _f_O(b, L, ok, a1, a2):
    iota = _iota(b)
    out = _gather(b, torch.where(iota < a1, iota, iota + a2))
    nb, nL = _cond(a1 + a2 <= L, out, L - a2, b, L)
    return nb, nL, ok


def _f_i(b, L, ok, a1, a2):
    iota = _iota(b)
    ins = torch.where(iota == a1, _c8(b, a2), _gather(b, iota - 1))
    out = torch.where(iota < a1, b, ins)
    return _cond_grow(a1 <= L, out, L + 1, b, L, ok)


def _f_o(b, L, ok, a1, a2):
    hit = (_iota(b) == a1) & (a1 < L[:, None])
    return torch.where(hit, _c8(b, a2), b), L, ok


def _f_trunc(b, L, ok, a1, a2):
    return b, torch.clamp(L, max=a1), ok


def _f_append(b, L, ok, a1, a2):
    out = torch.where(_iota(b) == L[:, None], _c8(b, a1), b)
    return _grow(out, L, ok, L + 1)


def _f_prepend(b, L, ok, a1, a2):
    iota = _iota(b)
    out = torch.where(iota == 0, _c8(b, a1), _gather(b, iota - 1))
    return _grow(out, L, ok, L + 1)


def _f_sub(b, L, ok, a1, a2):
    hit = (b == a1) & (_iota(b) < L[:, None])
    return torch.where(hit, _c8(b, a2), b), L, ok


def _f_z(b, L, ok, a1, a2):
    iota = _iota(b)
    out = _gather(b, torch.where(iota < a1, 0, iota - a1))
    c = L > 0
    return _cond_grow(c, out, torch.where(c, L + a1, L), b, L, ok)


def _f_Z(b, L, ok, a1, a2):
    out = _gather(b, torch.minimum(_iota(b), L[:, None] - 1))
    c = L > 0
    return _cond_grow(c, out, torch.where(c, L + a1, L), b, L, ok)


def _f_q(b, L, ok, a1, a2):
    return _grow(_gather(b, _iota(b) // 2), L, ok, 2 * L)


def _f_k(b, L, ok, a1, a2):
    iota = _iota(b)
    idx = torch.where(iota == 0, 1, torch.where(iota == 1, 0, iota))
    nb, nL = _cond(L >= 2, _gather(b, idx), L, b, L)
    return nb, nL, ok


def _f_K(b, L, ok, a1, a2):
    iota = _iota(b)
    p, m = (L - 2)[:, None], (L - 1)[:, None]
    idx = torch.where(iota == p, m, torch.where(iota == m, p, iota))
    nb, nL = _cond(L >= 2, _gather(b, idx), L, b, L)
    return nb, nL, ok


def _f_swap(b, L, ok, a1, a2):
    iota = _iota(b)
    idx = torch.where(iota == a1, a2, torch.where(iota == a2, a1, iota))
    nb, nL = _cond((a1 < L) & (a2 < L), _gather(b, idx), L, b, L)
    return nb, nL, ok


def _at(b, L, a1, fn):
    hit = (_iota(b) == a1) & (a1 < L[:, None])
    return torch.where(hit, fn(b), b)  # uint8 lanes wrap mod 256


def _f_shl(b, L, ok, a1, a2):
    return _at(b, L, a1, lambda x: x << 1), L, ok


def _f_shr(b, L, ok, a1, a2):
    return _at(b, L, a1, lambda x: x >> 1), L, ok


def _f_incr(b, L, ok, a1, a2):
    return _at(b, L, a1, lambda x: x + 1), L, ok


def _f_decr(b, L, ok, a1, a2):
    return _at(b, L, a1, lambda x: x + 255), L, ok


def _f_repl_next(b, L, ok, a1, a2):
    iota = _iota(b)
    hit = (iota == a1) & (a1 + 1 < L[:, None])
    return torch.where(hit, _gather(b, iota + 1), b), L, ok


def _f_repl_prior(b, L, ok, a1, a2):
    iota = _iota(b)
    hit = (iota == a1) & (a1 > 0) & (a1 < L[:, None])
    return torch.where(hit, _gather(b, iota - 1), b), L, ok


def _f_y(b, L, ok, a1, a2):
    iota = _iota(b)
    out = _gather(b, torch.where(iota < a1, iota, iota - a1))
    c = a1 <= L
    return _cond_grow(c, out, torch.where(c, L + a1, L), b, L, ok)


def _f_Y(b, L, ok, a1, a2):
    iota = _iota(b)
    out = _gather(b, torch.where(iota < L[:, None], iota, iota - a1))
    c = a1 <= L
    return _cond_grow(c, out, torch.where(c, L + a1, L), b, L, ok)


def _f_title(b, L, ok, a1, a2):
    iota = _iota(b)
    lo = _low(b)
    upmask = (iota == 0) | (_gather(lo, iota - 1) == a1)
    return torch.where(upmask & _islo(lo), lo - 32, lo), L, ok


def _f_p(b, L, ok, a1, a2):
    Ls = torch.clamp(L, min=1)[:, None]
    return _grow(_gather(b, _iota(b) % Ls), L, ok, (1 + a1) * L)


def _f_rej_less(b, L, ok, a1, a2):
    return b, L, ok & (L < a1)


def _f_rej_greater(b, L, ok, a1, a2):
    return b, L, ok & (L > a1)


def _f_rej_eq(b, L, ok, a1, a2):
    return b, L, ok & (L == a1)


def _contains(b, L, x):
    return ((b == x) & (_iota(b) < L[:, None])).any(dim=1)


def _f_rej_contain(b, L, ok, a1, a2):
    return b, L, ok & ~_contains(b, L, a1)


def _f_rej_not_contain(b, L, ok, a1, a2):
    return b, L, ok & _contains(b, L, a1)


def _f_rej_first(b, L, ok, a1, a2):
    return b, L, ok & (L > 0) & (b[:, 0] == a1)


def _f_rej_last(b, L, ok, a1, a2):
    last = torch.gather(b, 1, torch.clamp(L - 1, min=0).long()[:, None])[:, 0]
    return b, L, ok & (L > 0) & (last == a1)


def _f_rej_at(b, L, ok, a1, a2):
    at = b[:, min(max(a1, 0), W - 1)]
    return b, L, ok & (a1 < L) & (at == a2)


def _f_rej_count(b, L, ok, a1, a2):
    cnt = ((b == a2) & (_iota(b) < L[:, None])).sum(dim=1)
    return b, L, ok & (cnt >= a1)


#: op functions, indexed by opcode (``_OPS`` order)
_BRANCHES = [
    _noop, _f_l, _f_u, _f_c, _f_C, _f_t, _f_T, _f_r, _f_d, _f_f, _f_rotl,
    _f_rotr, _f_delfirst, _f_dellast, _f_D, _f_x, _f_O, _f_i, _f_o,
    _f_trunc, _f_append, _f_prepend, _f_sub, _f_z, _f_Z, _f_q, _f_k, _f_K,
    _f_swap, _f_shl, _f_shr, _f_incr, _f_decr, _f_repl_next,
    _f_repl_prior, _f_y, _f_Y, _f_title, _f_title, _f_p,
    _f_rej_less, _f_rej_greater, _f_rej_eq, _f_rej_contain,
    _f_rej_not_contain, _f_rej_first, _f_rej_last, _f_rej_at,
    _f_rej_count,
]
assert len(_BRANCHES) == len(_OPS)

_SHIFTS = (24, 16, 8, 0)


def unpack(packed) -> torch.Tensor:
    """Packed big-endian key rows int32[B, 16] -> bytes uint8[B, W]."""
    B = packed.shape[0]
    parts = [(packed >> s) & 0xFF for s in _SHIFTS]  # arithmetic >>, masked
    return torch.stack(parts, dim=2).reshape(B, W).to(torch.uint8)


def expand_bytes(b, lens, steps):
    """Run one rule's step program over unpacked words.

    ``b`` uint8[B, W], ``lens`` int[B], ``steps`` host int32[S, 3] ->
    (bytes uint8[B, W], lengths int32[B], valid bool[B]) with the byte
    lanes past each length zeroed; ``valid`` is "not rejected, no
    overflow, and 8..63 bytes long".
    """
    iota = _iota(b)
    L = lens.to(device=b.device, dtype=torch.int32)
    ok = torch.ones(L.shape, dtype=torch.bool, device=b.device)
    # Invariant: byte lanes beyond the word length stay zero, so gathers
    # in later steps never leak stale bytes.  Every op reads only lanes
    # below the incoming length into lanes below the outgoing one, so
    # masking once up front and after each op equals the JAX scan's mask
    # after every step — and a ':' step (every pad step) is a no-op.
    b = torch.where(iota < L[:, None], b, 0)
    for op, a1, a2 in np.asarray(steps, dtype=np.int64).reshape(-1, 3).tolist():
        op = min(max(op, 0), len(_BRANCHES) - 1)
        if op == 0:
            continue
        b, L, ok = _BRANCHES[op](b, L, ok, a1, a2)
        b = torch.where(iota < L[:, None], b, 0)
    return b, L, ok & (L >= _MIN_OUT) & (L <= _MAX_OUT)


def repack(b, valid) -> torch.Tensor:
    """bytes uint8[B, W] -> big-endian key rows int32[B, 16], with the rows
    where ``valid`` is False zeroed."""
    B = b.shape[0]
    w = b.reshape(B, 16, 4).to(torch.int32)
    out = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]
    return torch.where(valid[:, None], out, 0)


def expand(packed, lens, steps) -> torch.Tensor:
    """One rule over one packed batch, on the batch's device.

    ``(packed int32[B, 16], lens int32[B], steps int32[S, 3]) ->
    int32[B, 16]`` with rejected/out-of-range rows zeroed (a zero key
    block cannot decode to a valid PSK; the engine's oracle re-check makes
    false hits impossible to report).  ``steps`` is host data (numpy or a
    nested list); a CUDA batch expands with CUDA torch ops.
    """
    b, _, valid = expand_bytes(unpack(packed), lens, steps)
    return repack(b, valid)


def expand_batch(packed_dev, lens_dev, steps: np.ndarray):
    """``expand`` with ``steps`` padded to its power-of-two bucket with ':'
    noops — the JAX package's signature, kept so both packages take the
    same step arrays."""
    S = step_bucket(steps.shape[0])
    if S != steps.shape[0]:
        pad = np.zeros((S - steps.shape[0], 3), dtype=np.int32)
        steps = np.concatenate([steps, pad])
    return expand(packed_dev, lens_dev, steps)


def apply_rule_device(words, rule: Rule, device=None):
    """Differential-test helper: run one rule over host words on device.

    Returns a list aligned with ``words``: the mangled bytes where the
    device produced a valid candidate (8..63, not rejected), else None.
    The host interpreter (rule.apply + the PSK length filter) is the
    reference this must match exactly.  ``device``: default ``cuda:0``.
    """
    from ..ops.common import to_numpy, to_torch
    from ..parallel.device import resolve_device
    from ..utils import bytesops as bo

    dev = resolve_device(device)
    words = list(words)
    packed = bo.pack_passwords_be(words)
    lens = np.asarray([len(w) for w in words], np.int32)
    out = to_numpy(expand_batch(to_torch(packed, dev),
                                torch.from_numpy(lens).to(dev),
                                encode_rule(rule)))
    out_lens, hostneed = simulate_lens(rule, lens)
    res = []
    for i in range(len(words)):
        if hostneed[i] or not out[i].any():
            res.append(None)
        else:
            res.append(bo.words_to_bytes_be(out[i])[: int(out_lens[i])])
    return res

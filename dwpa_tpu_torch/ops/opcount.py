"""Census of the elementwise integer ops of the port's crypto functions.

The PMK/s ceiling of the SM probe (``ops/sm_probe.py``) divides a
measured op rate by the exact number of 32-bit ops one PMK needs.  This
module counts them: it runs the port's own functions on ``meta`` tensors
(shapes and types only, no data, no device work) under a
``TorchFunctionMode`` that records every operator call, named as the JAX
package's census names them (``dwpa_tpu/ops/opcount.py``):

    element_ops / PMK = 2 blocks (T1, T2) x 4095 iterations x ops per iteration

The port carries words as int32, so a logical right shift is an
arithmetic one plus an ``and`` that masks off the sign fill
(``common.shr32``).  Those masks are counted apart, as ``sign_masks``;
``alu_ops`` and ``by_prim`` count the logical uint32 ops and so equal the
JAX census.

Run: ``python -m dwpa_tpu_torch.ops.opcount`` (one JSON line; no device
needed).
"""

from collections import Counter

import torch
from torch.overrides import TorchFunctionMode

# The operators of the port's word helpers -> the JAX primitive each is.
_PRIMS = {
    torch.Tensor.__add__: "add", torch.Tensor.__radd__: "add",
    torch.Tensor.__xor__: "xor", torch.Tensor.__rxor__: "xor",
    torch.Tensor.__and__: "and", torch.Tensor.__rand__: "and",
    torch.Tensor.__or__: "or", torch.Tensor.__ror__: "or",
    torch.Tensor.__lshift__: "shift_left",
    torch.Tensor.__rshift__: "shift_right_logical",
}
# Primitives that are one ALU op per element (the JAX census's set).
ALU_PRIMS = {"add", "sub", "mul", "xor", "and", "or", "not", "shift_left",
             "shift_right_logical", "shift_right_arithmetic"}
SIGN_MASK = "sign_mask"


class _Counting(TorchFunctionMode):
    """Counts operator calls by primitive name (any other call under its
    own name, as ``other_ops``).  An ``and`` of a right shift's result
    with an int is the sign-fill mask of ``shr32``."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()
        self._shifted = []  # right-shift results, kept alive so ids stay unique

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        prim = _PRIMS.get(func, getattr(func, "__name__", str(func)))
        if prim == "and" and isinstance(args[1], int) and any(
                args[0] is t for t in self._shifted):
            prim = SIGN_MASK
        if prim == "shift_right_logical":
            self._shifted.append(out)
        self.counts[prim] += 1
        return out


def census(fn, *args):
    """Run ``fn(*args)`` and return a Counter of the operator calls it
    made, by JAX primitive name (sign-fill masks under ``sign_mask``)."""
    with _Counting() as mode:
        fn(*args)
    return mode.counts


def summarize(counts):
    """The JAX census's summary keys, plus ``sign_masks``."""
    logical = {p: n for p, n in counts.items() if p != SIGN_MASK}
    alu = sum(n for p, n in logical.items() if p in ALU_PRIMS)
    return {
        "alu_ops": alu,
        "free_ops": 0,  # the port's words need no dtype or shape plumbing
        "other_ops": sum(logical.values()) - alu,
        "by_prim": dict(sorted(logical.items(), key=lambda kv: -kv[1])),
        "sign_masks": counts.get(SIGN_MASK, 0),
    }


def _words(n):
    return tuple(torch.zeros((1,), dtype=torch.int32, device="meta") for _ in range(n))


def pbkdf2_iteration_census(hoisted=True):
    """Op census of one PBKDF2 loop iteration for one output block: one
    HMAC-SHA1 of a 20-byte message plus the 5 accumulator xors."""
    from . import hmac as hm

    st5 = _words(5)
    if hoisted:
        pro = hm.hmac_sha1_20_prologue(st5, st5)

        def body(u, acc):
            nu = hm.hmac_sha1_20_hoisted(pro, u)
            return tuple(nu) + tuple(a ^ x for a, x in zip(acc, nu))
    else:

        def body(u, acc):
            nu = hm.hmac_sha1_20(st5, st5, u)
            return tuple(nu) + tuple(a ^ x for a, x in zip(acc, nu))

    return summarize(census(body, st5, st5))


def sha1_compress_census():
    """Op census of one generic SHA-1 compression (all 16 words tensors)."""
    from .sha1 import sha1_compress

    return summarize(census(sha1_compress, _words(5), list(_words(16))))


def element_ops_per_pmk(it):
    """Logical ops of one PMK from an iteration census: 2 output blocks x
    4095 loop iterations (the 6-compression prologue, under 0.1%, is left
    out, as the JAX census leaves it out)."""
    return 2 * 4095 * it["alu_ops"]


def main():
    import json

    it_plain = pbkdf2_iteration_census(hoisted=False)
    it_hoist = pbkdf2_iteration_census(hoisted=True)
    print(json.dumps({
        "sha1_compress_generic": sha1_compress_census(),
        "pbkdf2_iter_plain": it_plain,
        "pbkdf2_iter_hoisted": it_hoist,
        "element_ops_per_pmk_plain": element_ops_per_pmk(it_plain),
        "element_ops_per_pmk_hoisted": element_ops_per_pmk(it_hoist),
    }))


if __name__ == "__main__":
    main()

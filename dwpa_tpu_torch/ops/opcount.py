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

The same census, weighed by the elements each call computes, counts
the work of the crack step's verify (:func:`verify_census`), the
operations side of the K3 kernels' bound in ``chip_smoke.py``.

Run: ``python -m dwpa_tpu_torch.ops.opcount`` (one JSON line; no device
needed).
"""

import functools
from collections import Counter
from unittest import mock

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


class _Graph(TorchFunctionMode):
    """Records the 32-bit ops of a run as a graph of nodes, one per call,
    each ``[class, operands, elements, output]``, for
    :func:`_instructions`.  A logical right shift (``shr32``: a shift and
    its sign mask) is one ``shift`` node, a rotate (``common.rotl32``,
    ``rotr32``: the ``or`` of a word shifted left and the same word
    shifted right) one ``rotate`` node, the card's funnel shift.  Tensors
    marked by :meth:`constant` (a net's constants), and every result of
    a call whose tensor operands are all constant, are constants: the
    same for every column."""

    def __init__(self):
        super().__init__()
        self.nodes = []
        self.node_of = {}  # id(output) -> node index
        self.uses = Counter()  # id(tensor) -> calls that read it
        self.model = Counter()  # work counted by a model, not by nodes
        self.consts = {}  # id(tensor) -> the constant tensor
        self._read = []  # every tensor read, kept alive so ids stay unique

    def constant(self, *tensors):
        for t in tensors:
            self.consts[id(t)] = t

    def is_constant(self, x):
        return isinstance(x, int) or self.consts.get(id(x)) is x

    def _use(self, a):
        if isinstance(a, torch.Tensor):
            self.uses[id(a)] += 1
            self._read.append(a)
        elif isinstance(a, (list, tuple)):
            for x in a:
                self._use(x)

    def _node(self, x):
        i = self.node_of.get(id(x)) if isinstance(x, torch.Tensor) else None
        return None if i is None or self.nodes[i][3] is not x else self.nodes[i]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._use(args)
        self._use(list((kwargs or {}).values()))
        ins = [x for x in _flat(list(args) + list((kwargs or {}).values()))
               if isinstance(x, torch.Tensor)]
        if ins and all(self.is_constant(x) for x in ins):
            self.constant(*(x for x in _flat([out]) if isinstance(x, torch.Tensor)))
        prim = _PRIMS.get(func) or _VERIFY_PRIMS.get(func)
        if prim is None or not isinstance(out, torch.Tensor):
            return out
        cls, ops = _CLASS[prim], list(args)
        if prim == "and" and isinstance(args[1], int):
            src = self._node(args[0])
            if src is not None and src[0] == "shr":
                src[0], cls, ops = None, "shift", src[1]  # shr32: one logical shift
        elif prim == "or":
            a, b = (self._node(x) for x in args[:2])
            if a and b and {a[0], b[0]} == {"shl", "shift"} and a[1][0] is b[1][0]:
                a[0] = b[0] = None  # both shifts fold into the rotate
                cls, ops = "rotate", a[1]
        self.node_of[id(out)] = len(self.nodes)
        self.nodes.append([cls, ops, out.numel(), out])
        return out


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


# The classes of op the card issues as one instruction each: a logic op
# of up to 3 inputs (LOP3), an add of up to 3 (IADD3), a shift, a rotate
# (a funnel shift), a comparison.  ``shl`` and ``shr`` are shifts until
# they prove to be half of a rotate or a logical shift.
_CLASS = {"and": "logic", "or": "logic", "xor": "logic", "not": "logic", "add": "add",
          "shift_left": "shl", "shift_right_logical": "shr", "eq": "eq"}
# Beside ``_PRIMS``: a tensor sum reaches the mode as ``Tensor.add``.
_VERIFY_PRIMS = {torch.Tensor.add: "add", torch.Tensor.__eq__: "eq",
                 torch.Tensor.__invert__: "not"}
# A rotate or a logical shift that one add reads folds into it (LEA.HI
# or LEA: a funnel shift of one word plus a second word).
_SHIFTS = ("rotate", "shift", "shl")


def _own(graph, x, cls):
    """The index of the node of class ``cls`` that made ``x`` and that
    nothing else reads, or None."""
    j = graph.node_of.get(id(x)) if isinstance(x, torch.Tensor) else None
    ok = j is not None and graph.nodes[j][0] == cls and graph.nodes[j][3] is x
    return j if ok and graph.uses[id(x)] == 1 else None


def _instructions(graph):
    """Instructions by class, each node weighed by its elements.  A logic
    node absorbs an operand logic node that nothing else reads while the
    fused op keeps at most 3 inputs (each immediate one input).  An add
    node absorbs every operand add node that nothing else reads: a sum of
    ``k`` terms, the constants among them one term (their sum is the
    net's, or an immediate), is ``ceil((k - 1) / 2)`` 3-input adds; a
    term that a rotate or shift only this sum reads makes, with one other
    term, one instruction (LEA.HI), and the rotate goes.  -> Counter."""
    leaves, terms = {}, {}
    nodes = graph.nodes
    for i, (cls, ops, n, _) in enumerate(nodes):
        if cls == "add":
            terms[i] = []
            for x in ops:
                j = _own(graph, x, "add")
                if j is None:
                    terms[i].append(x)
                else:
                    nodes[j][0] = None
                    terms[i].extend(terms.pop(j))
            continue
        if cls != "logic":
            continue
        own = [_own(graph, x, cls) for x in ops]
        best = None
        for mask in range(1 << len(ops)):
            if any(mask >> k & 1 and own[k] is None for k in range(len(ops))):
                continue
            got = set()
            for k, x in enumerate(ops):
                got |= leaves[own[k]] if mask >> k & 1 else {id(x) if isinstance(
                    x, torch.Tensor) else ("imm", i, k)}
            if len(got) <= 3 and (best is None or bin(mask).count("1") > best[0]):
                best = (bin(mask).count("1"), mask, got)
        _, mask, leaves[i] = best
        for k in range(len(ops)):
            if mask >> k & 1:
                nodes[own[k]][0] = None
    adds = Counter()
    for i, ts in terms.items():
        if nodes[i][0] is None:
            continue
        var = sum(not graph.is_constant(x) for x in ts)
        k = var + (len(ts) > var) if var else len(ts)  # a net's own sum: its terms
        folds = [j for j in (_own(graph, x, c) for x in ts if not graph.is_constant(x)
                             for c in _SHIFTS)
                 if j is not None and nodes[j][3].shape == nodes[i][3].shape][:max(k - 1, 0)]
        for j in folds:
            nodes[j][0] = None
        adds[i] = len(folds) + -(-(k - 1 - len(folds)) // 2)
    out = Counter()
    for i, (cls, _, n, _) in enumerate(nodes):
        if cls is not None:
            out["shift" if cls in ("shl", "shr") else cls] += n * adds.get(i, 1)
    return out


# AES-128 on four 32-bit column words with T-tables, at its least, in
# the instructions above: a round is 16 byte extracts, 16 table loads
# and 8 three-input xors (each column's 4 lookups and its round-key
# word); the last round 16 extracts, 16 S-box loads, 12 byte inserts and
# 4 xors.  The first AddRoundKey (4 xors) takes the CMAC chain's xor
# with it.  A round key is one SubWord(RotWord) (4 extracts, 4 loads, 3
# inserts) and 4 xors, the rcon folded into the first; CMAC's doubling 4
# funnel shifts and 3 ops for the 0x87 reduction.
AES_BLOCK = {"aes_alu": 4 + 9 * 24 + 32, "aes_loads": 10 * 16}
AES_KEY_SCHEDULE = {"aes_alu": 10 * 11, "aes_loads": 10 * 4}
CMAC_DBL_ALU = 7


def cmac_model(blocks, last_complete):
    """T-table AES-128-CMAC work for one key: the key schedule, the
    subkey L = AES(0) and its doubling (twice for a padded last block),
    and ``blocks`` chained blocks, the last with 4 xors more for the
    subkey.  -> {"aes_alu": n, "aes_loads": n}."""
    out = {k: AES_KEY_SCHEDULE[k] + (1 + blocks) * AES_BLOCK[k] for k in AES_BLOCK}
    out["aes_alu"] += CMAC_DBL_ALU * (1 if last_complete else 2) + 4
    return out


def _operands(kind, n, v, rows, b):
    """Zero CPU tensors in the shapes of a verify part's operands (a few
    columns: small, and far quicker to run than meta tensors): ``pmk``
    int32[8, b] and the constants of ``n`` nets with ``v`` variants and
    ``rows`` EAPOL (or full CMAC) blocks."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    pmk = z(8, b)
    if kind == "pmkid":
        return pmk, (z(n, 16), z(n, 4))
    if kind == "eapol":
        return pmk, (z(n, v, 2, 16), z(n, rows, 16), z(n, 4))
    return pmk, (z(n, v, 2, 16), z(n, rows, 16), z(n, 16), z(n, 16))


@functools.lru_cache(maxsize=None)
def _block0_per_row(kind):
    """Per column, the instructions of one PRF block-0 compression that
    grow with its rows (the variants it is repeated for): the bilinear
    term of the compression's census at 1 and 2 columns and 1 and 2 rows
    of constant words, as the plain version computes it.  The rest
    (rounds that read only the column's pad state) is shared already.
    -> {class: instructions}."""
    from .sha1 import sha1_compress
    from .sha256 import sha256_compress

    compress, width = (sha256_compress, 8) if kind == "cmac" else (sha1_compress, 5)

    def count(c, r):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32)

        state, block = [z(c) for _ in range(width)], [z(r, 1) for _ in range(16)]
        with _Graph() as graph:
            graph.constant(*block)
            compress(state, block)
        return _instructions(graph)

    cs = {(c, r): count(c, r) for c in (1, 2) for r in (1, 2)}
    classes = set().union(*cs.values())
    out = {k: cs[2, 2][k] - cs[1, 2][k] - cs[2, 1][k] + cs[1, 1][k] for k in classes}
    return {k: x for k, x in out.items() if x}


def _verify_counts(kind, static, n, v, rows, b, block0=None):
    from . import verify as vf

    pmk, consts = _operands(kind, n, v, rows, b)
    calls = vf.CALLS
    with _Graph() as graph:
        graph.constant(*consts)
        if kind == "pmkid":
            vf.pmkid_plain(pmk, *consts)
        elif kind == "eapol":
            vf.eapol_match_plain(pmk, *consts, keyver=static[0])
        else:
            def aes_cmac(key16, full, last, last_complete):
                for k, c in cmac_model(full.shape[0] + 1, last_complete).items():
                    graph.model[k] += key16.numel() // 16 * c
                return torch.zeros_like(key16)

            with mock.patch.object(vf, "aes128_cmac", aes_cmac):
                vf.eapol_cmac_match_plain(pmk, *consts, last_complete=static[0])
    vf.CALLS = calls  # a census, not a verify
    counts = _instructions(graph) + graph.model
    if kind != "pmkid":
        # The plain version compresses PRF block 0 once per variant; the
        # function needs it once per distinct block.
        distinct = n if kind == "cmac" else (n * v if block0 is None else block0)
        for k, x in _block0_per_row(kind).items():
            counts[k] -= (n * v - distinct) * b * x
    return counts


def verify_census(kind, static, n, v, rows, b, block0=None):
    """The instructions one verify part needs (``kind`` and ``static`` as
    in ``parallel/step._KINDS``; ``n`` nets, ``v`` variants, ``rows``
    EAPOL or full CMAC blocks) on ``b`` PMK columns, from its plain
    version in ``ops/verify.py`` run on 1 and 2 columns: every element of
    every 32-bit op, fused into the card's 3-input logic and add
    instructions where the dataflow allows, a rotate or a logical shift
    one instruction or, where one sum alone reads it, none (LEA.HI), the
    net's constants among a sum's terms one term (the kernels read them
    summed), work on a net's constants counted once, a PRF block
    0 that variants share once per distinct block, and AES-128-CMAC at
    the T-table model above.  ``block0``: the part's distinct PRF blocks
    0, summed over its nets (keyver 1/2; None counts every variant's
    own); keyver 3's variants share one a net.  It grows as
    ``per_column * b + per_part``.
    -> {"ops", "per_column", "per_part", "by_class"}."""
    one, two = (_verify_counts(kind, static, n, v, rows, c, block0) for c in (1, 2))
    by_class = {c: two[c] - one[c] for c in sorted(two) if two[c] - one[c]}
    per_col = sum(by_class.values())
    per_part = sum(one.values()) - per_col
    return {"ops": per_col * b + per_part, "per_column": per_col, "per_part": per_part,
            "by_class": by_class}


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

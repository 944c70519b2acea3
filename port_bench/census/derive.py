"""Write ``counts.json``: the instructions K1's and K3's functions need.

Run once, on any machine, from the repository root:

    python -m port_bench.census.derive

The counts are the census of the port's plain functions at the commit
that wrote them (``dwpa_tpu_torch/ops/opcount.py``: every 32-bit op of
the plain torch version, fused into the card's 3-input logic and add
instructions where the dataflow allows, a rotate one funnel shift or,
where one sum alone reads it, none, AES-CMAC at its T-table model).  The
benchmark reads only the JSON, so a later change to a kernel or to the
census cannot move the yardstick.

- ``k1.inst_per_pmk``: one PMK is 2 output blocks x 4095 iterations of
  HMAC-SHA1 over a 20-byte message from hoisted pad states plus the 5
  accumulator xors (the per-candidate prologue, under 0.01%, is left
  out).
- ``k3[<part>]``: a verify part's instructions a PMK column, as
  ``p1 + (n - 1) * pn - (n * v - runs) * x`` for ``n`` nets of ``v``
  variants whose PRF blocks 0 take ``runs`` distinct values (keyver
  1/2; keyver 3 and PMKID have ``x = 0``): ``p1`` and ``pn`` from
  ``verify_census`` at 1 and 2 nets with every block 0 its own, ``x``
  one block-0 compression a column.  ``<part>`` is ``pmkid``,
  ``eapol/<keyver>/v<V>/e<E>`` (E EAPOL blocks) or
  ``cmac/<last complete>/v<V>/f<F>`` (F full CMAC blocks).
"""

import json
from pathlib import Path

#: The verify parts the cells' nets make (21 variants: both byte
#: orders at nonce-error-corrections 8; a 121-byte EAPOL frame: 3 HMAC
#: blocks, 7 full CMAC blocks and a padded last one).
PARTS = [("pmkid", (), 1, 0), ("eapol", (1,), 21, 3), ("eapol", (2,), 21, 3),
         ("cmac", (False,), 21, 7)]
OUT = Path(__file__).resolve().parent / "counts.json"


def part_key(kind, static, v, rows):
    if kind == "pmkid":
        return "pmkid"
    if kind == "eapol":
        return f"eapol/{static[0]}/v{v}/e{rows}"
    return f"cmac/{int(static[0])}/v{v}/f{rows}"


def k1_iteration():
    """Instructions a column of one PBKDF2 iteration for one output block."""
    import torch

    from dwpa_tpu_torch.ops import hmac as hm
    from dwpa_tpu_torch.ops import opcount as oc

    def words(c):
        return tuple(torch.zeros((c,), dtype=torch.int32) for _ in range(5))

    per = {}
    for c in (1, 2):
        pro = hm.hmac_sha1_20_prologue(words(c), words(c))
        u, acc = words(c), words(c)
        with oc._Graph() as graph:
            nu = hm.hmac_sha1_20_hoisted(pro, u)
            tuple(a ^ x for a, x in zip(acc, nu))
        per[c] = sum(oc._instructions(graph).values())
    return per[2] - per[1]


def k3_part(kind, static, v, rows):
    from dwpa_tpu_torch.ops import opcount as oc

    def col(n):
        block0 = n * v if kind == "eapol" else None
        return oc.verify_census(kind, static, n, v, rows, 2, block0)["per_column"]

    x = sum(oc._block0_per_row(kind).values()) if kind == "eapol" else 0
    p1 = col(1)
    return {"p1": p1, "pn": col(2) - p1, "x": x}


def counts():
    it = k1_iteration()
    return {"k1": {"inst_per_iteration": it, "inst_per_pmk": 2 * 4095 * it},
            "k3": {part_key(k, s, v, r): k3_part(k, s, v, r) for k, s, v, r in PARTS}}


if __name__ == "__main__":
    OUT.write_text(json.dumps(counts(), indent=1, sort_keys=True) + "\n")
    print(OUT.read_text())

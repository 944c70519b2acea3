"""The frozen instruction counts of K1's and K3's functions (``counts.json``,
written by ``derive.py``) and the arithmetic that applies them to a unit.

A unit's K3 work a PMK column follows from its hashlines alone: nets are
grouped into verify parts as the crack step groups them (kind, key
version or CMAC padding, variants, EAPOL or CMAC blocks), and a keyver
1/2 part's PRF blocks 0 are counted distinct over its nets' nonce
variants.  None where the counts hold no entry for a part.
"""

import json
from pathlib import Path

from .. import reference as ref

COUNTS = json.loads((Path(__file__).resolve().parent / "counts.json").read_text())


def k1_inst_per_pmk() -> int:
    return COUNTS["k1"]["inst_per_pmk"]


def _part(line: str, nc: int):
    """(part key, variants, distinct PRF blocks 0) of one hashline."""
    net = ref.parse_line(line)
    if net["type"] == 1:
        return "pmkid", 1, 1
    kv, eapol = net["keyver"], net["eapol"]
    variants = ref.nonce_variants(net["anonce"], net["message_pair"], nc)
    v = len(variants)
    if kv == 3:
        full = max(1, -(-len(eapol) // 16)) - 1
        complete = len(eapol) > 0 and len(eapol) % 16 == 0
        return f"cmac/{int(complete)}/v{v}/f{full}", v, v
    snonce = eapol[17:49]
    block0 = set()
    for anonce in variants:
        macs, nonces, _ = ref.key_pairs(net["mac_ap"], net["mac_sta"], anonce, snonce)
        block0.add((ref.LABEL_V12 + macs + nonces)[:64])
    return f"eapol/{kv}/v{v}/e{-(-(len(eapol) + 9) // 64)}", v, len(block0)


def k3_inst_per_column(lines, nc: int):
    """K3's instructions a PMK column over every part of one ESSID group."""
    parts = {}
    for line in lines:
        key, v, runs = _part(line, nc)
        n, total_runs = parts.get(key, (0, 0))
        parts[key] = (n + 1, total_runs + runs)
    total = 0
    for key, (n, runs) in parts.items():
        c = COUNTS["k3"].get(key)
        if c is None:
            return None
        v = 1 if key == "pmkid" else int(key.split("/")[2][1:])
        total += c["p1"] + (n - 1) * c["pn"] - (n * v - runs) * c["x"]
    return total

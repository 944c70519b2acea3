"""K3's PMKID part timed on the device alone, to compare two checkouts on one card.

For each batch ``B`` of ``--batches`` and net count ``N`` of ``--nets``,
builds ``N`` PMKID nets with the ``dwpa_tpu_torch`` package of ``--root``
(default: this checkout), each net's PSK planted at two columns of a
seeded PMK matrix, and runs the crack step's one PMKID part through that
package's own launch (``parallel/step.py`` ``_KINDS``, as
``chip_smoke.py`` ``kernel_match`` does), so the kernel gets the
constants its own checkout derives.  The found matrix is held to that
package's plain version (``testing.plain_part``) and the planted hits;
the time is this checkout's ``chip_smoke.kernel_ms`` (launches queued
behind a sleep between one pair of CUDA events, median of 5 runs).
Prints one JSON line: the root, the card, and the ms of each ``BxN``.

    python3 pmkid_parts.py [--root PATH] [--batches 131072,2048] [--nets 1,2,8,32]

Needs a CUDA card and a checkout whose crack step stacks its constants
by part (``step.parts``, ``_KINDS``, ``_partition``).  To compare two
checkouts, run it for each in turn in one session on one card: parent,
change, change, parent.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batches", default="131072,2048")
    ap.add_argument("--nets", default="1,2,8,32")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("pmkid_parts_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pmkid_parts: no CUDA device", file=sys.stderr)
        return 1
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.models import m22000 as m
    from dwpa_tpu_torch.ops.common import to_torch
    from dwpa_tpu_torch.parallel.step import build_crack_step

    dev = torch.device("cuda", 0)
    essid = b"dwpa-torch-pmkid-parts"
    rng = np.random.default_rng(cs.SEED)
    ms = {}
    for b in (int(x) for x in args.batches.split(",")):
        for n in (int(x) for x in args.nets.split(",")):
            specs = [(100, 0, "", None)] * n
            lines = tfx.verify_lines(specs, essid, f"pmkid-parts-{n}")
            nets = [m.prep_net(hl.parse(line), device=dev) for line, _ in lines]
            pmk = rng.integers(0, 2**32, (8, b), dtype=np.uint64).astype(np.uint32)
            planted = tfx.plant_pmks(pmk, essid, [psk for _, psk in lines],
                                     [(i % (b // 2), b - 1 - i % (b // 2)) for i in range(n)])
            pmk = to_torch(pmk, dev)
            step = build_crack_step(nets, *m.essid_salt_blocks(essid), dev)
            ((kind, static, _, consts),) = cs.verify_parts(step, nets)
            got = cs.kernel_match(kind, static, pmk, consts)
            cs.check(torch.equal(got, tfx.plain_part(kind, static, pmk, consts)),
                     f"pmkid_parts: {b}x{n} != the plain version")
            cs.check({tuple(int(x) for x in ix) for ix in got[:n].nonzero()} ==
                     tfx.planted_hits(nets, specs, planted),
                     f"pmkid_parts: {b}x{n} hits {got.nonzero().tolist()[:8]}")
            ms[f"{b}x{n}"] = cs.kernel_ms(lambda: cs.kernel_match(kind, static, pmk, consts))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"root": root, "card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

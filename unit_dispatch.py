"""Phase 4's work unit timed by stage, to compare two checkouts on one card.

Runs the five-net unit of ``chip_smoke.py`` phase 4 (keyver 2, PMKID,
keyver 2 that cracks only with a nonce correction, keyver 1, keyver 3;
1,048,576 words at batch 131072, the PSK planted in the last batch)
through a fresh ``M22000Engine`` per repetition, with the
``dwpa_tpu_torch`` package and ``chip_smoke.py`` of ``--root`` (default:
this checkout).  One warm-up repetition builds and loads the kernels and
is reported apart.  Prints one JSON line: the root, the card, and each
repetition's wall seconds, stage host seconds (``dispatch`` includes
building the crack step) and nets cracked.

    python3 unit_dispatch.py [--root PATH] [--reps N]

Needs a CUDA card.  To compare two checkouts, run it for each in turn,
in one session on one card: parent, change, change, parent.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("unit_dispatch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dwpa_tpu_torch.models.m22000 import M22000Engine

    dev = torch.device("cuda", 0)
    lines = [ln for ln, _ in cs.unit_lines()]
    words = cs.random_words(np.random.default_rng(cs.SEED), cs.UNIT_WORDS, 8, 20)
    words[cs.PLANT_AT] = cs.PSK
    runs = []
    for _ in range(args.reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = M22000Engine(lines, batch_size=cs.UNIT_BATCH, device=dev)
        founds = eng.crack(words)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t0, "cracked": len(founds),
                     "stage_s": dict(eng.stage_times)})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"root": root, "card": card, "warmup": runs[0], "reps": runs[1:]}))
    return 0 if all(r["cracked"] == len(lines) for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())

"""The control and the dozen-seed readings of ``correct``, on the card:

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 --seconds 30 [--nc 0]

Runs the cell once a seed in one process (the card's set-up paid once)
and prints a JSON line a seed: the numbers the reference compared, the
units, whether the run is correct, and its PMK/s.  ``--nc 0`` is the
control: the client without nonce error correction (``--nonce-error-
corrections=0``, which still moves a nonce by one each way), the
guarantee the configurations state (8) broken.  The benchmark's own runs
never run it.
"""

import argparse
import json
import sys

from .cell import run_cell
from .run import BUILD, cell_spec, end_to_end, is_correct


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--nc", type=int, default=None)
    args = ap.parse_args(argv)
    _, config, traffic, _, _ = cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        w, checks, setup_s, _ = run_cell(
            config, traffic, seed, args.seconds, None, BUILD / "work" / args.workload,
            nc=args.nc, log=lambda msg: print(f"port_bench: {msg}", file=sys.stderr),
            cache_root=BUILD)
        print(json.dumps({"workload": args.workload, "seed": seed, "nc": args.nc,
                          "checks": checks, "units": len(w.units),
                          "correct": is_correct(checks, w),
                          "pmk_per_s": end_to_end(w, setup_s)["pmk_per_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

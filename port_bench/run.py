"""The port's benchmark: ``python3 -m port_bench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, run from the repository root.

One run of one cell of ``BENCHMARK.json`` on ``cuda:0``: the cell names a
configuration (``port_bench/configs/<config>.json``) and a traffic mix
(``port_bench/traffic/<traffic>.json``); its per-layer metrics are
readers of their own (``port_bench/metrics/<metric>.py``, each a
``read(window)`` that returns a number or None).  A metric named
``<base>.<suffix>`` with no file of its own reads as ``<base>``: the
same quantity under a name of its own, for cells that need their own
bound (``pmk_per_s.<suffix>`` is the window's rate).  A new cell,
configuration, traffic mix or metric is a new file and an entry in
``BENCHMARK.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (units in the window), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; ``checks`` comes last, each number the
reference compared beside its limit, as the last lines of standard error
also give them.  Without a CUDA device, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits
nonzero.
"""

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "dwpa_tpu")
#: Every number the reference compares must not exceed its limit: each
#: is an exact count (a planted find missed, a PSK that does not crack
#: its net, a unit never reported, a potfile line off the finds), and
#: beside them the kernel and native-library builds inside the window.
LIMITS = {"missed": 0, "wrong": 0, "unanswered": 0, "potfile": 0, "builds": 0}


def load_json(path):
    return json.loads(Path(path).read_text())


def cell_spec(name, bench=None):
    """(workload entry, config, traffic, end-to-end metrics, per-layer
    metrics) of cell ``name`` from ``BENCHMARK.json``."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cell, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def base_name(name, known):
    """``name``, or the longest ``<base>`` of ``<base>.<suffix>`` in ``known``."""
    while name not in known and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def reader(metric_name):
    """The ``read`` function of ``metrics/<metric_name>.py``, or of its base's."""
    name = base_name(metric_name, {p.stem for p in (HERE / "metrics").glob("*.py")})
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(w, setup_s, names=("pmk_per_s", "setup_s")):
    """The end-to-end readings of a window under ``names``: its PMKs over
    its wall time, and the set-up's seconds."""
    got = {"pmk_per_s": w.pmks / w.seconds, "setup_s": setup_s}
    return {n: got[base_name(n, got)] for n in names}


def is_correct(checks, w):
    """Every compared number within its limit, over a window of one unit or more."""
    return all(checks[k] <= LIMITS[k] for k in LIMITS) and len(w.units) > 0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m port_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, e2e, per_layer = cell_spec(args.workload)
    # every build and kernel cache of the run stays inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from .cell import run_cell

    trace_path = BUILD / f"trace-{args.workload}.json" if args.trace else None
    BUILD.mkdir(parents=True, exist_ok=True)
    w, checks, setup_s, peak = run_cell(
        config, traffic, args.seed, args.seconds, trace_path, BUILD / "work" / args.workload,
        t_start=t_start, log=lambda msg: print(f"port_bench: {msg}", file=sys.stderr),
        cache_root=BUILD)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    correct = is_correct(checks, w)
    if args.trace:
        values = {}
        for m in per_layer:
            v = reader(m["name"])(w)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = end_to_end(w, setup_s, [m["name"] for m in e2e])
        values = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]} for m in e2e}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(w.units), "failed": w.extra["failed"],
           "metrics": values, "device": device}
    if w.trace is not None:
        device["busy_s"], device["window_s"] = w.trace["busy_s"], w.trace["window_s"]
        out["breakdown"] = {"device_ops": w.trace["device_ops"],
                            "idle_gaps": w.trace["idle_gaps"]}
    out["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    for k in LIMITS:
        print(f"check {k}: {checks[k]} (limit {LIMITS[k]})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

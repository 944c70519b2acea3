"""The harness is driven by data: every cell, configuration, traffic mix
and per-layer metric of ``BENCHMARK.json`` is a file the harness finds
by its name, and a new one is a new file and a new entry."""

import json
import re
import uuid

import pytest

from port_bench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    spec, config, traffic, e2e, per_layer = run.cell_spec(cell)
    assert {"dict_cache", "dict_pool", "dict_seed", "len_weights"} <= set(traffic)
    assert {"nets", "dictcount", "dict_words", "batch_size"} <= set(config)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer and {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}
    for m in per_layer:
        assert callable(run.reader(m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]] and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (run.ROOT / c["file"]).exists()
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A traffic mix and a metric added as new files, and a cell that uses
    them added to a copy of BENCHMARK.json, resolve without an edit to any
    file that is there."""
    tag = "t" + uuid.uuid4().hex[:8]
    traffic = run.HERE / "traffic" / f"{tag}.json"
    metric = run.HERE / "metrics" / f"{tag}.units.py"
    try:
        traffic.write_text(json.dumps({"dict_cache": False, "dict_pool": 1, "dict_seed": 1,
                                       "len_weights": {"8": 1}}))
        metric.write_text("def read(w):\n    return float(len(w.units))\n")
        bench = json.loads(json.dumps(BENCH))
        bench["workloads"].append({"name": f"unit5.{tag}", "config": "unit5",
                                   "traffic": tag, "chips": 1, "why": "a test"})
        bench["per_layer"].append({"name": f"{tag}.units", "unit": "units", "better": "higher",
                                   "source": "program_counter", "layer": "client",
                                   "moves": "pmk_per_s", "workloads": [f"unit5.{tag}"]})
        spec, config, tr, e2e, per_layer = run.cell_spec(f"unit5.{tag}", bench)
        assert tr["dict_pool"] == 1 and config["name"] == "unit5"
        assert [m["name"] for m in per_layer] == [f"{tag}.units"]

        class W:
            units = [1, 2]
            pmks, seconds = 30, 2.0

        assert run.reader(f"{tag}.units")(W) == 2.0
        # a name of its own for a quantity there is a reader or a reading of
        assert run.reader(f"k1_roofline.{tag}").__code__.co_filename == str(
            run.HERE / "metrics" / "k1_roofline.py")
        assert run.end_to_end(W, 9.0, ["pmk_per_s", f"pmk_per_s.{tag}", "setup_s"]) == {
            "pmk_per_s": 15.0, f"pmk_per_s.{tag}": 15.0, "setup_s": 9.0}
    finally:
        traffic.unlink(missing_ok=True)
        metric.unlink(missing_ok=True)


def test_no_card_no_result(capsys):
    """Without a CUDA device the run exits nonzero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "unit5.cache_warm", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""

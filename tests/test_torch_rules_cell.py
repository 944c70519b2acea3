"""The rules seam's K1 column counter and the benchmark's rules cell.

- ``dwpa_rules_k1_columns_total{fill=candidate|pad}``: exact counts from
  ``crack_rules_blocks`` at batch 8, with rules in two device chunks, an
  overflow pair and a rule the device cannot run, and beside them the
  columns the PBKDF2 calls really received;
- ``unit5.rules_warm`` resolves to ``unit5_rules`` (unit5's nets under
  server rules) and the rules mix, and every per-layer metric it lists
  resolves to a reader;
- the two rules readers on synthetic windows, and None where the program
  records nothing.

The port's PBKDF2 is ``hashlib_pmk`` here (the plain torch PBKDF2 at 4096
iterations takes minutes on a CPU).  No JAX.
"""

import pytest
from torch_fixtures import hashlib_pmk

from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.feed import frame_blocks
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.parallel.step import RULES_CHUNK
from dwpa_tpu_torch.rules import parse_rules
from port_bench import gen, run
from port_bench.cell import Window

#: Nine rules the device runs (chunks of 8 and 1) and one it cannot (``@``).
RULES = [":", "u", "c", "$1", "$2", "r", "d", "l", "^x", "@a"]
#: Batch 8: four plain bases (``x`` * 40 overflows under ``d``: 80 bytes,
#: past the device's 64) and one overlong base, every rule on the host.
WORDS = [b"alpha123", b"bravo456", b"x" * 40, b"charlie7", b"y" * 70]
PSK = b"Bravo456"                                   # 'bravo456' through 'c'


@pytest.mark.parametrize("essids", [1, 2])
def test_k1_column_counter_is_exact(monkeypatch, essids):
    """Device chunk 1 (8 rules over the block's 4 real rows, packed into 32
    columns, four launches of the batch's 8): 4 x 8 pairs less the ``d``
    overflow, 31 candidates, 1 pad; chunk 2 (``^x``): one launch of 4
    columns, 4 candidates.  The host
    tail: 15 pairs (the overlong base x 10 rules, the overflow pair, 4
    ``@a`` purges) flush at 8 outputs; the first 8 are all overlong, so
    that batch launches nothing, and the last 7 hold one valid word
    (``x`` * 40 through ``@a``): 1 candidate against the batch's 8
    columns.  Each count is a group's, times the ESSID groups."""
    calls = []

    def pmk(pw, salt1, salt2):
        calls.append(pw.shape[0])
        return hashlib_pmk(pw, salt1, salt2)

    launched = []
    counted = tm._RulesCtx.launched
    monkeypatch.setattr(tm, "_pmk_impl", pmk)
    monkeypatch.setattr(tm._RulesCtx, "launched",
                        lambda self, *a: (launched.append(a), counted(self, *a)))
    # a net no candidate cracks in each group keeps every group live
    lines = [tfx.make_pmkid_line(PSK, b"cols-0", seed="cols-psk")]
    lines += [tfx.make_pmkid_line(b"never-a-candidate", b"cols-%d" % i, seed="cols-%d" % i)
              for i in range(essids)]
    eng = tm.M22000Engine(lines, batch_size=8, device="cpu")
    reg = MetricsRegistry()
    reports = []
    founds = eng.crack_rules_blocks(frame_blocks(iter(WORDS), 8), parse_rules(RULES),
                                    registry=reg,
                                    on_batch=lambda c, f: reports.append((c, len(f))))
    assert len(RULES) - 1 == RULES_CHUNK + 1
    assert [f.psk for f in founds] == [PSK] and reports == [(len(WORDS) * len(RULES), 1)]
    assert launched == [(essids, 32, 31), (essids, 4, 4), (essids, 8, 1)]
    assert reg.value("dwpa_rules_k1_columns_total", fill="candidate") == essids * (31 + 4 + 1)
    assert reg.value("dwpa_rules_k1_columns_total", fill="pad") == essids * (1 + 0 + 7)
    # per chunk and group, the packed columns in launches of the batch; one a tail batch
    assert calls == [8] * 4 * essids + [4] * essids + [8] * essids
    assert reg.value("dwpa_rules_device_expanded_total") == 31 + 4
    assert reg.value("dwpa_rules_host_fallback_total", reason="overflow") == 10 + 1


#: The cell's per-layer metrics and the reader each resolves to: the rules
#: seam's own, then ``<base>.rules`` for the layers the dict cells read.
CELL_METRICS = {"rules.k1_fill_share": "rules.k1_fill_share",
                "rules.expand_device_share": "rules.expand_device_share",
                "rules.host_fallback_share": "rules.host_fallback_share",
                "k1_roofline.rules": "k1_roofline", "step_mfu.rules": "step_mfu"}
CELL_METRICS.update((f"{b}.rules", b) for b in (
    "device.idle_share", "engine.gate_inflight", "k3.device_share", "k3_roofline",
    "client.checkpoint_ms_per_batch", "feed.stage_ms_per_batch", "feed.starve_share",
    "client.unit_overhead_s", "engine.dispatch_ms_per_batch",
    "engine.found_fetch_mb_per_unit"))


def test_rules_cell_resolves_to_unit5_and_the_rules_mix():
    cell, config, traffic, e2e, per_layer = run.cell_spec("unit5.rules_warm")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("unit5_rules", "rules_warm", 1)
    assert config == run.load_json(run.HERE / "configs" / "unit5_rules.json")
    assert config["dictcount"] == 15 and config["batch_size"] == 131072
    assert traffic == run.load_json(run.HERE / "traffic" / "rules_warm.json")
    assert traffic["dict_words"] == 8192 and traffic["rules_file"] == "wpa.rule"
    # unit5's nets and numbers, with the rules deployment's dicts and rules
    unit5 = run.load_json(run.HERE / "configs" / "unit5.json")
    same = ("nets", "dictcount", "batch_size", "nonce_error_corrections", "nc_delta_max",
            "key_data_bytes")
    assert {k: config[k] for k in same} == {k: unit5[k] for k in same}
    assert (config["dict_words"], config["rules_file"]) == (8192, "wpa.rule")
    assert config["rules"] == len(gen.traffic_rules(traffic)) == 105
    assert [m["name"] for m in e2e] == ["pmk_per_s", "setup_s"]
    assert [m["name"] for m in per_layer] == list(CELL_METRICS)
    for m in per_layer:
        assert m["workloads"] == ["unit5.rules_warm"] and m["moves"] == "pmk_per_s"
    # an alias keeps its base's unit, direction, source and layer
    base = {m["name"]: m for m in run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]}
    for m in per_layer:
        if CELL_METRICS[m["name"]] != m["name"]:
            assert {k: v for k, v in m.items() if k not in ("name", "workloads")} == {
                k: v for k, v in base[CELL_METRICS[m["name"]]].items()
                if k not in ("name", "workloads")}


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_rules_cell_metric_has_a_reader(name):
    read = run.reader(name)
    assert callable(read) and read.__module__ == CELL_METRICS[name]


def _window(before=None, after=None, trace=None):
    return Window(seconds=120.0, units=[1], results=[], pmks=1, metrics_before=before or {},
                  metrics_after=after or {}, spans=[], k1_launches=0, trace=trace)


def _columns(candidate, pad):
    return {"dwpa_rules_k1_columns_total": {"type": "counter", "samples": [
        {"labels": {"fill": "candidate"}, "value": candidate},
        {"labels": {"fill": "pad"}, "value": pad}]}}


def test_k1_fill_share_reads_the_windows_columns():
    read = run.reader("rules.k1_fill_share")
    assert read(_window(_columns(10, 90), _columns(110, 390))) == 25.0
    assert read(_window(after=_columns(3, 1))) == 75.0
    assert read(_window(_columns(5, 5), _columns(5, 5))) is None
    assert read(_window()) is None


def test_expand_device_share_counts_the_torch_kernels():
    read = run.reader("rules.expand_device_share")
    by_name = {"pbkdf2_sha1_pmk_kernel": 90.0, "verify_eapol_kernel_2_": 3.0,
               "verify_cmac_kernel": 1.0, "verify_pmkid_kernel": 0.5,
               "Memcpy HtoD": 0.25, "Memset": 0.25,
               "at::native::vectorized_elementwise_kernel": 4.0,
               "at::native::reduce_kernel": 1.0}
    trace = {"by_name": by_name, "device_s": sum(by_name.values())}
    assert read(_window(trace=trace)) == pytest.approx(5.0)
    assert read(_window(trace={"by_name": {}, "device_s": 0.0})) is None
    assert read(_window()) is None

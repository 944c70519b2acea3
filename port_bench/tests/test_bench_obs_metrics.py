"""The readers of the consumer loop's spans and counters, on synthetic
windows: each reads its window's share alone, and returns None where the
program records nothing (a checkout without the spans or counters)."""

import pytest

from port_bench import run
from port_bench.cell import Window


def _window(spans=(), before=None, after=None, units=3):
    return Window(seconds=30.0, units=list(range(units)), results=[], pmks=1,
                  metrics_before=before or {}, metrics_after=after or {}, spans=list(spans),
                  k1_launches=0)


def _hist(count, total):
    return {"dwpa_engine_gate_inflight_batches": {
        "type": "histogram", "samples": [{"labels": {}, "count": count, "sum": total,
                                          "buckets": [0] * 6}]}}


def _counter(value):
    return {"dwpa_engine_found_fetch_bytes_total": {
        "type": "counter", "samples": [{"labels": {}, "value": value}]}}


def _span(name, t0, seconds):
    return {"name": name, "parent": "pass2", "depth": 1, "t0": t0, "t1": t0 + seconds}


def test_gate_inflight_is_the_windows_mean():
    read = run.reader("engine.gate_inflight")
    assert read(_window(before=_hist(10, 30.0), after=_hist(14, 30.0))) == 0.0
    assert read(_window(before=_hist(10, 5.0), after=_hist(20, 35.0))) == 3.0
    assert read(_window(before=_hist(10, 5.0), after=_hist(10, 5.0))) is None
    assert read(_window()) is None


@pytest.mark.parametrize("metric,span", [("client.checkpoint_ms_per_batch", "client:checkpoint"),
                                         ("feed.stage_ms_per_batch", "feed:stage")])
def test_span_means_in_ms(metric, span):
    read = run.reader(metric)
    spans = [_span(span, 1.0, 0.002), _span(span, 2.0, 0.004), _span("engine:gate", 3.0, 1.0)]
    assert read(_window(spans)) == pytest.approx(3.0)
    assert read(_window([_span("engine:gate", 3.0, 1.0)])) is None


def test_found_fetch_mb_per_unit():
    read = run.reader("engine.found_fetch_mb_per_unit")
    assert read(_window(before=_counter(1e6), after=_counter(7e6), units=2)) == 3.0
    assert read(_window(before=_counter(5.0), after=_counter(5.0))) == 0.0
    assert read(_window()) is None
    assert read(_window(before=_counter(0.0), after=_counter(1.0), units=0)) is None


def test_entries_name_their_readers():
    names = {"engine.gate_inflight", "client.checkpoint_ms_per_batch",
             "feed.stage_ms_per_batch", "engine.found_fetch_mb_per_unit"}
    entries = [m for m in run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]
               if m["name"] in names]
    assert {m["name"] for m in entries} == names
    for m in entries:
        assert m["moves"] == "pmk_per_s"
        assert m["workloads"] == ["unit5.cache_warm", "group72.cache_warm"]
        assert run.reader(m["name"]).__module__ == m["name"]

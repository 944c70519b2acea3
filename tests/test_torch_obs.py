"""The port's consumer-loop telemetry: the spans of ``crack_blocks``
(``feed:next``, ``feed:stage``, ``engine:dispatch``, ``engine:collect`` >
``engine:gate`` / ``engine:decode``) and of ``crack_fused``'s batches,
``stage_times`` read off them, the found-fetch byte counter, the tracer's
ring, and its ranges under a running ``torch.profiler``.

The engine runs on the CPU with hashlib PMKs (``hashlib_pmk``), as in
test_torch_feed.py; the in-flight count needs a card and is tested in
test_torch_gpu.py.
"""

import gc
import json
import subprocess
import sys

import pytest
import torch
from torch_fixtures import SLICE_PSK, five_net_group, hashlib_pmk

from dwpa_tpu_torch import feed as tfeed
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry, SpanTracer
from dwpa_tpu_torch.obs import spans as obs_spans

BATCH = 16
LOOP = ("feed:next", "feed:stage", "engine:dispatch", "engine:collect", "engine:gate")
FETCH = "dwpa_engine_found_fetch_bytes_total"


def _words(nblocks, hit):
    """``nblocks`` full blocks of filler, the PSK last where ``hit``."""
    words = [b"obs-filler-%06d" % i for i in range(nblocks * BATCH)]
    if hit:
        words[-1] = SLICE_PSK
    return words


def _crack(monkeypatch, nblocks, hit, feed=False):
    """``crack_blocks`` of five nets over ``nblocks`` blocks inside a
    ``pass2`` span: (engine, tracer, registry, fetched bytes by decode)."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    eng = tm.M22000Engine(five_net_group(), batch_size=BATCH, device="cpu", tracer=tracer)
    decoded = []
    real = eng._decode

    def decode(group, found, pmk_col, pws, live):
        # the found matrix and one 8-word PMK column per hit column
        decoded.append(found.nbytes + 32 * int(found.any(axis=(0, 1)).sum()))
        return real(group, found, pmk_col, pws, live)

    eng._decode = decode
    words = _words(nblocks, hit)
    blocks = (tfeed.CandidateFeed(iter(words), BATCH, prepack=eng.host_packer(), registry=reg)
              if feed else tfeed.frame_blocks(iter(words), BATCH))
    with tracer.span("pass2"):
        founds = eng.crack_blocks(blocks)
    if feed:
        blocks.close()
    assert len(founds) == (5 if hit else 0)
    return eng, tracer, reg, decoded


@pytest.mark.parametrize("feed", [False, True])
@pytest.mark.parametrize("hit", [False, True])
def test_crack_blocks_spans_per_block(monkeypatch, hit, feed):
    """One span of each loop stage a block (the last pull meets the
    stream's end), a decode only on the hit batch, nested in order."""
    n = 6
    _, tracer, _, _ = _crack(monkeypatch, n, hit, feed)
    recs = tracer.records()
    count = {name: sum(r["name"] == name for r in recs) for name in LOOP + ("engine:decode",)}
    assert count == {"feed:next": n + 1, "feed:stage": n, "engine:dispatch": n,
                     "engine:collect": n, "engine:gate": n, "engine:decode": int(hit)}
    for r in recs:
        if r["name"] in ("engine:gate", "engine:decode"):
            assert (r["parent"], r["depth"]) == ("engine:collect", 2)
        elif r["name"] != "pass2":
            assert (r["parent"], r["depth"]) == ("pass2", 1), r
    collects = [r for r in recs if r["name"] == "engine:collect"]
    for r in recs:
        if r["name"] in ("engine:gate", "engine:decode"):
            assert any(c["t0"] <= r["t0"] <= r["t1"] <= c["t1"] for c in collects)


def test_stage_times_are_the_spans_seconds(monkeypatch):
    eng, tracer, _, _ = _crack(monkeypatch, 5, True)
    assert set(eng.stage_times) == {"prepare", "dispatch", "collect"}
    for key in ("dispatch", "collect"):
        spans = tracer.records(f"engine:{key}")
        assert spans and eng.stage_times[key] == sum(r["t1"] - r["t0"] for r in spans)
    assert eng.stage_times["prepare"] > 0


@pytest.mark.parametrize("hit", [False, True])
def test_found_fetch_bytes(monkeypatch, hit):
    """The counter holds the hit batch's found matrix and hit PMK columns,
    and stays 0 over all-miss batches."""
    _, _, reg, decoded = _crack(monkeypatch, 4, hit)
    assert len(decoded) == int(hit)
    assert reg.value(FETCH) == sum(decoded)
    if hit:
        assert decoded[0] == 5 * max(len(n.variants) for n in five_net_group_prepped()) * BATCH + 32


def five_net_group_prepped():
    return tm.M22000Engine(five_net_group(), batch_size=BATCH, device="cpu").nets


def test_crack_fused_collects_each_batch_once(monkeypatch):
    """``crack_fused`` over three units, two fused batches (hits in both
    units of the first): one ``engine:collect`` with one ``engine:gate``
    inside it a batch, a decode a hit unit, the counter at each hit
    unit's found matrix and 32 bytes a hit column, and ``stage_times``
    the spans' seconds."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    psks = [b"obs-fused-pa", b"obs-fused-pb"]
    essids = [b"ObsFuseA", b"ObsFuseB", b"ObsFuseC"]
    lines = [tfx.make_pmkid_line(psks[0], essids[0], seed="of-a"),
             tfx.make_pmkid_line(psks[1], essids[1], seed="of-b"),
             tfx.make_pmkid_line(b"not-in-the-words", essids[2], seed="of-c")]
    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    eng = tm.M22000Engine(lines, batch_size=BATCH, device="cpu", tracer=tracer)
    decoded = []
    real = eng._decode

    def decode(group, found, pmk_col, pws, live):
        decoded.append(found.nbytes + 32 * int(found.any(axis=(0, 1)).sum()))
        return real(group, found, pmk_col, pws, live)

    eng._decode = decode
    parts = [(essids[0], [b"obsfusea%02d" % i for i in range(5)] + [psks[0]]),
             (essids[1], [psks[1]] + [b"obsfuseb%02d" % i for i in range(5)]),
             (essids[2], [b"obsfusec%02d" % i for i in range(6)])]
    widths, events = [], []
    founds = eng.crack_fused(parts, max_units=2, tracer=tracer,
                             on_batch=lambda k, c, f: events.append((k, c, len(f))),
                             on_fused=lambda fb: widths.append(fb.width))
    assert sorted(f.psk for f in founds) == sorted(psks)
    assert events == [(essids[0], 6, 1), (essids[1], 6, 1), (essids[2], 6, 0)]
    recs = tracer.records()
    names = ("engine:dispatch", "engine:collect", "engine:gate", "engine:decode",
             "sched:demux")
    assert {n: sum(r["name"] == n for r in recs) for n in names} == dict(
        zip(names, (2, 2, 2, 2, 2)))
    for r in tracer.records("engine:gate") + tracer.records("engine:decode"):
        assert r["parent"] == "engine:collect"
    # one PMKID net a unit: a found matrix of [1, 1, width] bools
    assert reg.value(FETCH) == sum(decoded) == 2 * (widths[0] + 32)
    for key in ("dispatch", "collect"):
        assert eng.stage_times[key] == sum(
            r["t1"] - r["t0"] for r in tracer.records(f"engine:{key}"))


def test_engine_without_tracer_opens_no_span(monkeypatch):
    """No tracer: no span, no counter, and ``stage_times`` still counts."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    opened = []
    monkeypatch.setattr(SpanTracer, "start", lambda self, name: opened.append(name))
    eng = tm.M22000Engine(five_net_group(), batch_size=BATCH, device="cpu")
    founds = eng.crack_blocks(tfeed.frame_blocks(iter(_words(3, True)), BATCH))
    assert len(founds) == 5 and opened == []
    assert eng.stage_times["dispatch"] > 0 and eng.stage_times["collect"] > 0
    assert eng._m_fetch is None and eng._inflight is None


def _unit_spans(tracer, batches):
    """The spans a client unit records, as the client nests them."""
    with tracer.span("work_unit"):
        with tracer.span("pass1"):
            for name in LOOP + ("client:checkpoint",):
                tracer.start(name).stop()
        with tracer.span("pass2"):
            for _ in range(batches):
                for name in ("feed:next", "feed:stage", "engine:dispatch"):
                    tracer.start(name).stop()
                with tracer.span("engine:collect"):
                    tracer.start("engine:gate").stop()
                tracer.start("client:checkpoint").stop()
        tracer.start("put_work").stop()


def test_ring_keeps_every_unit_of_a_window():
    """Four units of 120 batches: every ``work_unit`` and ``pass2``
    record stays in the ring (a window's unit spans, whole)."""
    tracer = SpanTracer(MetricsRegistry())
    for _ in range(4):
        _unit_spans(tracer, 120)
    assert len(tracer.records("work_unit")) == 4
    assert len(tracer.records("pass2")) == 4
    assert len(tracer.records("client:checkpoint")) == 4 * 121
    assert isinstance(tracer.records(), list)


def test_ring_drops_oldest_beyond_its_size():
    tracer = SpanTracer(MetricsRegistry())
    for i in range(obs_spans.RING + 10):
        tracer.start(f"s{i}").stop()
    recs = tracer.records()
    assert len(recs) == obs_spans.RING
    assert recs[0]["name"] == "s10" and recs[-1]["name"] == f"s{obs_spans.RING + 9}"


def _nested(tracer, n):
    """``n`` spans: outer spans each around one inner span."""
    for i in range(n // 2):
        with tracer.span(f"outer-{i}"):
            with tracer.span(f"inner-{i}"):
                pass


def _profiled_spans(path):
    """200 nested spans under a CPU profiler: the worst disagreement, in
    microseconds, of their user-annotation ranges' starts (after one
    shift, the median offset) and durations with their records."""
    tracer = SpanTracer(MetricsRegistry())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    gc.disable()
    try:
        with SpanTracer(MetricsRegistry()).span("first"):
            pass
        _nested(tracer, 200)
    finally:
        gc.enable()
        prof.stop()
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    recs = tracer.records()
    assert len(recs) == 200 and all(r["name"] in events for r in recs)
    offsets = sorted(events[r["name"]]["ts"] - r["t0"] * 1e6 for r in recs)
    shift = offsets[len(offsets) // 2]
    return max(max(abs(events[r["name"]]["ts"] - (r["t0"] * 1e6 + shift)),
                   abs(events[r["name"]]["dur"] - (r["t1"] - r["t0"]) * 1e6)) for r in recs)


def test_profiler_ranges_match_span_records(tmp_path):
    """Under a CPU profiler, 200 nested spans appear as user-annotation
    ranges whose starts and durations agree with their ``perf_counter``
    records within 0.2 ms after one shift.

    The process's first range pays a one-time lookup of about a
    millisecond, so one span goes first, and the collector stays off
    inside the loop.  A loaded host can still deschedule the thread
    between a range's stamp and the span's clock read; a set in which
    that happened is measured again, up to three sets."""
    worst = [_profiled_spans(tmp_path / f"trace{i}.json") for i in range(3)]
    assert min(worst) < 200, worst


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: opened.append(self.name))
    tracer = SpanTracer(MetricsRegistry())
    _nested(tracer, 10)
    assert opened == [] and len(tracer.records()) == 10


def test_abandoned_children_close_their_ranges(tmp_path):
    """A span stopped over children that never stopped exits their
    ranges first, innermost first, and the tracer goes on."""
    tracer = SpanTracer(MetricsRegistry())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        outer = tracer.start("outer")
        mid = tracer.start("mid")
        inner = tracer.start("inner")
        outer.stop()
        assert mid._range is None and inner._range is None and outer._range is None
        with tracer.span("after") as sp:
            assert sp.depth == 0 and sp._range is not None
        open_late = tracer.start("open-late")
    finally:
        prof.stop()
    open_late.stop()    # its range outlived the profiler: exits quietly
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"outer", "mid", "inner", "after"} <= names
    assert [r["name"] for r in tracer.records()] == ["outer", "after", "open-late"]


def test_obs_imports_no_torch():
    code = ("import sys, dwpa_tpu_torch.obs as o; t = o.SpanTracer(o.MetricsRegistry()); "
            "t.start('x').stop(sync=lambda: None); assert 'torch' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def test_inflight_histogram_records_nothing_on_the_cpu(monkeypatch):
    _, _, reg, _ = _crack(monkeypatch, 3, True)
    assert reg.value("dwpa_engine_gate_inflight_batches") is None


@pytest.mark.parametrize("hit", [False, True])
def test_cpu_gate_reads_the_scalars_and_records_no_event(monkeypatch, hit):
    """On the CPU the hits gate is the group hit scalars' own tensor, read
    as it is when the batch is collected: no CUDA event or stream is made,
    the decode's reads take no stream context, and no in-flight sample is
    taken."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CPU engine made a CUDA event or stream")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "Stream", no_cuda)
    reg = MetricsRegistry()
    eng = tm.M22000Engine(five_net_group(), batch_size=BATCH, device="cpu",
                          tracer=SpanTracer(reg))
    rec = eng._dispatch(eng._prepare(_words(1, hit)))
    gate = rec.gate
    assert gate.event is None and gate.hits.device.type == "cpu"
    assert torch.equal(gate.hits, torch.stack([out[0] for _, out in rec.outs]))
    assert eng._gate(gate) == gate.hits.tolist() and (sum(gate.hits.tolist()) > 0) == hit
    with eng._fetching(gate) as ctx:
        assert ctx is None  # no stream context on the CPU
    assert len(eng._collect(rec)) == (5 if hit else 0)
    assert eng._fetch_stream is None and eng._inflight is None
    assert reg.value("dwpa_engine_gate_inflight_batches") is None

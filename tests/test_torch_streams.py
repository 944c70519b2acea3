"""Per-device streams in the port held to ``dwpa_tpu``, exactly.

Each case of ``tests/test_streams.py`` runs here on the port's
``parallel.streams`` and engine:

- PARITY — ``crack_streams`` on three stream engines over the CPU
  against the JAX engine's ``crack_blocks`` on a one-device mesh over the
  same framed feed (mixed keyvers and ESSIDs): the same founds and the
  same per-block ``on_batch`` sequence, plus telemetry and no leaked
  thread; the rules twin ``crack_rules_streams`` against JAX's
  ``crack_rules_blocks``;
- RESUME — a stream run resumed at ``skip=k`` covers the lockstep tail;
- POLICY — ``streams_default`` / ``default_feed_workers``;
- FAULTS — crash requeue onto a survivor (fake engines, and a real
  engine that raises on its third block), out of streams, attempts
  exhausted, a feed error, and found dedup with cross-stream prune;
- the executor's ``_stream_bundles`` bundle for bundle against JAX's on
  the same wave, and a stream wave's results against the lockstep wave;
- lint rule DW110 over the port's ``parallel/streams.py`` linted under
  its JAX name.

The port's PBKDF2 is ``hashlib_pmk`` (the plain torch PBKDF2 at 4096
iterations takes minutes on a CPU); the JAX side runs its own.
"""

import threading
import time
import types
from pathlib import Path

import jax
import pytest
import torch
from torch_fixtures import hashlib_pmk

from dwpa_tpu import testing as jtfx
from dwpa_tpu.feed import frame_blocks as jframe_blocks
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.rules import parse_rules as jparse_rules
from dwpa_tpu.sched import MultiUnitExecutor as JMultiUnitExecutor
from dwpa_tpu.sched import WorkUnit as JWorkUnit
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.feed import frame_blocks
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.obs.spans import SpanTracer
from dwpa_tpu_torch.parallel import StreamError, StreamExecutor
from dwpa_tpu_torch.parallel.streams import (default_feed_workers, device_label,
                                             stream_devices, streams_default)
from dwpa_tpu_torch.rules import parse_rules
from dwpa_tpu_torch.sched import MultiUnitExecutor, WorkUnit

BATCH = 32
NSTREAMS = 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


def _lines(fx):
    """Mixed keyvers + mixed ESSIDs (``tests/test_streams.py``'s); NetD is
    never cracked so neither path stops early."""
    return [
        fx.make_pmkid_line(b"stream-pass-a", b"StreamNetA", seed="st1"),
        fx.make_eapol_line(b"stream-pass-b", b"StreamNetB", keyver=2, seed="st2"),
        fx.make_eapol_line(b"stream-pass-c", b"StreamNetC", keyver=3, seed="st3"),
        fx.make_pmkid_line(b"not-in-keyspace", b"StreamNetD", seed="st4"),
    ]


def _words():
    """5 blocks of 32; the three PSKs land in different blocks; block 4
    holds no valid word (all shorter than 8 bytes)."""
    words = [b"stjunk%04d" % i for i in range(160)]
    words[3] = b"stream-pass-a"
    words[40] = b"stream-pass-b"
    words[100] = b"stream-pass-c"
    words[128:160] = [b"x%d" % i for i in range(32)]
    return words


def _keys(founds):
    return sorted((f.line.essid, f.psk, f.nc, f.endian, f.pmk) for f in founds)


def _log(into):
    return lambda c, f: into.append((c, sorted(x.psk for x in f)))


def _stream_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("stream-", "sched-stream-"))]


_JAX = {}


def _jax_lockstep(skip=0):
    """The JAX engine's crack_blocks on a one-device mesh: (founds, log),
    computed once per skip."""
    if skip not in _JAX:
        eng = jm.M22000Engine(_lines(jtfx), batch_size=BATCH,
                              mesh=default_mesh(devices=jax.devices()[:1]))
        log = []
        founds = eng.crack_blocks(
            jframe_blocks(iter(_words()[skip:]), BATCH, base_offset=skip),
            on_batch=_log(log))
        _JAX[skip] = (_keys(founds), log, {n.line.essid for n in eng.nets})
    return _JAX[skip]


# ---------------------------------------------------------------------------
# parity with the lockstep path
# ---------------------------------------------------------------------------


def test_streams_match_lockstep_and_stay_compiled():
    """Identical founds AND per-block on_batch sequence (ordered demux =
    unchanged resume framing) against JAX's lockstep crack_blocks; the
    all-invalid block reports its count with no dispatch; telemetry per
    device; and a second run builds no library (the port's twin of the
    warm-rerun recompile check)."""
    from dwpa_tpu_torch.analysis import watch_compiles

    jkeys, jlog, jlive = _jax_lockstep()
    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    eng = tm.M22000Engine(_lines(tfx), batch_size=BATCH, device=CPU)
    log = []
    founds = eng.crack_streams(frame_blocks(iter(_words()), BATCH),
                               on_batch=_log(log), devices=[CPU] * NSTREAMS,
                               registry=reg, tracer=tracer)
    assert _keys(founds) == jkeys
    assert [p for _, ps in log for p in ps]
    assert log == jlog
    assert sum(c for c, _ in log) == len(_words())
    assert {n.line.essid for n in eng.nets} == jlive == {b"StreamNetD"}
    assert _stream_threads() == []
    assert (reg.value("dwpa_stream_blocks_total", device=device_label(CPU))
            == len(log))
    busy = reg.value("dwpa_stream_busy_fraction", device=device_label(CPU))
    assert busy is None or 0.0 <= busy <= 1.0
    names = {r["name"] for r in tracer.records()}
    assert {"stream:dispatch", "stream:collect"} <= names

    warm = tm.M22000Engine(_lines(tfx), batch_size=BATCH, device=CPU)
    with watch_compiles() as rep:
        again = warm.crack_streams(frame_blocks(iter(_words()), BATCH),
                                   devices=[CPU] * NSTREAMS)
    assert _keys(again) == jkeys and rep.count == 0


def test_streams_resume_skip_equivalence():
    """A stream run resumed at skip=k equals the lockstep run over the
    same unskipped tail, and the first block keeps the global offset."""
    skip = 64   # past pass-a AND pass-b; only pass-c remains
    jkeys, jlog, _ = _jax_lockstep(skip)
    blocks = list(frame_blocks(iter(_words()[skip:]), BATCH, base_offset=skip))
    assert blocks[0].offset == skip
    log = []
    founds = tm.M22000Engine(_lines(tfx), batch_size=BATCH, device=CPU).crack_streams(
        iter(blocks), on_batch=_log(log), devices=[CPU] * 2)
    assert _keys(founds) == jkeys
    assert {f.psk for f in founds} == {b"stream-pass-c"}
    assert log == jlog and sum(c for c, _ in log) == len(_words()) - skip


def test_streams_default_policy(monkeypatch):
    """One process with several CUDA devices turns streams on; the feed
    defaults to one producer per CUDA device (one without a card); an
    engine's default stream devices are every CUDA device, or its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert streams_default() is False and default_feed_workers() == 1
    assert stream_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert streams_default() is False and default_feed_workers() == 1
    assert stream_devices("cuda:0") == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert streams_default() is True and default_feed_workers() == 8
    assert len(stream_devices("cuda:3")) == 8


def test_rules_streams_match_jax_rules_blocks():
    """crack_rules_streams over three stream engines equals the JAX
    engine's crack_rules_blocks at skip 0 and inside block 0: founds and
    the per-block on_batch sequence (expanded counts)."""
    from test_torch_rules import (BATCH as RB, ENGINE_RULES, _engine_lines,
                                  _engine_words)

    for skip in (0, 22):
        jeng = jm.M22000Engine(_engine_lines(), batch_size=RB,
                               mesh=default_mesh(devices=jax.devices()[:1]))
        jlog, tlog = [], []
        jf = jeng.crack_rules_blocks(jframe_blocks(iter(_engine_words()), RB),
                                     jparse_rules(ENGINE_RULES), on_batch=_log(jlog),
                                     skip=skip)
        teng = tm.M22000Engine(_engine_lines(), batch_size=RB, device=CPU)
        tf = teng.crack_rules_streams(frame_blocks(iter(_engine_words()), RB),
                                      parse_rules(ENGINE_RULES), on_batch=_log(tlog),
                                      skip=skip, devices=[CPU] * NSTREAMS)
        assert _keys(tf) == _keys(jf) and len(tf) == 3
        assert tlog == jlog
        assert len(teng.nets) == len(jeng.nets) == 1
    assert _stream_threads() == []


def test_real_stream_crash_requeues_to_survivor():
    """A real stream engine that raises on its third dispatched block:
    that block is requeued to the other stream, and the founds and the
    on_batch sequence equal the lockstep run's (ten blocks: JAX's five
    and five more of junk; the survivor is slowed so the crashing stream
    takes its three blocks first)."""
    jkeys, _, _ = _jax_lockstep()
    words = _words() + [b"stjunk%04d" % i for i in range(160, 320)]
    lock_log = []
    lock = tm.M22000Engine(_lines(tfx), batch_size=BATCH, device=CPU).crack_blocks(
        frame_blocks(iter(words), BATCH), on_batch=_log(lock_log))
    parent = tm.M22000Engine(_lines(tfx), batch_size=BATCH, device=CPU)
    made = []

    class Crashing(tm.M22000Engine):
        calls = 0

        def _dispatch(self, prep):
            self.calls += 1
            if self.calls == 3:
                raise RuntimeError("injected stream fault")
            return super()._dispatch(prep)

    class Slow(tm.M22000Engine):
        def _prepare_block(self, block, stager=None):
            time.sleep(0.05)
            return super()._prepare_block(block, stager)

    def factory(device):
        cls = Crashing if not made else Slow
        made.append(cls([n.line for n in parent.nets], batch_size=BATCH, device=device))
        return made[-1]

    log = []
    founds = parent.crack_streams(frame_blocks(iter(words), BATCH), on_batch=_log(log),
                                  devices=[CPU, CPU], engine_factory=factory)
    assert made[0].calls == 3
    assert _keys(founds) == _keys(lock) == jkeys
    assert log == lock_log and len(log) == 10
    assert _stream_threads() == []


# ---------------------------------------------------------------------------
# fault injection (fake engines — no device work)
# ---------------------------------------------------------------------------


class _FakeNet:
    def __init__(self, line):
        self.line = line


class _FakeEngine:
    """The slice of the engine surface DeviceStream touches."""

    PIPELINE_DEPTH = 3

    def __init__(self, lines, fail_offsets=()):
        self.nets = [_FakeNet(ln) for ln in lines]
        self.groups = {b"X": list(self.nets)}
        self.fail_offsets = set(fail_offsets)
        self.seen = []

    def _prepare_block(self, block):
        return block

    def _dispatch(self, prep):
        if prep.offset in self.fail_offsets:
            raise RuntimeError(f"injected fault at {prep.offset}")
        return prep

    def _collect(self, disp):
        self.seen.append(disp.offset)
        return []

    def remove(self, found):
        self.nets = [n for n in self.nets if n.line is not found.line]


def _fake_blocks(k, batch=32):
    return [types.SimpleNamespace(offset=i * batch, count=batch) for i in range(k)]


def _fake_devices(k):
    return [types.SimpleNamespace(platform="fake", id=i) for i in range(k)]


def test_stream_crash_requeues_to_survivor():
    """Stream 0 dies mid-run: its unfinished blocks go back to the queue
    with stream 0 excluded, the survivor completes them, demux order and
    counts are unchanged, and no stream thread leaks."""
    lines = [object(), object()]
    engines = {}

    def factory(device):
        fail = (64,) if device.id == 0 else ()
        engines[device.id] = _FakeEngine(lines, fail_offsets=fail)
        return engines[device.id]

    ex = StreamExecutor(factory, _fake_devices(2))
    log = []
    assert ex.run(iter(_fake_blocks(6)), on_batch=lambda c, f: log.append(c)) == []
    assert log == [32] * 6
    assert len(ex.block_streams) == 6 and ex.block_streams[2] == 1
    assert 64 in engines[1].seen and 64 not in engines[0].seen
    assert _stream_threads() == []


def test_stream_crash_out_of_streams_is_fatal():
    """With a single stream there is no survivor: the run surfaces a
    StreamError carrying the failed block's global offset and joins every
    thread."""
    ex = StreamExecutor(lambda d: _FakeEngine([object()], fail_offsets=(0,)),
                        _fake_devices(1))
    with pytest.raises(StreamError) as err:
        ex.run(iter(_fake_blocks(6)))
    assert err.value.offset == 0 and "injected fault" in str(err.value)
    assert _stream_threads() == []


def test_stream_crash_everywhere_exhausts_attempts():
    """A block that fails on EVERY stream runs out of eligible streams and
    aborts instead of cycling the queue forever."""
    ex = StreamExecutor(lambda d: _FakeEngine([object()], fail_offsets=(0,)),
                        _fake_devices(2), max_attempts=5)
    with pytest.raises(StreamError) as err:
        ex.run(iter(_fake_blocks(1)))
    assert err.value.offset == 0
    assert _stream_threads() == []


def test_stream_feed_error_propagates():
    """A feeder exception aborts the run with the ORIGINAL exception type
    — the client's retry layer keys off it."""
    class _Boom(Exception):
        pass

    def feed():
        yield from _fake_blocks(2)
        raise _Boom("source died")

    ex = StreamExecutor(lambda d: _FakeEngine([object()]), _fake_devices(2))
    with pytest.raises(_Boom):
        ex.run(feed())
    assert _stream_threads() == []


def test_stream_found_dedup_and_cross_stream_prune():
    """Every block claims the same net: the demux reports it once (first
    block in global order wins) and the prune lands on the stream's engine
    at a later block boundary, on the stream's own thread."""
    line = object()
    removed_on = []

    class _Hit:
        def __init__(self):
            self.line = line

    class _HitEngine(_FakeEngine):
        def _collect(self, disp):
            super()._collect(disp)
            if disp.offset > 0:
                time.sleep(0.05)  # let the emitter push block 0's prune
            return [_Hit()]

        def remove(self, found):
            removed_on.append(threading.current_thread().name)
            super().remove(found)

    engines = {}

    def factory(device):
        engines[device.id] = _HitEngine([line])
        return engines[device.id]

    ex = StreamExecutor(factory, _fake_devices(1))
    founds = ex.run(iter(_fake_blocks(4)))
    assert len(founds) == 1
    assert engines[0].nets == []
    assert removed_on and all(n.startswith("stream-") for n in removed_on)
    assert _stream_threads() == []


def test_stream_executor_stress_keeps_order_and_counts():
    """More streams than cores under a short switch interval: every block
    is collected exactly once, the demux reports them in sequence order,
    and every thread exits."""
    import sys

    engines = []

    def factory(device):
        engines.append(_FakeEngine([object()]))
        return engines[-1]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ex = StreamExecutor(factory, _fake_devices(16), queue_depth=5)
        log = []
        ex.run(iter(_fake_blocks(300, batch=7)), on_batch=lambda c, f: log.append(c))
    finally:
        sys.setswitchinterval(old)
    assert log == [7] * 300 and len(ex.block_streams) == 300
    seen = sorted(o for e in engines for o in e.seen)
    assert seen == [i * 7 for i in range(300)]
    assert _stream_threads() == []


# ---------------------------------------------------------------------------
# the executor's stream waves
# ---------------------------------------------------------------------------


def _wave_units(pkg_unit, fx, sizes):
    return [pkg_unit(uid=i, lines=[fx.make_pmkid_line(b"wavepass%03d" % i, b"WaveNet%d" % i,
                                                       seed=f"wv{i}")],
                     words=[b"wavejunk%05d" % j for j in range(n)] + [b"wavepass%03d" % i])
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_stream_bundles_match_jax(ndev):
    """``_stream_bundles`` cuts the same wave into the same bundles as
    JAX's, for every device count."""
    sizes = [5, 40, 3, 70, 12, 1, 33, 8, 2]

    def bundles(exec_cls, unit_cls, fx, **kw):
        units = _wave_units(unit_cls, fx, sizes)
        for u in units:
            u._materialized = list(u.words)
        ex = exec_cls([], batch_size=BATCH, fuse_max_units=3, **kw)
        return [[u.uid for u in b] for b in ex._stream_bundles(units, BATCH, ndev)]

    got = bundles(MultiUnitExecutor, WorkUnit, tfx, device=CPU)
    assert got == bundles(JMultiUnitExecutor, JWorkUnit, jtfx, mesh=None)
    assert sorted(u for b in got for u in b) == list(range(len(sizes)))


def test_stream_wave_matches_lockstep_wave(monkeypatch):
    """A wave scattered over two stream devices (both the CPU here)
    cracks every unit exactly as the lockstep wave does, in threads named
    ``sched-stream-*`` that all exit."""
    def run(streams):
        units = _wave_units(WorkUnit, tfx, [5, 40, 3, 12])
        ex = MultiUnitExecutor(units, batch_size=BATCH, device=CPU, streams=streams)
        monkeypatch.setattr(ex, "_stream_devices", lambda: [CPU, CPU])
        seen = []
        real = ex._run_wave_streams
        monkeypatch.setattr(ex, "_run_wave_streams",
                            lambda w, b: (seen.append(len(w)), real(w, b))[1])
        done = ex.run()
        return seen, sorted((u.uid, u.consumed, [f.psk for f in u.founds]) for u in done)

    seen_on, on = run(True)
    seen_off, off = run(False)
    assert seen_on and not seen_off
    assert on == off and all(psks for _, _, psks in on)
    assert _stream_threads() == []


def test_streams_file_clean_under_dw110_as_jax():
    """DW110 polices ``dwpa_tpu/parallel/streams.py`` by name; the port's
    file linted under that name has no DW110 finding."""
    from dwpa_tpu.analysis.linter import lint_source

    src = Path(__file__).resolve().parents[1] / "dwpa_tpu_torch" / "parallel" / "streams.py"
    found = [v for v in lint_source(src.read_text(), "dwpa_tpu/parallel/streams.py")
             if v.code == "DW110"]
    assert found == []

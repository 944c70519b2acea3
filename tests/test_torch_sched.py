"""Mixed-ESSID unit fusion in the port against ``dwpa_tpu.sched`` and the
JAX engine's fused path, on seeded inputs, exact.

Each test named like one in ``tests/test_sched.py`` holds the same
behaviour here:

- the packer (``sched.fuse``): the static width table, ``pack_salted_lanes``
  and ``fuse_units`` field by field against the JAX package at ``n = 1``
  (cold, with store hits from a store written by either package, all-hit);
- the per-lane-salt PBKDF2 entries (``pmk_kernel``, ``fused_pmk_step``)
  against hashlib and the JAX package's ``fused_pmk_step`` at reduced
  iterations;
- the engine's ``crack_fused`` against the JAX engine's on a one-device
  mesh (founds, ``Found`` fields, ``on_batch`` events and the fused
  batches themselves), with hashlib PMKs (``hashlib_pmk``) in the port;
- the executor (``sched.executor``) and the client's ``fused_executor``.

Every engine here runs at ``BATCH = 32`` with words of at most 15 bytes,
so the JAX side compiles one fused width and one column trim.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch
from torch_fixtures import hashlib_pmk
from torch_jax_refs import jax_xla_pmk

from dwpa_tpu import pmkstore as jps
from dwpa_tpu import sched as jsched
from dwpa_tpu import testing as jtfx
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.parallel import step as jstep
from dwpa_tpu_torch import pmkstore as tps
from dwpa_tpu_torch import sched as tsched
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry, SpanTracer
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.parallel.step import fused_pmk_step
from dwpa_tpu_torch.sched import MultiUnitExecutor, WorkUnit
from dwpa_tpu_torch.utils import bytesops as bo

BATCH = 32
PLAIN_PMK = tm._pmk_impl  # the plain torch PBKDF2 on a CPU tensor


@pytest.fixture(autouse=True)
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


def _jax_engine(lines, **kw):
    return jm.M22000Engine(lines, batch_size=BATCH, mesh=default_mesh(n=1), **kw)


def _engine(lines, **kw):
    return tm.M22000Engine(lines, batch_size=BATCH, device="cpu", **kw)


def _key(f):
    return (f.line.essid, f.psk, f.nc, f.endian, f.pmk)


def _events(log):
    return [(k, c, sorted(map(_key, fs))) for k, c, fs in log]


def _fb_fields(fb):
    """A ``FusedBatch`` as comparable plain values (arrays as uint32 bytes
    with shape and dtype)."""
    def arr(a):
        return None if a is None else (a.dtype.str, a.shape, np.ascontiguousarray(a).tobytes())

    return ((fb.width, fb.miss_width, fb.nmiss, fb.total, fb.fill),
            tuple(arr(getattr(fb, f)) for f in ("miss_rows", "miss_lens", "unit_id",
                                                "table1", "table2", "idx", "cached")),
            [(u.key, u.lo, u.nvalid, u.words, u.count, u.mlo, u.nmiss, u.miss_words)
             for u in fb.units])


# ---------------------------------------------------------------------------
# per-lane salt PBKDF2
# ---------------------------------------------------------------------------


def test_per_lane_salt_kernel_matches_hashlib():
    """Lane b's PMK must be PBKDF2(pw_b, essid_b): ``pmk_kernel`` with
    [B, 16] salts on the plain PBKDF2 at 3 iterations."""
    essids = [b"LaneNetA", b"LaneNetB"]
    pws = [b"perlanepw%02d" % i for i in range(8)]
    lane_essid = [essids[i % 2] for i in range(8)]
    s1, s2 = tm.essid_salt_lanes(lane_essid)
    pmk = to_numpy(tm.pmk_kernel(*(to_torch(a, "cpu") for a in (
        bo.pack_passwords_be(pws)[:, :4], s1, s2)), iterations=3))
    for i in range(8):
        ref = hashlib.pbkdf2_hmac("sha1", pws[i], lane_essid[i], 3, 32)
        assert bo.words_to_bytes_be(pmk[:, i]) == ref


def test_scalar_salt_fast_path_unchanged():
    """int32[16] salts agree with the per-lane mode when every lane
    shares one ESSID."""
    pws = [b"scalarpw%02d" % i for i in range(8)]
    rows = to_torch(bo.pack_passwords_be(pws)[:, :4], "cpu")
    a, b = tm.essid_salt_blocks(b"ScalarNet")
    s1, s2 = tm.essid_salt_lanes([b"ScalarNet"] * 8)
    scalar = tm.pmk_kernel(rows, to_torch(a, "cpu"), to_torch(b, "cpu"), iterations=2)
    lanes = tm.pmk_kernel(rows, to_torch(s1, "cpu"), to_torch(s2, "cpu"), iterations=2)
    assert torch.equal(scalar, lanes)


def _fused_step_batch():
    rng = np.random.default_rng(61)
    parts = [(b"FusedStepNet%d" % u,
              [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
               for k in rng.integers(8, 16, n)], n)
             for u, n in enumerate((9, 3, 12))]
    return tsched.fuse_units(parts, BATCH, 1, max_units=4)


def test_fused_pmk_step_matches_jax():
    """The port's fused step against the JAX package's ``fused_pmk_step``
    on a one-device mesh, over a fused batch of three units: the PMKs
    derived through the port's salt gather (hashlib PBKDF2) equal JAX's,
    lane for lane, each under its own unit's ESSID."""
    fb = _fused_step_batch()
    ref = np.asarray(jstep.fused_pmk_step(default_mesh(n=1))(
        fb.miss_rows, fb.unit_id, fb.table1, fb.table2))
    got = fused_pmk_step(*(to_torch(a, "cpu") for a in (
        np.ascontiguousarray(fb.miss_rows[:, :4]), fb.unit_id, fb.table1, fb.table2)))
    np.testing.assert_array_equal(to_numpy(got), ref)
    for u in fb.units:
        for i, word in enumerate(u.words):
            assert bo.words_to_bytes_be(ref[:, u.lo + i]) == hashlib.pbkdf2_hmac(
                "sha1", word, u.key, 4096, 32)


@pytest.mark.parametrize("w", [4, 8, 16])
def test_fused_pmk_step_plain_pbkdf2_matches_jax_xla(monkeypatch, w):
    """The port's fused step on its plain PBKDF2 at 2 iterations against
    the JAX package's XLA PBKDF2 on the same per-lane salts."""
    monkeypatch.setattr(tm, "_pmk_impl", PLAIN_PMK)
    fb = _fused_step_batch()
    got = fused_pmk_step(*(to_torch(a, "cpu") for a in (
        np.ascontiguousarray(fb.miss_rows[:, :w]), fb.unit_id, fb.table1, fb.table2)),
        iterations=2)
    ref = jax_xla_pmk(fb.miss_rows, fb.table1[fb.unit_id], fb.table2[fb.unit_id], 2)
    np.testing.assert_array_equal(to_numpy(got), ref)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8])
def test_fused_widths_bounded_and_mesh_aligned(n):
    for batch in (8, 32, 64, 4096, 16384, 131072):
        widths = tsched.fused_widths(batch, n)
        assert widths == jsched.fused_widths(batch, n)
        assert 1 <= len(widths) <= 3
        assert widths[-1] == batch
        assert all(w % n == 0 and w > 0 for w in widths)
        for total in (0, 1, n, batch // 2, batch // 2 + 1, batch):
            w = tsched.fused_width(batch, n, total)
            assert w == jsched.fused_width(batch, n, total)
            assert w in widths and w >= total
    assert tsched.fused_widths(131072, 1) == (16384, 65536, 131072)


def test_pack_salted_lanes_matches_jax():
    from dwpa_tpu.sched.fuse import pack_salted_lanes as jpack

    from dwpa_tpu_torch.sched.fuse import pack_salted_lanes

    rng = np.random.default_rng(5)
    for n_pairs in (1, 3, 5, 17, 32):
        pairs = [(b"SaltNet%d" % rng.integers(0, 4),
                  bytes(rng.integers(33, 127, int(rng.integers(8, 64)), dtype=np.uint8)))
                 for _ in range(n_pairs)]
        got, ref = pack_salted_lanes(pairs, BATCH, 1), jpack(pairs, BATCH, 1)
        assert got[3] == ref[3] == n_pairs
        for a, b in zip(got[:3], ref[:3]):
            assert a.dtype == b.dtype == np.uint32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pack_salted_lanes([], BATCH, 1)
    with pytest.raises(ValueError):
        pack_salted_lanes([(b"x", b"password")] * (BATCH + 1), BATCH, 1)


def test_fuse_units_layout_and_fill():
    parts = [(b"FuseA", [b"alphaword%02d" % i for i in range(5)], 5),
             (b"FuseB", [b"betaword%03d" % i for i in range(3)], 3)]
    fb = tsched.fuse_units(parts, BATCH, 1, max_units=4)
    assert fb.total == 8 and fb.width == tsched.fused_width(BATCH, 1, 8) == 16
    assert fb.nmiss == 8 and fb.idx is None  # no store: all-miss layout
    assert [u.lo for u in fb.units] == [0, 5]
    assert fb.fill == 8 / fb.width
    assert list(fb.unit_id[:8]) == [0] * 5 + [1] * 3
    s1a, _ = tm.essid_salt_blocks(b"FuseA")
    s1b, _ = tm.essid_salt_blocks(b"FuseB")
    np.testing.assert_array_equal(fb.table1[0], s1a)
    np.testing.assert_array_equal(fb.table1[1], s1b)
    np.testing.assert_array_equal(fb.table1[2], s1a)
    assert fb.table1.shape == (4, 16)
    assert _fb_fields(fb) == _fb_fields(jsched.fuse_units(parts, BATCH, 1, max_units=4))


def _store_parts():
    """Three units with $HEX, short (filtered) and repeated words."""
    rng = np.random.default_rng(17)
    parts = []
    for u in range(3):
        words = [b"storeunit%d-%03d" % (u, i) for i in range(int(rng.integers(4, 9)))]
        words.insert(2, b"short")
        words.append(b"$HEX[" + (b"hexword%d" % u).hex().encode() + b"]")
        parts.append((b"FuseStore%d" % u, words, len(words)))
    return parts


def _seed_store(pkg, root, parts, pick):
    st = pkg.PMKStore(str(root), registry=MetricsRegistry())
    for key, words, _ in parts:
        chosen = [w for i, w in enumerate(words) if pick(i) and w != b"short"
                  and not w.startswith(b"$HEX")]
        st.put(key, chosen, [hashlib.pbkdf2_hmac("sha1", w, key, 4096, 32) for w in chosen])
    st.close()


@pytest.mark.parametrize("case", ["cold", "hits-jax-store", "hits-torch-store", "all-hit"])
def test_fuse_units_matches_jax(tmp_path, case):
    """``fuse_units`` field by field against the JAX package's at n = 1,
    with each package reading the same store directory."""
    parts = _store_parts()
    jstore = tstore = None
    if case != "cold":
        writer = jps if case == "hits-jax-store" else tps
        _seed_store(writer, tmp_path, parts,
                    (lambda i: True) if case == "all-hit" else (lambda i: i % 3 == 1))
        if case == "all-hit":  # the $HEX words too, under their decoded bytes
            st = tps.PMKStore(str(tmp_path), registry=MetricsRegistry())
            for key, _, _ in parts:
                w = b"hexword" + key[-1:]
                st.put(key, [w], [hashlib.pbkdf2_hmac("sha1", w, key, 4096, 32)])
            st.close()
        jstore = jps.PMKStore(str(tmp_path), registry=MetricsRegistry())
        tstore = tps.PMKStore(str(tmp_path), registry=MetricsRegistry())
    salts = {parts[1][0]: tm.essid_salt_blocks(parts[1][0])}
    got = tsched.fuse_units(parts, BATCH, 1, max_units=4, store=tstore, salts=salts)
    ref = jsched.fuse_units(parts, BATCH, 1, max_units=4, store=jstore, salts=salts)
    assert _fb_fields(got) == _fb_fields(ref)
    if case == "cold":
        assert got.idx is None and got.cached is None and got.nmiss == got.total
    elif case == "all-hit":
        assert got.nmiss == 0 and got.cached is not None
    else:
        assert 0 < got.nmiss < got.total and got.idx is not None
    for bad in ([], parts * 2, parts[:1] * 2):
        with pytest.raises(ValueError):
            tsched.fuse_units(bad, BATCH, 1, max_units=4)


# ---------------------------------------------------------------------------
# engine: fused vs serial and vs the JAX engine, demux, resume
# ---------------------------------------------------------------------------


def _mixed_units(pkg):
    psks = [b"fusedpass-A1", b"fusedpass-B2", b"fusedpass-C3", b"fusedpass-D4"]
    essids = [b"MixNetA", b"MixNetB", b"MixNetC", b"MixNetD"]
    lines = [
        pkg.make_pmkid_line(psks[0], essids[0], seed="mx-a"),
        pkg.make_eapol_line(psks[1], essids[1], keyver=2, seed="mx-b"),
        pkg.make_eapol_line(psks[2], essids[2], keyver=3, seed="mx-c"),
        pkg.make_eapol_line(psks[3], essids[3], keyver=1, nc_delta=2, endian="LE",
                            seed="mx-d"),
    ]
    units = [(e, [b"mixjunk%d%03d" % (i, j) for j in range(6)] + [p])
             for i, (e, p) in enumerate(zip(essids, psks))]
    return lines, units, psks


def test_fused_matches_serial_mixed_keyvers_and_essids():
    """Mixed keyvers (PMKID, keyver 1 with a nonce correction, 2, 3) and
    ESSIDs in one fused batch: the port's founds, ``Found`` fields,
    ``on_batch`` events and fused batches equal the JAX engine's, and the
    port's founds equal its serial per-unit path's."""
    lines, units, psks = _mixed_units(tfx)
    jlines, junits, _ = _mixed_units(jtfx)
    assert lines == jlines and units == junits
    got_ev, ref_ev, got_fb, ref_fb = [], [], [], []
    fused = _engine(lines).crack_fused(
        units, on_batch=lambda k, c, f: got_ev.append((k, c, f)), on_fused=got_fb.append)
    ref = _jax_engine(jlines).crack_fused(
        junits, on_batch=lambda k, c, f: ref_ev.append((k, c, f)), on_fused=ref_fb.append)
    assert sorted(map(_key, fused)) == sorted(map(_key, ref))
    assert _events(got_ev) == _events(ref_ev)
    assert [_fb_fields(f) for f in got_fb] == [_fb_fields(f) for f in ref_fb]
    serial = []
    for (essid, words), line in zip(units, lines):
        serial += _engine([line]).crack(words)
    assert sorted(map(_key, fused)) == sorted(map(_key, serial))
    assert sorted(f.psk for f in fused) == sorted(psks)
    assert {f.nc for f in fused} == {0, 2}
    assert sorted((k, c) for k, c, _ in got_ev) == sorted((e, len(w)) for e, w in units)


def _demux(pkg, engine):
    shared = b"shared-secret"
    la = pkg.make_pmkid_line(shared, b"DemuxA", seed="dm-a")
    lb = pkg.make_pmkid_line(b"other-pass-b9", b"DemuxB", seed="dm-b")
    by_unit = {}
    founds = engine([la, lb]).crack_fused(
        [(b"DemuxA", [b"demuxjunk%03d" % i for i in range(8)] + [shared]),
         (b"DemuxB", [shared] + [b"demuxjunk%03d" % i for i in range(8)])],
        on_batch=lambda k, c, f: by_unit.setdefault(k, []).extend(map(_key, f)))
    return list(map(_key, founds)), by_unit


def test_found_demux_no_cross_unit_leak():
    """The password that cracks unit A's net also rides in unit B: the
    hit surfaces under unit A only, as in the JAX engine."""
    got = _demux(tfx, _engine)
    assert got == _demux(jtfx, _jax_engine)
    founds, by_unit = got
    assert [f[1] for f in founds] == [b"shared-secret"] and founds[0][0] == b"DemuxA"
    assert [f[0] for f in by_unit[b"DemuxA"]] == [b"DemuxA"]
    assert by_unit[b"DemuxB"] == []


def _attribution(pkg, engine):
    pw = b"both-nets-pass"
    la = pkg.make_pmkid_line(pw, b"AttrA", seed="at-a")
    lb = pkg.make_eapol_line(pw, b"AttrB", keyver=2, seed="at-b")
    by_unit = {}
    founds = engine([la, lb]).crack_fused(
        [(b"AttrA", [pw] + [b"attrjunk%03d" % i for i in range(9)]),
         (b"AttrB", [b"attrjunk%03d" % i for i in range(9)] + [pw])],
        on_batch=lambda k, c, f: by_unit.setdefault(k, []).extend(map(_key, f)))
    return sorted(map(_key, founds)), by_unit


def test_same_password_two_units_each_attributed():
    """One password cracks both units' nets: each unit's ``on_batch`` gets
    exactly its own net's find, as in the JAX engine."""
    got = _attribution(tfx, _engine)
    assert got == _attribution(jtfx, _jax_engine)
    founds, by_unit = got
    assert len(founds) == 2
    assert [f[0] for f in by_unit[b"AttrA"]] == [b"AttrA"]
    assert [f[0] for f in by_unit[b"AttrB"]] == [b"AttrB"]


def test_fused_flushes_chunks_and_consumes_dead_units():
    """The flush rules against the JAX engine: an oversize part splits
    into engine-sized chunks, a repeated pending ESSID and ``max_units``
    flush early, an unknown ESSID and an all-invalid unit are consumed
    with their counts, and every fused batch is the JAX engine's."""
    essids = [b"FlushA", b"FlushB", b"FlushC"]
    psk = b"flush-psk-c3"

    def run(pkg, engine):
        lines = [pkg.make_pmkid_line(b"not-in-keyspace", essids[0], seed="fl-a"),
                 pkg.make_pmkid_line(b"not-in-keyspace", essids[1], seed="fl-b"),
                 pkg.make_pmkid_line(psk, essids[2], seed="fl-c")]
        parts = [(essids[1], [b"short%d" % i for i in range(3)]),
                 (essids[1], [b"flushbee%03d" % i for i in range(5)]),
                 (essids[0], [b"flushword%03d" % i for i in range(70)], 75),
                 (b"UnknownNet", [b"unknownwd%03d" % i for i in range(4)]),
                 (essids[2], [b"flushsee%03d" % i for i in range(3)] + [psk])]
        ev, fbs = [], []
        founds = engine(lines).crack_fused(
            parts, max_units=2, on_batch=lambda k, c, f: ev.append((k, c, f)),
            on_fused=fbs.append)
        return sorted(map(_key, founds)), _events(ev), [_fb_fields(f) for f in fbs]

    got = run(tfx, _engine)
    assert got == run(jtfx, _jax_engine)
    founds, events, fbs = got
    assert [f[1] for f in founds] == [psk]
    assert (b"UnknownNet", 4, []) in events
    assert events[0] == (essids[1], 3, [])  # the all-invalid batch, not dispatched
    assert sum(c for k, c, _ in events if k == essids[0]) == 75
    assert [f[0][:4] for f in fbs] == [(4, 4, 0, 0), (16, 16, 5, 5), (32, 32, 32, 32),
                                       (32, 32, 32, 32), (16, 16, 10, 10)]


def test_fused_all_hit_batch_launches_no_pbkdf2(tmp_path, monkeypatch):
    """A fused batch whose every lane is a store hit runs no PBKDF2; a
    batch with some hits mixes through ``mix_step``; the write-back goes
    through ``put_many``, and the founds equal the JAX engine's."""
    lines, units, psks = _mixed_units(tfx)
    jlines, junits, _ = _mixed_units(jtfx)

    def run(store, engine, ln, un):
        return sorted(map(_key, engine(ln, pmk_store=store).crack_fused(un)))

    store = tps.PMKStore(str(tmp_path / "t"), registry=MetricsRegistry())
    jstore = jps.PMKStore(str(tmp_path / "j"), registry=MetricsRegistry())
    rows = []
    monkeypatch.setattr(tm, "_pmk_impl", lambda pw, *a: (
        rows.append(pw.shape[0]), hashlib_pmk(pw, *a))[1])
    puts = []
    real = store.put_many
    store.put_many = lambda items: (puts.append(1), real(items))[1]
    cold = run(store, _engine, lines, units)
    assert cold == run(jstore, _jax_engine, jlines, junits)
    assert rows == [BATCH] and puts == [1]
    assert sorted(f[1] for f in cold) == sorted(psks)
    # warm: every lane a hit
    del rows[:]
    assert run(store, _engine, lines, units) == cold == run(jstore, _jax_engine, jlines, junits)
    assert rows == []
    # half warm: three new words in place of three cached ones per unit
    half = [(e, [b"newjunk%d%03d" % (i, j) for j in range(3)] + w[3:])
            for i, (e, w) in enumerate(units)]
    assert run(store, _engine, lines, half) == cold
    assert rows == [16]


def test_resume_skip_equivalence_under_fusion():
    """A unit resumed at skip=k through the executor covers exactly the
    serial path's unskipped tail, as through the JAX executor."""
    psk = b"resume-fused-1"
    words = [b"resumew%04d" % i for i in range(29)] + [psk]
    skip = 9

    def run(pkg, sched, **kw):
        line = pkg.make_pmkid_line(psk, b"ResumeNet", seed="rs")
        ex = sched.MultiUnitExecutor(
            [sched.WorkUnit(uid=0, lines=[line], words=iter(words), skip=skip)],
            batch_size=BATCH, **kw)
        done = ex.run()
        return [(u.uid, u.consumed, [_key(f) for f in u.founds]) for u in done]

    got = run(tfx, tsched, device="cpu")
    assert got == run(jtfx, jsched, mesh=default_mesh(n=1), streams=False)
    assert got[0][1] == len(words) and [f[1] for f in got[0][2]] == [psk]
    line = tfx.make_pmkid_line(psk, b"ResumeNet", seed="rs")
    assert [f.psk for f in _engine([line]).crack(words[skip:])] == [psk]


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _units(k, prefix=b"ExNet", nwords=6):
    out = []
    for i in range(k):
        psk = b"expass%03d" % i
        line = tfx.make_pmkid_line(psk, prefix + b"%d" % i, seed=f"ex{i}")
        words = [b"exwords%d%03d" % (i, j) for j in range(nwords)] + [psk]
        out.append(WorkUnit(uid=i, lines=[line], words=words))
    return out


def test_executor_metrics_and_spans():
    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    ex = MultiUnitExecutor(_units(3), batch_size=BATCH, unit_queue=3,
                           fuse_max_units=4, registry=reg, tracer=tracer, device="cpu")
    done = ex.run()
    assert len(done) == 3 and all(len(u.founds) == 1 for u in done)
    assert reg.value("dwpa_fused_units_per_batch") >= 1  # histogram count
    assert 0.0 < reg.value("dwpa_fused_fill_fraction") <= 1.0
    assert reg.value("dwpa_unit_queue_depth") is not None
    names = {r["name"] for r in tracer.records()}
    assert {"sched:fuse", "sched:demux"} <= names


def test_executor_essid_collision_defers_to_next_wave():
    """Two units over the SAME ESSID cannot share a salt-table row; the
    second waits one wave and both still complete."""
    psk1 = b"collide-one1"
    line = tfx.make_pmkid_line(psk1, b"CollideNet", seed="co")
    u1 = WorkUnit(uid=1, lines=[line], words=[psk1, b"cjunkcjunk1"])
    u2 = WorkUnit(uid=2, lines=[line], words=[b"cjunkcjunk2", psk1])
    u3 = WorkUnit(uid=3, lines=[tfx.make_pmkid_line(b"third-pass3", b"ThirdNet", seed="t3")],
                  words=[b"third-pass3"])
    waves = []
    ex = MultiUnitExecutor([u1, u2, u3], batch_size=BATCH, fuse_max_units=4, device="cpu",
                           engine_factory=lambda lines, bs: waves.append(len(lines))
                           or _engine(lines))
    done = ex.run()
    assert {u.uid for u in done} == {1, 2, 3}
    assert len(waves) >= 2  # the collider ran in a wave of its own
    assert sum(len(u.founds) for u in done if u.uid in (1, 2)) >= 1
    assert all(u.consumed == 2 for u in done if u.uid in (1, 2))


@pytest.mark.parametrize("error", [RuntimeError, torch.cuda.OutOfMemoryError])
def test_executor_retry_halves_batch_then_requeues(error):
    """A raising wave retries once at half batch; persistent failure
    requeues with backoff until max_retries, then the unit lands in
    ``failed``.  A CUDA out-of-memory error takes the same road."""
    units = _units(1)
    attempts = []

    class _Boom:
        def crack_fused(self, *a, **k):
            raise error("injected device error")

    def factory(lines, batch_size):
        attempts.append(batch_size)
        return _Boom()

    reg = MetricsRegistry()
    slept = []
    ex = MultiUnitExecutor(units, batch_size=BATCH, registry=reg, device="cpu",
                           engine_factory=factory, max_retries=2,
                           backoff_s=0.5, sleep=slept.append)
    done = ex.run()
    assert done == [] and ex.failed == units
    assert attempts == [BATCH, BATCH // 2] * 3
    assert slept == [0.5, 1.0]
    assert reg.value("dwpa_fused_retries_total") == 3


def test_executor_recovers_on_transient_error():
    """One transient failure: the half-batch retry completes the wave
    and the units still crack; an error that is not a RuntimeError is
    not swallowed."""
    units = _units(2)
    state = {"raised": False}

    class _Boom:
        def __init__(self, err):
            self.err = err

        def crack_fused(self, *a, **k):
            raise self.err

    def factory(lines, batch_size):
        if not state["raised"]:
            state["raised"] = True
            return _Boom(RuntimeError("transient"))
        return _engine(lines)

    ex = MultiUnitExecutor(units, batch_size=BATCH, engine_factory=factory, device="cpu")
    done = ex.run()
    assert len(done) == 2 and all(len(u.founds) == 1 for u in done)
    assert ex.failed == []
    ex = MultiUnitExecutor(_units(1), batch_size=BATCH, device="cpu",
                           engine_factory=lambda *a: _Boom(ValueError("a bug")))
    with pytest.raises(ValueError, match="a bug"):
        ex.run()


def test_executor_producer_error_reaches_run():
    def units():
        yield from _units(1)
        raise OSError("fetch failed")

    ex = MultiUnitExecutor(units(), batch_size=BATCH, device="cpu")
    with pytest.raises(OSError, match="fetch failed"):
        ex.run()
    assert len(ex.done) == 1


def test_executor_streams_refused_on_several_cards(monkeypatch):
    """``streams=True`` with more than one CUDA device raises (per-device
    streams are not ported); with one it runs lockstep."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="slice 6"):
        MultiUnitExecutor([], streams=True, device="cpu")
    MultiUnitExecutor([], streams="auto", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert len(MultiUnitExecutor(_units(2), batch_size=BATCH, streams=True,
                                 device="cpu").run()) == 2
    with pytest.raises(ValueError):
        MultiUnitExecutor([], streams="on", device="cpu")


def test_executor_rules_unit_runs_alone():
    """A rules unit rides a singleton wave through ``crack_rules_blocks``;
    ``consumed`` counts expanded candidates."""
    from dwpa_tpu_torch.rules import parse_rules

    psk = b"rulebase99"
    line = tfx.make_pmkid_line(psk.upper(), b"RulesNet", seed="ru")
    ru = WorkUnit(uid="r", lines=[line], words=[b"rulejunk1", psk, b"rulejunk2"],
                  rules=parse_rules([":", "u"]))
    waves = []
    ex = MultiUnitExecutor([ru] + _units(2), batch_size=BATCH, device="cpu",
                           engine_factory=lambda lines, bs: waves.append(len(lines))
                           or _engine(lines))
    done = {u.uid: u for u in ex.run()}
    assert [f.psk for f in done["r"].founds] == [psk.upper()]
    assert done["r"].consumed == 6
    assert waves[0] == 1 and len(done) == 3


def test_executor_leaves_no_orphan_threads():
    def _sched_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("sched-") and t.is_alive()]

    psk = b"orphan-check-1"
    line = tfx.make_pmkid_line(psk, b"OrphanNet", seed="oc")
    units = [WorkUnit(uid=i, lines=[line], words=[b"w%07d" % i, psk]) for i in range(3)]
    ex = MultiUnitExecutor(units, batch_size=BATCH, unit_queue=2, device="cpu")
    assert len(ex.run()) == 3
    deadline = time.time() + 10.0
    while _sched_threads() and time.time() < deadline:
        for t in _sched_threads():
            t.join(timeout=0.2)
    assert _sched_threads() == []


# ---------------------------------------------------------------------------
# client and CLI
# ---------------------------------------------------------------------------


def test_client_fused_executor_runs_two_unit_stream(tmp_path):
    """``fused_executor`` is bound to the client's device, batch, queue,
    registry and store; the fusion metrics are registered at zero before
    the first wave."""
    from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient

    reg = MetricsRegistry()
    cfg = ClientConfig(base_url="http://unused/", workdir=str(tmp_path / "w"),
                       batch_size=BATCH, device="cpu", unit_queue=2, fuse_max_units=4,
                       pmk_cache_dir=str(tmp_path / "store"))
    client = TpuCrackClient(cfg, api=object(), log=lambda *a: None, registry=reg)
    scrape = reg.render_prometheus()
    for name, kind in (("dwpa_fused_units_per_batch", "histogram"),
                       ("dwpa_fused_fill_fraction", "gauge"),
                       ("dwpa_unit_queue_depth", "gauge")):
        assert f"# TYPE {name} {kind}" in scrape
    ex = client.fused_executor(_units(2))
    assert (ex.device, ex.batch_size, ex.unit_queue, ex.fuse_max_units, ex.pmk_store) == (
        client.device, BATCH, 2, 4, client.pmk_store)
    done = ex.run()
    assert sorted(u.uid for u in done) == [0, 1]
    assert all([f.psk for f in u.founds] == [b"expass%03d" % u.uid] for u in done)
    assert reg.value("dwpa_fused_units_per_batch") == 1
    assert client.pmk_store.lookup(b"ExNet0", [b"expass000"]) == [
        hashlib.pbkdf2_hmac("sha1", b"expass000", b"ExNet0", 4096, 32)]


def test_client_cli_fusion_flags(monkeypatch):
    """``--unit-queue`` / ``--fuse-max-units`` reach ``ClientConfig`` with
    the JAX client's defaults, instead of exiting 2."""
    from dwpa_tpu.client.__main__ import build_parser as jbuild_parser

    from dwpa_tpu_torch.client import __main__ as cli

    seen = []

    class Recorder:
        def __init__(self, cfg):
            seen.append(cfg)

        def run(self):
            return 0

    monkeypatch.setattr(cli, "TpuCrackClient", Recorder)
    cli.main(["--url", "http://s/", "--device", "cpu", "--unit-queue", "2",
              "--fuse-max-units", "4"])
    cli.main(["--url", "http://s/", "--device", "cpu"])
    ref = jbuild_parser().parse_args(["http://s/"])
    assert [(c.unit_queue, c.fuse_max_units) for c in seen] == [
        (2, 4), (ref.unit_queue, ref.fuse_max_units)] == [(2, 4), (4, 8)]

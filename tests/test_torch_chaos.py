"""The port's chaos harness (``dwpa_tpu_torch.chaos``) against
``dwpa_tpu.chaos``, and the port's client and server under it.

- ``FaultPlan``, ``DbFaultPlan`` and ``FsFaultInjector``: the same seed
  and call sequence give the same schedule in both packages; forced
  faults, validation and ``ChaosTransport``'s kinds behave alike.
- ``dbfault.install`` on the port's ``server/db.Database``: injection
  and uninstall, a mid-transaction rollback, a crash at every statement
  boundary of get_work/put_work (the same statement count as the JAX
  server), ``sweep_invariants`` on damage.
- The port's ``ServerAPI`` over ``WsgiTransport(make_wsgi_app(core))``
  of the port's server: 4xx fails fast, 5xx/429/503 retry with the
  Retry-After floor, garbage goes permanent, the circuit opens and a
  probe closes it.
- The port's ``TpuCrackClient`` on ``device="cpu"`` with hashlib PMKs
  (``tests/torch_fixtures.hashlib_pmk``): degraded mode with a dead
  put path, and a short seeded soak whose founds, rows and resume state
  equal the fault-free run's, its schedule replayed by JAX's plan.

These mirror ``tests/test_chaos.py`` and ``tests/test_server_chaos.py``.
"""

import gzip
import hashlib
import json
import os
import random
import sqlite3
import urllib.error

import pytest
from torch_fixtures import hashlib_pmk

from dwpa_tpu import chaos as jchaos
from dwpa_tpu_torch import chaos as tchaos
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.chaos import (ChaosTransport, DbFaultPlan, FaultPlan,
                                  SimulatedCrash, VirtualClock, WsgiTransport,
                                  install_db_faults, sweep_invariants)
from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
from dwpa_tpu_torch.client.protocol import (CircuitBreaker, CircuitOpenError,
                                            NoNets, PermanentError, ServerAPI)
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app

PACKAGES = {"torch": tchaos, "jax": jchaos}
PSK = b"chaos-psk-001"
ESSID = b"ChaosNet"
STORM_PSKS = [b"storm-psk-%02d" % i for i in range(8)]


@pytest.fixture(autouse=True)
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


def _core(nets=4, dicts=2, **kw):
    core = ServerCore(Database(":memory:"), **kw)
    for i in range(nets):
        core.add_hashlines([tfx.make_pmkid_line(STORM_PSKS[i % len(STORM_PSKS)],
                                                b"StormNet%d" % i, seed=f"st{i}")])
    core.db.x("UPDATE nets SET algo = ''")
    for i in range(dicts):
        core.add_dict(f"dict/st{i}.txt.gz", f"st{i}", "0" * 32, 10 + i)
    return core


def _api(app, plan=None, clock=None, **kw):
    """The port's ServerAPI over the in-process WSGI app at the
    ``_transport`` seam: classification, backoff and the breaker run."""
    clock = clock if clock is not None else VirtualClock()
    kw.setdefault("max_tries", 0)
    kw.setdefault("backoff", 0.5)
    kw.setdefault("rng", random.Random(11))
    kw.setdefault("sleep", clock.sleep)
    kw.setdefault("breaker", CircuitBreaker(threshold=3, cooldown=4.0, clock=clock.now))
    api = ServerAPI("http://loopback/", **kw)
    api.retry.clock = clock.now
    wsgi = WsgiTransport(app)
    api._transport = wsgi if plan is None else ChaosTransport(wsgi, plan, sleep=clock.sleep)
    return api, wsgi, clock


# -- the plans: same seed, same schedule in both packages -----------------


@pytest.mark.parametrize("seed,rate,kinds", [
    (42, 0.5, None), (43, 0.5, None), (20260805, 0.10, ("drop", "timeout", "http_5xx", "slow")),
    (7, 1.0, ("http_429", "reject")),
])
def test_fault_plan_schedule_matches_jax(seed, rate, kinds):
    endpoints = ["get_work", "put_work", "download", "get_work", "prdict"] * 20
    kw = {} if kinds is None else {"kinds": kinds}
    plans = {pkg: mod.FaultPlan(seed, rate=rate, **kw).force("put_work", "truncate")
             for pkg, mod in PACKAGES.items()}
    for plan in plans.values():
        for ep in endpoints:
            plan.next_fault(ep)
    assert plans["torch"].schedule() == plans["jax"].schedule()
    assert plans["torch"].kinds_injected() == plans["jax"].kinds_injected()
    assert "truncate" in plans["torch"].kinds_injected()
    assert tchaos.FAULT_KINDS == jchaos.FAULT_KINDS


@pytest.mark.parametrize("seed,rate", [(1234, 0.2), (4321, 0.2), (9, 0.6)])
def test_db_fault_plan_schedule_matches_jax(seed, rate):
    verbs = ["select", "insert", "update", "begin", "commit"] * 40
    plans = {pkg: mod.DbFaultPlan(seed, rate=rate).force("insert", "crash").force_at(17, "disk_io")
             for pkg, mod in PACKAGES.items()}
    for plan in plans.values():
        for v in verbs:
            plan.next_fault(v)
    assert plans["torch"].schedule() == plans["jax"].schedule()
    assert {"crash", "disk_io"} <= plans["torch"].kinds_injected()
    assert tchaos.DB_FAULT_KINDS == jchaos.DB_FAULT_KINDS


def test_fs_fault_injector_matches_jax(tmp_path):
    logs = {}
    for pkg, mod in PACKAGES.items():
        path = tmp_path / f"{pkg}.bin"
        path.write_bytes(bytes(range(256)) * 4)
        inj = mod.FsFaultInjector(99)
        for _ in range(5):
            inj.tear(str(path), max_bytes=40)
            inj.flip(str(path))
        logs[pkg] = ([(op, arg) for op, _, arg in inj.log], path.read_bytes())
    assert logs["torch"] == logs["jax"]
    p = tmp_path / "torch.bin"
    assert tchaos.flip_byte(str(p), -1) == p.stat().st_size - 1
    assert tchaos.tear_tail(str(p), 10 ** 9) == len(logs["torch"][1])
    assert p.stat().st_size == 0
    with pytest.raises(ValueError, match="empty"):
        tchaos.FsFaultInjector(1).flip(str(p))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_plans_force_fifo_and_validation(pkg):
    mod = PACKAGES[pkg]
    plan = mod.FaultPlan(0).force("get_work", "timeout").force("get_work", "http_5xx")
    assert plan.next_fault("put_work") is None
    assert [plan.next_fault("get_work") for _ in range(3)] == ["timeout", "http_5xx", None]
    with pytest.raises(ValueError):
        plan.force("get_work", "nonsense")
    db = mod.DbFaultPlan(0).force("insert", "op_error").force("insert", "crash")
    assert db.next_fault("select") is None
    assert [db.next_fault("insert") for _ in range(3)] == ["op_error", "crash", None]
    db.force_at(6, "disk_io")
    assert [db.next_fault("update") for _ in range(3)] == [None, None, "disk_io"]
    assert db.kinds_injected() == {"op_error", "crash", "disk_io"}
    with pytest.raises(ValueError):
        db.force("insert", "meteor")
    with pytest.raises(ValueError):
        db.force_at(0, "meteor")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_chaos_transport_kinds(pkg):
    mod = PACKAGES[pkg]
    calls = []

    def inner(url, body=None, headers=None):
        calls.append(url)
        return b'{"some": "body"}'

    url = "http://x/?get_work=2.2.0"
    slept = []
    plan = mod.FaultPlan(0)
    t = mod.ChaosTransport(inner, plan, sleep=slept.append, slow_s=0.25)
    for kind, exc in (("drop", ConnectionResetError), ("timeout", TimeoutError),
                      ("http_4xx", urllib.error.HTTPError), ("http_429", urllib.error.HTTPError),
                      ("http_5xx", urllib.error.HTTPError)):
        plan.force("get_work", kind)
        with pytest.raises(exc):
            t(url)
    assert calls == []
    plan.force("get_work", "truncate")
    assert t(url) == b'{"some": "body"}'[:8]
    plan.force("get_work", "garbage")
    assert t(url) == b"\x00chaos{not-json"
    plan.force("get_work", "reject")
    assert t(url) == b"chaos: rejected"
    plan.force("get_work", "slow")
    assert t(url) == b'{"some": "body"}' and slept == [0.25]
    assert t(url) == b'{"some": "body"}' and len(calls) == 5
    assert [e for _, e, _ in plan.schedule()] == ["get_work"] * 10


# -- database faults on the port's server ---------------------------------


def test_install_injects_and_uninstalls():
    core = _core()
    plan = DbFaultPlan(0)
    uninstall = install_db_faults(core.db, plan)
    plan.force("select", "op_error")
    with pytest.raises(sqlite3.OperationalError, match="locked"):
        core.db.q("SELECT * FROM nets")
    plan.force("select", "disk_io")
    with pytest.raises(sqlite3.OperationalError, match="disk I/O"):
        core.db.q("SELECT * FROM nets")
    assert core.db.q1("SELECT COUNT(*) c FROM nets")["c"] == 4
    uninstall()
    core.db.q("SELECT * FROM nets")
    assert len(plan.schedule()) == 3


def test_mid_transaction_fault_rolls_back_whole_unit():
    core = _core(nets=2, dicts=2)
    plan = DbFaultPlan(0)
    uninstall = install_db_faults(core.db, plan)
    plan.force("insert", "disk_io")   # the first INSERT: the leases row
    with pytest.raises(sqlite3.OperationalError):
        core.get_work(2)
    uninstall()
    assert core.db.q1("SELECT COUNT(*) c FROM leases")["c"] == 0
    assert core.db.q1("SELECT COUNT(*) c FROM n2d")["c"] == 0
    assert sweep_invariants(core.db) == []
    assert core.get_work(1) is not None


def _get_then_put(core):
    w = core.get_work(1)
    if w is not None:
        core.put_work({"hkey": w["hkey"], "epoch": w["epoch"],
                       "cand": [{"k": "%012x" % 0, "v": "00"}]})


def test_crash_at_every_statement_boundary_like_jax():
    """Crash the port's core before each statement of get_work + put_work;
    every reopened ledger passes the sweep, and the op sequence runs the
    JAX server's statements, verb for verb."""
    from dwpa_tpu import testing as jtfx
    from dwpa_tpu.server import Database as JDatabase
    from dwpa_tpu.server import ServerCore as JServerCore

    verbs = {}
    for pkg, (Core, Db, fx) in {"torch": (ServerCore, Database, tfx),
                                "jax": (JServerCore, JDatabase, jtfx)}.items():
        core = Core(Db(":memory:"))
        for i in range(2):
            core.add_hashlines([fx.make_pmkid_line(STORM_PSKS[i], b"StormNet%d" % i,
                                                   seed=f"st{i}")])
        core.db.x("UPDATE nets SET algo = ''")
        for i in range(2):
            core.add_dict(f"dict/st{i}.txt.gz", f"st{i}", "0" * 32, 10 + i)
        counter = PACKAGES[pkg].DbFaultPlan(0)
        uninstall = PACKAGES[pkg].install_db_faults(core.db, counter)
        _get_then_put(core)
        uninstall()
        verbs[pkg] = [v for _, v, _ in counter.schedule()]
    assert verbs["torch"] == verbs["jax"] and len(verbs["torch"]) > 10

    for at in range(len(verbs["torch"])):
        core = _core(nets=2, dicts=2)
        uninstall = install_db_faults(core.db, DbFaultPlan(0).force_at(at, "crash"))
        try:
            _get_then_put(core)
        except SimulatedCrash:
            pass
        uninstall()
        assert sweep_invariants(core.db) == [], at
        core.get_work(1)
        assert sweep_invariants(core.db) == [], at


def test_sweep_invariants_detects_damage():
    core = _core(nets=2, dicts=1)
    w = core.get_work(1)
    assert sweep_invariants(core.db) == []
    core.db.x("DELETE FROM leases WHERE hkey = ?", (w["hkey"],))
    assert any("orphan in-flight" in b for b in sweep_invariants(core.db))
    core.db.x("DELETE FROM n2d")
    core.db.x("INSERT INTO leases(hkey, epoch, issued) VALUES ('h0', 9, 1)")
    assert any("hollow live lease" in b for b in sweep_invariants(core.db))
    core.db.x("DELETE FROM leases")
    core.db.x("UPDATE nets SET n_state = 1")
    core.db.x("INSERT INTO n2d(net_id, d_id) SELECT net_id, 1 FROM nets LIMIT 1")
    assert any("cracked net" in b for b in sweep_invariants(core.db))


# -- the transport stack against the port's server ------------------------


def test_http_4xx_fails_fast():
    def no_sleep(_):
        raise AssertionError("slept on a 4xx: a permanent error was retried")

    api, wsgi, _ = _api(make_wsgi_app(_core(nets=0, dicts=0)), sleep=no_sleep)
    with pytest.raises(PermanentError):
        api.fetch("http://loopback/no/such/path")
    assert len(wsgi.requests) == 1 and not api.circuit_open


def test_http_5xx_retries_then_succeeds():
    plan = FaultPlan(0).force("get_work", "http_5xx").force("get_work", "http_5xx")
    api, wsgi, clock = _api(make_wsgi_app(_core(nets=0, dicts=0)), plan=plan)
    reg = MetricsRegistry()
    api.bind_obs(reg)
    with pytest.raises(NoNets):
        api.get_work(1)
    assert len(wsgi.requests) == 1
    assert reg.value("dwpa_client_retries_total", endpoint="get_work", reason="http_5xx") == 2
    assert clock.now() > 0


def test_get_work_garbage_goes_permanent():
    plan = FaultPlan(0)
    for _ in range(8):
        plan.force("get_work", "garbage")
    api, wsgi, _ = _api(make_wsgi_app(_core(nets=0, dicts=0)), plan=plan)
    with pytest.raises(PermanentError, match="malformed get_work"):
        api.get_work(1)
    assert len(wsgi.requests) == api.validation_retries + 1


def test_circuit_opens_then_probe_recovers():
    api, _, clock = _api(make_wsgi_app(_core(nets=0, dicts=0)))
    reg = MetricsRegistry()
    api.bind_obs(reg)
    live = api._transport

    def down(url, body=None, headers=None):
        raise ConnectionRefusedError("chaos: down")

    api._transport = down
    with pytest.raises(CircuitOpenError):
        api.fetch(api._endpoint("get_work=2.2.0"), max_tries=10)
    assert api.circuit_open and reg.value("dwpa_client_circuit_state") == CircuitBreaker.OPEN
    with pytest.raises(CircuitOpenError):
        api.fetch(api._endpoint("get_work=2.2.0"), max_tries=2)
    clock.sleep(api.breaker.cooldown)
    api._transport = live
    with pytest.raises(NoNets):
        api.get_work(1)
    assert not api.circuit_open
    assert reg.value("dwpa_client_circuit_state") == CircuitBreaker.CLOSED


def test_http_429_admission_and_chaos_kind_honour_retry_after():
    core = _core(nets=2, dicts=1)
    core.max_inflight = 1
    api, _, clock = _api(make_wsgi_app(core), backoff=0.01,
                         breaker=CircuitBreaker(threshold=50, cooldown=1.0))
    w1 = api.get_work(1)
    released = {}

    def sleeper(seconds):
        clock.sleep(seconds)
        if not released:
            released["done"] = True
            core.put_work({"hkey": w1["hkey"], "epoch": w1["epoch"], "cand": []})

    api.sleep = sleeper
    t0 = clock.now()
    w2 = api.get_work(1)
    assert w2 is not None and w2["hkey"] != w1["hkey"]
    assert clock.now() - t0 >= 2.0
    assert sweep_invariants(core.db) == []

    plan = FaultPlan(3).force("get_work", "http_429")
    api, _, clock = _api(make_wsgi_app(_core(nets=1, dicts=1)), plan=plan, backoff=0.01)
    assert api.get_work(1) is not None
    assert clock.now() >= 2.0 and plan.kinds_injected() == {"http_429"}


def test_http_503_on_db_contention():
    core = _core(nets=1, dicts=1)
    api, _, clock = _api(make_wsgi_app(core), backoff=0.01)
    plan = DbFaultPlan(0).force("begin", "op_error")
    uninstall = install_db_faults(core.db, plan)
    w = api.get_work(1)
    uninstall()
    assert w is not None and clock.now() >= 2.0
    assert "op_error" in plan.kinds_injected()


# -- the port's client under faults ---------------------------------------


def _server(tmp_path, sub, lines, words):
    core = ServerCore(Database(":memory:"), dictdir=str(tmp_path / sub / "dicts"),
                      capdir=str(tmp_path / sub / "caps"))
    core.add_hashlines(lines)
    core.db.x("UPDATE nets SET algo = ''")
    os.makedirs(core.dictdir, exist_ok=True)
    blob = gzip.compress(b"\n".join(words) + b"\n", mtime=0)
    with open(os.path.join(core.dictdir, "chaos.txt.gz"), "wb") as f:
        f.write(blob)
    core.add_dict("dict/chaos.txt.gz", "chaos.txt.gz", hashlib.md5(blob).hexdigest(),
                  len(words), rules=None)
    return core


def _client(core, workdir, plan, clock, **cfg_kw):
    cfg_kw.setdefault("batch_size", 64)
    cfg = ClientConfig(base_url="http://loopback/", workdir=str(workdir), dictcount=1,
                       device="cpu", **cfg_kw)
    api, wsgi, _ = _api(make_wsgi_app(core), plan=plan, clock=clock)
    return TpuCrackClient(cfg, api=api, log=lambda *a, **k: None), wsgi


def test_degraded_mode_cracks_buffered_units(tmp_path):
    """The put path dead: both prefetched units crack, their finds wait in
    the outbox, and the drain delivers them once the server is back."""
    psk_a, psk_b = b"chaos-psk-00A", b"chaos-psk-00B"
    core = _server(tmp_path, "s", [tfx.make_pmkid_line(psk_a, b"ChaosNetA", seed="dgA"),
                                   tfx.make_pmkid_line(psk_b, b"ChaosNetB", seed="dgB")],
                   [b"nope-000001", psk_a, psk_b])
    plan = FaultPlan(5)
    for _ in range(3):
        plan.force("put_work", "drop")
    clock = VirtualClock()
    client, _ = _client(core, tmp_path / "w", plan, clock, prefetch_units=1, max_work_units=2)
    assert client.run() == 2
    assert client.api.circuit_open and client.outbox.pending_count() == 2
    assert core.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1")["c"] == 0
    clock.sleep(client.api.breaker.cooldown)
    client._drain_outbox()
    assert client.outbox.pending_count() == 0 and not client.api.circuit_open
    rows = core.db.q('SELECT n_state, "pass" FROM nets')
    assert sorted(r["pass"] for r in rows) == [psk_a, psk_b]
    assert all(r["n_state"] == 1 for r in rows)


def test_chaos_soak_matches_fault_free_run(tmp_path):
    """A work unit under a seeded fault schedule (timeouts, 5xx, a torn
    put_work reply, a reject, a mid-unit restart) ends with the founds,
    ``nets`` rows and cleared resume state of the fault-free run; JAX's
    plan replays the same schedule from the same seed."""
    seed = 20260805
    lines = [tfx.make_pmkid_line(PSK, ESSID, seed="cs1"),
             tfx.make_eapol_line(PSK, ESSID, keyver=2, seed="cs2")]
    words = [b"nope-%06d" % i for i in range(60)] + [PSK]

    def state(core):
        return sorted((r["n_state"], r["pass"]) for r in core.db.q('SELECT n_state, "pass" FROM nets'))

    core0 = _server(tmp_path, "s0", lines, words)
    client0, _ = _client(core0, tmp_path / "w0", FaultPlan(seed), VirtualClock())
    res0 = client0.process_work(client0.api.get_work(1))
    assert res0.accepted and sorted(f.psk for f in res0.founds) == [PSK, PSK]

    def make_plan(mod):
        return (mod.FaultPlan(seed, rate=0.10, kinds=("drop", "timeout", "http_5xx", "slow"))
                .force("get_work", "timeout").force("get_work", "http_5xx")
                .force("put_work", "truncate").force("put_work", "reject"))

    core1 = _server(tmp_path, "s1", lines, words)
    plan, clock = make_plan(tchaos), VirtualClock()
    client1, _ = _client(core1, tmp_path / "w1", plan, clock)
    work1 = client1.api.get_work(1)
    client1._write_resume(work1)
    client2, _ = _client(core1, tmp_path / "w1", plan, clock)
    replayed = client2._read_resume()
    assert replayed == work1
    res1 = client2.process_work(replayed)
    assert sorted(f.psk for f in res1.founds) == sorted(f.psk for f in res0.founds)
    for _ in range(10):
        if not client2.outbox.pending_count():
            break
        clock.sleep(client2.api.breaker.cooldown)
        try:
            client2._drain_outbox()
        except ConnectionError:
            continue
    assert client2.outbox.pending_count() == 0
    assert state(core1) == state(core0)
    assert core1.db.q1("SELECT COUNT(*) c FROM nets")["c"] == len(lines)
    assert core1.db.q1("SELECT COUNT(*) c FROM n2d WHERE hkey = ?", (replayed["hkey"],))["c"] == 0
    assert sweep_invariants(core1.db) == []
    assert not os.path.exists(client0.resume_path) and not os.path.exists(client2.resume_path)
    assert {"timeout", "http_5xx", "truncate", "reject"} <= plan.kinds_injected()
    for mod in (tchaos, jchaos):
        replay = make_plan(mod)
        for _, endpoint, _ in plan.schedule():
            replay.next_fault(endpoint)
        assert replay.schedule() == plan.schedule()


def test_wsgi_transport_raises_http_errors_with_headers():
    """An overloaded port server's 429 comes out of ``WsgiTransport`` as
    the HTTPError the urllib hop raises, Retry-After included, as JAX's
    transport gives it for the JAX server."""
    from dwpa_tpu import testing as jtfx
    from dwpa_tpu.server import Database as JDatabase
    from dwpa_tpu.server import ServerCore as JServerCore
    from dwpa_tpu.server import make_wsgi_app as jmake_wsgi_app

    got = {}
    for pkg, (Core, Db, fx, make_app) in {
            "torch": (ServerCore, Database, tfx, make_wsgi_app),
            "jax": (JServerCore, JDatabase, jtfx, jmake_wsgi_app)}.items():
        core = Core(Db(":memory:"), max_inflight=1)
        core.add_hashlines([fx.make_pmkid_line(PSK, b"Net%d" % i, seed=f"w{i}") for i in range(2)])
        core.db.x("UPDATE nets SET algo = ''")
        core.add_dict("dict/w.txt.gz", "w", "0" * 32, 10)
        wsgi = PACKAGES[pkg].WsgiTransport(make_app(core))
        url, body = "http://loopback/?get_work=2.2.0", b'{"dictcount": 1}'
        first = wsgi(url, body, {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            wsgi(url, body, {"Content-Type": "application/json"})
        got[pkg] = (sorted(json.loads(first)), e.value.code, e.value.headers.get("Retry-After"),
                    e.value.fp.read(), wsgi.requests)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 429 and got["torch"][2]


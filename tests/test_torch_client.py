"""The port's volunteer client against ``dwpa_tpu.server`` over loopback
(and, for the full and the rules round trip, against the port's own
``dwpa_tpu_torch.server`` too).

``TpuCrackClient`` of ``dwpa_tpu_torch`` talks to ``make_wsgi_app``
entirely in-process: a subclass of the port's ``ServerAPI`` whose
``fetch`` invokes the WSGI app directly, so challenge gate, get_work,
dict download + md5 check, the two-pass crack, put_work, resume replay
and autotune run over the exact wire protocol with no sockets.  These
mirror ``tests/test_client_loopback.py``.

The CPU cases crack on ``device="cpu"`` with hashlib PMKs
(``hashlib_pmk``), as the port's other engine-level CPU tests do; the
``gpu`` case runs the round trip on ``cuda:0`` with the real kernel.
"""

import base64
import gzip
import hashlib
import io
import json
import os
import urllib.parse

import pytest
import torch
from torch_fixtures import cuda_device, hashlib_pmk  # noqa: F401  (a fixture)

from dwpa_tpu import testing as jtfx
from dwpa_tpu.client.main import ClientConfig as JClientConfig
from dwpa_tpu.client.main import TpuCrackClient as JTpuCrackClient
from dwpa_tpu.client.protocol import ServerAPI as JServerAPI
from dwpa_tpu.feed import RulesFeedSource as JRulesFeedSource
from dwpa_tpu.rules import parse_rules as jparse_rules
from dwpa_tpu.server import Database, ServerCore, make_wsgi_app
from dwpa_tpu_torch.client import main as cm
from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
from dwpa_tpu_torch.client.protocol import ServerAPI
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda
from dwpa_tpu_torch.rules import parse_rules
from dwpa_tpu_torch.server import Database as TDatabase
from dwpa_tpu_torch.server import ServerCore as TServerCore
from dwpa_tpu_torch.server import make_wsgi_app as tmake_wsgi_app

PSK = b"loopback-psk1"
ESSID = b"LoopbackNet"


def wsgi_fetch(api, url, data):
    parsed = urllib.parse.urlparse(url)
    body = json.dumps(data).encode() if data is not None else b""
    environ = {
        "REQUEST_METHOD": "POST" if data is not None else "GET",
        "PATH_INFO": parsed.path or "/",
        "QUERY_STRING": parsed.query,
        "CONTENT_LENGTH": str(len(body)),
        "wsgi.input": io.BytesIO(body),
        "REMOTE_ADDR": "127.0.0.1",
    }
    out = {}

    def start_response(status, headers):
        out["status"] = status

    resp = b"".join(api.app(environ, start_response))
    api.requests.append((environ["REQUEST_METHOD"], url))
    if not out["status"].startswith("200"):
        raise ConnectionError(f"{url}: {out['status']}")
    return resp


class LoopbackAPI(ServerAPI):
    """The port's ServerAPI with a direct WSGI call as transport (both
    seams: ``fetch``, and ``_transport``, which the version probe uses),
    so nothing ever opens a socket."""

    def __init__(self, app, **kw):
        kw.setdefault("max_tries", 1)
        kw.setdefault("sleep", lambda s: None)
        super().__init__("http://loopback/", **kw)
        self.app = app
        self.requests = []

    def fetch(self, url: str, data: dict = None, max_tries: int = None) -> bytes:
        return wsgi_fetch(self, url, data)

    def _transport(self, url, body=None, headers=None):
        return wsgi_fetch(self, url, json.loads(body) if body else None)


class JLoopbackAPI(JServerAPI):
    def __init__(self, app):
        super().__init__("http://loopback/", max_tries=1, sleep=lambda s: None)
        self.app = app
        self.requests = []

    def fetch(self, url: str, data: dict = None, max_tries: int = None) -> bytes:
        return wsgi_fetch(self, url, data)

    def _transport(self, url, body=None, headers=None):
        return wsgi_fetch(self, url, json.loads(body) if body else None)


class Stop(Exception):
    """Raised by a test's ``api.sleep`` to end ``run``'s idle loop."""


@pytest.fixture(autouse=True)
def _hashlib_pmks(request, monkeypatch):
    if request.node.get_closest_marker("gpu") is None:
        monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


@pytest.fixture
def server(tmp_path):
    return ServerCore(Database(":memory:"), dictdir=str(tmp_path / "dicts"),
                      capdir=str(tmp_path / "caps"))


@pytest.fixture(params=["jax", "torch"])
def any_server(request, tmp_path):
    """A server of either package: the JAX reference or the port's own."""
    Core, Db = {"jax": (ServerCore, Database), "torch": (TServerCore, TDatabase)}[request.param]
    return Core(Db(":memory:"), dictdir=str(tmp_path / "dicts"),
                capdir=str(tmp_path / "caps"))


def _add_dict(core, words, name="loop.txt.gz", rules=None):
    os.makedirs(core.dictdir, exist_ok=True)
    blob = gzip.compress(b"\n".join(words) + b"\n")
    path = os.path.join(core.dictdir, name)
    with open(path, "wb") as f:
        f.write(blob)
    dhash = hashlib.md5(blob).hexdigest()
    core.add_dict(f"dict/{name}", name, dhash, len(words), rules=rules)
    return path, dhash


def _ingest(core, lines):
    core.add_hashlines(lines)
    core.db.x("UPDATE nets SET algo = ''")  # release to volunteers


def _client(server, tmp_path, registry=None, workdir="work", **cfg_kw):
    cfg_kw.setdefault("batch_size", 64)
    cfg_kw.setdefault("dictcount", 1)
    cfg_kw.setdefault("device", "cpu")
    cfg = ClientConfig(base_url="http://loopback/",
                       workdir=str(tmp_path / workdir), **cfg_kw)
    make_app = tmake_wsgi_app if isinstance(server, TServerCore) else make_wsgi_app
    api = LoopbackAPI(make_app(server))
    return TpuCrackClient(cfg, api=api, log=lambda *a, **k: None,
                          registry=registry)


def test_full_round_trip(any_server, tmp_path):
    """get_work -> crack -> put_work: the net ends cracked server-side,
    the potfile records the found, and the lease is closed."""
    server = any_server
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="rt1"),
                     jtfx.make_eapol_line(PSK, ESSID, keyver=2, seed="rt2")])
    _add_dict(server, [b"nope-000001", PSK, b"nope-000002"])
    reg = MetricsRegistry()
    client = _client(server, tmp_path, registry=reg)

    assert client.challenge()
    work = client.api.get_work(client.dictcount)
    assert len(work["hashes"]) == 2
    res = client.process_work(work)

    assert res.accepted
    assert sorted(f.psk for f in res.founds) == [PSK, PSK]
    rows = server.db.q("SELECT n_state, pass FROM nets")
    assert all(r["n_state"] == 1 and r["pass"] == PSK for r in rows)
    assert server.db.q1("SELECT COUNT(*) c FROM n2d WHERE hkey IS NOT NULL")["c"] == 0
    assert PSK.decode() in open(client.potfile).read()
    assert not os.path.exists(client.resume_path)
    assert client.outbox.pending_count() == 0
    # telemetry: transport counters, pass-2 rate, feed blocks of both
    # passes and of prewarm, stage times of the unit
    assert reg.value("dwpa_client_requests_total", endpoint="put_work") == 1
    assert reg.value("dwpa_client_requests_total", endpoint="dict_download") == 1
    assert reg.value("dwpa_client_pmk_per_s", **{"pass": "2"}) > 0
    for feed in ("prewarm", "pass1", "pass2"):
        assert reg.value("dwpa_feed_blocks_total", feed=feed) >= 1, feed
    assert reg.value("dwpa_feed_blocks_total", feed="prewarm") == 3
    assert set(res.stage_times) == {"prepare", "dispatch", "collect"}
    assert "dwpa_client_recompiles_total" in reg.render_prometheus()


def test_run_loop_with_challenge_gate(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="rl1")])
    _add_dict(server, [PSK])
    client = _client(server, tmp_path, max_work_units=1)
    assert client.run() == 1
    assert server.db.q1("SELECT n_state FROM nets")["n_state"] == 1


def test_challenge_gate_failure_exits(server, tmp_path, monkeypatch):
    client = _client(server, tmp_path)
    monkeypatch.setattr(cm, "challenge", lambda **kw: False)
    with pytest.raises(SystemExit):
        client.run()
    assert not any("get_work" in u for _, u in client.api.requests)


def test_resume_replay_after_crash(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="rr1")])
    _add_dict(server, [PSK])
    crashed = _client(server, tmp_path)
    work = crashed.api.get_work(1)
    crashed._write_resume(work)  # simulated crash: resume left behind

    revived = _client(server, tmp_path)

    def fail_get_work(dictcount):
        raise AssertionError("must replay the resume, not fetch new work")

    revived.api.get_work = fail_get_work
    replayed = revived._read_resume()
    assert replayed == work
    res = revived.process_work(replayed)
    assert res.accepted
    assert not os.path.exists(revived.resume_path)


def test_corrupt_resume_discarded(server, tmp_path):
    client = _client(server, tmp_path)
    with open(client.resume_path, "w") as f:
        f.write("{not json")
    assert client._read_resume() is None
    assert not os.path.exists(client.resume_path)


def test_resume_rejected_on_batch_size_or_package_change(server, tmp_path):
    """A resume written under a different -b, or by the JAX client, must
    restart the unit, not skip-by-count."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="bs1")])
    _add_dict(server, [PSK])
    crashed = _client(server, tmp_path, batch_size=64)
    work = crashed.api.get_work(1)
    work["_progress"] = {"done": 37, "cand": []}
    crashed._write_resume(work)
    assert (work["_batch"], work["_nproc"], work["_ver"]) == (64, 1, cm.RESUME_VERSION)

    revived = _client(server, tmp_path, batch_size=32)
    assert revived._read_resume() is None
    assert not os.path.exists(revived.resume_path)

    crashed._write_resume(work)
    same = _client(server, tmp_path, batch_size=64)
    assert same._read_resume() == work

    # the JAX client's checkpoint in the same workdir is never replayed
    jclient = JTpuCrackClient(
        JClientConfig(base_url="http://loopback/", workdir=str(tmp_path / "work"),
                      batch_size=64),
        api=JLoopbackAPI(make_wsgi_app(server)), log=lambda *a, **k: None)
    jclient._write_resume(dict(work))
    assert same._read_resume() is None


def test_intra_unit_checkpoint_written(server, tmp_path, monkeypatch):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="ck1")])
    words = [b"filler-%06d" % i for i in range(40)] + [PSK]
    _add_dict(server, words)
    client = _client(server, tmp_path, batch_size=16)
    snapshots = []
    real_write = client._write_resume
    monkeypatch.setattr(
        client, "_write_resume",
        lambda work: (snapshots.append(json.loads(json.dumps(work))), real_write(work))[1])
    work = client.api.get_work(client.dictcount)
    res = client.process_work(work)
    assert res.accepted and [f.psk for f in res.founds] == [PSK]
    dones = [s["_progress"]["done"] for s in snapshots if "_progress" in s]
    assert dones and dones == sorted(dones) and dones[-1] >= len(words)
    assert any(s["_progress"]["cand"] for s in snapshots if "_progress" in s)


def test_checkpoint_span_per_batch(server, tmp_path, monkeypatch):
    """Each batch's resume checkpoint is one ``client:checkpoint`` span
    inside its pass, beside the engine's spans of the same pass."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="cs1")])
    _add_dict(server, [b"filler-%06d" % i for i in range(40)] + [PSK])
    client = _client(server, tmp_path, batch_size=16)
    writes = []
    real_write = client._write_resume
    monkeypatch.setattr(client, "_write_resume",
                        lambda work: (writes.append(1), real_write(work))[1])
    res = client.process_work(client.api.get_work(client.dictcount))
    assert res.accepted
    checkpoints = client.tracer.records("client:checkpoint")
    # the unit's first write is its snapshot as read, before any batch
    assert len(checkpoints) == len(writes) - 1 >= 3
    assert {r["parent"] for r in checkpoints} == {"pass1", "pass2"}
    collects = client.tracer.records("engine:collect")
    assert len(collects) == len(checkpoints)
    assert {r["parent"] for r in collects} == {"pass1", "pass2"}
    assert res.stage_times["collect"] == sum(r["t1"] - r["t0"] for r in collects)


def test_resume_skips_done_and_resubmits_founds(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="ck2")])
    from dwpa_tpu.server.db import long2mac

    mac = long2mac(server.db.q1("SELECT bssid FROM nets")["bssid"])
    _add_dict(server, [PSK] + [b"filler-%06d" % i for i in range(40)])
    reg = MetricsRegistry()
    client = _client(server, tmp_path, batch_size=16, registry=reg)
    work = client.api.get_work(client.dictcount)
    work["_progress"] = {"done": 10 ** 6, "cand": [{"k": mac.hex(), "v": PSK.hex()}]}
    res = client.process_work(work)
    assert res.candidates_tried == 0 and res.founds == []
    assert res.accepted
    assert reg.value("dwpa_client_resume_skipped_total") == 10 ** 6
    row = server.db.q1("SELECT n_state, pass FROM nets")
    assert row["n_state"] == 1 and row["pass"] == PSK


class Crash(Exception):
    pass


def test_crash_mid_pass2_and_resume(server, tmp_path):
    """A client killed after its 4th pass-2 checkpoint: a fresh client on
    the same workdir replays the unit, skips exactly the checkpointed
    count, still finds the PSK, and is accepted."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="cr1")])
    _add_dict(server, [b"filler-%06d" % i for i in range(200)] + [PSK])
    crashed = _client(server, tmp_path, batch_size=16)
    work = crashed.api.get_work(1)
    pass1 = len(list(crashed._pass1_candidates(work, [], [])))
    real_write = crashed._write_resume
    pass2_checkpoints = []

    def write_then_crash(w):
        real_write(w)
        done = w.get("_progress", {}).get("done", 0)
        if done > pass1:
            pass2_checkpoints.append(done)
            if len(pass2_checkpoints) == 4:
                raise Crash

    crashed._write_resume = write_then_crash
    with pytest.raises(Crash):
        crashed.process_work(work)
    checkpointed = json.load(open(crashed.resume_path))["_progress"]["done"]
    assert checkpointed == pass1 + 4 * 16

    reg = MetricsRegistry()
    revived = _client(server, tmp_path, batch_size=16, registry=reg, max_work_units=1)
    revived.api.get_work = lambda *a, **k: pytest.fail("must replay the resume")
    assert revived.run() == 1
    assert reg.value("dwpa_client_resume_skipped_total") == checkpointed
    assert revived.last_result.accepted
    assert [f.psk for f in revived.last_result.founds] == [PSK]
    assert server.db.q1("SELECT n_state FROM nets")["n_state"] == 1


def test_outbox_exactly_once_after_kill_before_put_work(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="xo1")])
    _add_dict(server, [PSK])
    client = _client(server, tmp_path)
    work = client.api.get_work(1)

    def killed(hkey, cand, max_tries=None, epoch=None):
        raise ConnectionError("killed between crack and put_work")

    client.api.put_work = killed
    res = client.process_work(work)
    assert not res.accepted and [f.psk for f in res.founds] == [PSK]
    assert client.outbox.pending_count() == 1
    assert server.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1")["c"] == 0

    revived = _client(server, tmp_path)
    assert revived.outbox.pending_count() == 1
    revived._drain_outbox()
    assert revived.outbox.pending_count() == 0
    rows = server.db.q("SELECT n_state, pass FROM nets")
    assert [(r["n_state"], r["pass"]) for r in rows] == [(1, PSK)]

    puts = []
    real_put = revived.api.put_work
    revived.api.put_work = lambda hkey, cand, max_tries=None, epoch=None: (
        puts.append(list(cand)) or real_put(hkey, cand, max_tries=max_tries, epoch=epoch))
    res2 = revived.process_work(dict(work))
    assert res2.accepted
    assert puts == []


def test_dict_md5_mismatch_rejected(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="md5-1")])
    path, dhash = _add_dict(server, [PSK])
    with open(path, "ab") as f:
        f.write(b"corruption\n")
    client = _client(server, tmp_path)
    work = client.api.get_work(1)
    with pytest.raises(ValueError, match="md5 mismatch"):
        client._fetch_dicts(work)


def test_autotune_moves_dictcount(server, tmp_path):
    client = _client(server, tmp_path)
    client.cfg.pace_target = 1e9
    for _ in range(20):
        client._autotune(elapsed=1.0)
    assert client.dictcount == 15
    client.cfg.pace_target = 0.0
    for _ in range(20):
        client._autotune(elapsed=1.0)
    assert client.dictcount == 1


def test_prdict_pass1_candidates(server, tmp_path):
    probed_psk = b"ProbedNetwork1"
    blob, _ = jtfx.make_handshake_capture(probed_psk, ESSID, probes=[probed_psk])
    from dwpa_tpu.server.api import submit_capture

    submit_capture(server, blob)
    server.db.x("UPDATE nets SET algo = ''")
    _add_dict(server, [b"filler-word-1"])
    client = _client(server, tmp_path)
    work = client.api.get_work(1)
    assert work.get("prdict") is True
    res = client.process_work(work)
    assert any(f.psk == probed_psk for f in res.founds)
    rows = server.db.q("SELECT n_state, pass FROM nets")
    assert all(r["n_state"] == 1 and r["pass"] == probed_psk for r in rows)


def test_cracked_dict_runs_in_pass1_with_rkg(server, tmp_path):
    from dwpa_tpu.server.jobs import regen_rkg_dict

    _ingest(server, [jtfx.make_eapol_line(PSK, ESSID, keyver=2, seed="cd1")])
    server.add_hashlines([jtfx.make_pmkid_line(PSK, b"OtherNet", seed="cd1v")])
    server.db.x("UPDATE nets SET algo = 'Vendor', n_state = 1, pass = ? "
                "WHERE ssid = ?", (PSK, b"OtherNet"))
    regen_rkg_dict(server, os.path.join(server.dictdir, "rkg.txt.gz"))
    _add_dict(server, [b"chaff-00001", b"chaff-00002"], name="cracked.txt.gz")

    client = _client(server, tmp_path)
    work = client.api.get_work(client.dictcount)
    assert any("cracked.txt.gz" in d["dpath"] for d in work["dicts"])
    res = client.process_work(work)
    assert [f.psk for f in res.founds] == [PSK]
    assert server.db.q1(
        "SELECT n_state FROM nets WHERE ssid = ?", (ESSID,))["n_state"] == 1


def test_cracked_dict_refresh_cadence(server, tmp_path):
    """cracked.txt.gz is downloaded for the first unit, then again only
    every ``cracked_refresh`` units: four units through the port's
    ``_prefetch_cracked`` download it at the same units as the JAX
    client's (tests/test_client_loopback.py::test_cracked_dict_refresh_cadence)."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="cd2")])
    _add_dict(server, [PSK], name="cracked.txt.gz")
    client = _client(server, tmp_path, cracked_refresh=3)
    jclient = JTpuCrackClient(
        JClientConfig(base_url="http://loopback/", workdir=str(tmp_path / "jwork"),
                      cracked_refresh=3),
        api=JLoopbackAPI(make_wsgi_app(server)), log=lambda *a, **k: None)
    work = client.api.get_work(client.dictcount)

    def downloads(api):
        return sum(1 for _, u in api.requests if "cracked.txt.gz" in u)

    counts, jcounts = [], []
    for _ in range(4):
        files = client._prefetch_cracked(dict(work))
        assert os.path.basename(files[0]) == "cracked.txt.gz"
        counts.append(downloads(client.api))
        list(jclient._cracked_candidates(dict(work), []))
        jcounts.append(downloads(jclient.api))
    assert counts == jcounts == [1, 1, 1, 2]


def test_archive_logs_appended(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="ar1")])
    _add_dict(server, [PSK])
    client = _client(server, tmp_path, max_work_units=1)
    assert client.run() == 1
    arc = open(os.path.join(client.cfg.workdir, "archive.22000")).read()
    assert arc.count("WPA*") >= 1
    res_lines = open(os.path.join(client.cfg.workdir, "archive.res")).read()
    assert json.loads(res_lines.splitlines()[-1])["hkey"]


def test_engine_error_recovery_halves_batch(server, tmp_path):
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="er1")])
    _add_dict(server, [PSK])
    reg = MetricsRegistry()
    client = _client(server, tmp_path, registry=reg)
    work = client.api.get_work(1)
    work["_progress"] = {"done": 0, "cand": []}
    seen = []
    real = client.process_work

    def flaky(w):
        seen.append((client.cfg.batch_size, "_progress" in w))
        if len(seen) == 1:
            raise RuntimeError("injected CUDA out of memory")
        return real(w)

    client.process_work = flaky
    res = client._process_with_recovery(work)
    assert res is not None and res.accepted
    assert seen == [(64, True), (32, False)]
    assert client.cfg.batch_size == 64
    assert reg.value("dwpa_client_engine_retries_total") == 1


def _run_until_idle(client):
    """``run`` until its first idle nap (the abandoned unit's lease keeps
    the net from being re-issued, so get_work says No nets)."""
    def stop(_):
        raise Stop

    client.api.sleep = stop
    with pytest.raises(Stop):
        client.run()


RULES_TEXT = ":\nu\nc $1\n@a\n$1 $2"
RULE_PSK = b"Rulesbase77!1"    # 'rulesbase77!' through 'c $1'


def _rules_dicts(server):
    """Two dicts with per-dict rules: the server merges them into the
    unit.  The PSK is a base word of the second dict through 'c $1'; a
    70-byte base and a 63-byte base take the host tail (every rule, and
    the '$1 $2' overflow)."""
    _add_dict(server, [b"rfill-a-%04d" % i for i in range(40)] + [b"y" * 70],
              name="r1.txt.gz", rules=":\nu\nc $1")
    words = [b"rfill-b-%04d" % i for i in range(60)] + [b"rulesbase77!", b"z" * 63]
    _add_dict(server, words, name="r2.txt.gz", rules="@a\n$1 $2\nu")


def test_rules_unit_cracked_and_accepted(any_server, tmp_path, monkeypatch):
    """A unit carrying rules: pass 2 expands every base block on the
    device by the merged rules (the PSK only exists as a mangled word),
    the finds are accepted, and every (word, rule) pair of pass 2 lands
    in exactly one of the rules counters."""
    server = any_server
    _ingest(server, [jtfx.make_pmkid_line(RULE_PSK, ESSID, seed="ru1"),
                     jtfx.make_eapol_line(RULE_PSK, ESSID, keyver=2, seed="ru2")])
    _rules_dicts(server)
    reg = MetricsRegistry()
    client = _client(server, tmp_path, registry=reg, batch_size=16)
    calls = []
    real = tm.M22000Engine.crack_rules_blocks
    monkeypatch.setattr(tm.M22000Engine, "crack_rules_blocks",
                        lambda self, *a, **k: (calls.append(k.get("skip")),
                                               real(self, *a, **k))[1])
    assert client.challenge()
    work = client.api.get_work(2)
    rules = client._rules(work)
    assert [r.text for r in rules] == RULES_TEXT.splitlines()
    pass1 = len(list(client._pass1_candidates(work, rules, [])))
    res = client.process_work(work)
    assert calls == [0]  # pass 2 only: prewarm runs no rules
    assert res.accepted and sorted(f.psk for f in res.founds) == [RULE_PSK] * 2
    rows = server.db.q("SELECT n_state, pass FROM nets")
    assert all(r["n_state"] == 1 and r["pass"] == RULE_PSK for r in rows)
    dev = reg.value("dwpa_rules_device_expanded_total")
    purge = reg.value("dwpa_rules_host_fallback_total", reason="purge")
    over = reg.value("dwpa_rules_host_fallback_total", reason="overflow")
    # the 70-byte base takes all five rules on the host, the 63-byte base
    # its '$1 $2' overflow; '@a' is purged on the host for the other 102
    assert (purge, over) == (102, 5 + 1)
    assert dev + purge + over == res.candidates_tried - pass1 == 103 * 5
    assert [r for r in client.tracer.records() if r["name"] == "rules:expand"]


def test_rules_unit_resume_counts_like_jax_client(server, tmp_path):
    """A crash after the 2nd pass-2 block's checkpoint: the checkpoint is
    pass 1 + the expanded count of the JAX client's first two rules
    blocks (per-dict framing), and a fresh client skips exactly that,
    still finds the PSK (in a later block) and is accepted."""
    _ingest(server, [jtfx.make_pmkid_line(RULE_PSK, ESSID, seed="rr2")])
    _rules_dicts(server)
    crashed = _client(server, tmp_path, batch_size=16)
    work = crashed.api.get_work(2)
    rules = crashed._rules(work)
    assert [r.text for r in rules] == [":", "u", "c $1", "@a", "$1 $2"]
    pass1 = len(list(crashed._pass1_candidates(work, rules, [])))
    real_write = crashed._write_resume
    pass2_checkpoints = []

    def write_then_crash(w):
        real_write(w)
        done = w.get("_progress", {}).get("done", 0)
        if done > pass1:
            pass2_checkpoints.append(done)
            if len(pass2_checkpoints) == 2:
                raise Crash

    crashed._write_resume = write_then_crash
    with pytest.raises(Crash):
        crashed.process_work(work)
    # the JAX client's pass-2 blocks over the same downloaded dicts
    paths = [(crashed._fetch_dicts(work)[i], None) for i in range(2)]
    jblocks = [b.count for b in JRulesFeedSource(paths, 16)]
    assert jblocks == [16, 16, 9, 16, 16, 16, 14]
    n = len(jparse_rules(RULES_TEXT.splitlines()))
    expect = [pass1 + n * sum(jblocks[:k + 1]) for k in range(2)]
    assert pass2_checkpoints == expect
    checkpointed = json.load(open(crashed.resume_path))["_progress"]["done"]
    assert checkpointed == expect[-1]

    reg = MetricsRegistry()
    revived = _client(server, tmp_path, batch_size=16, registry=reg, max_work_units=1)
    revived.api.get_work = lambda *a, **k: pytest.fail("must replay the resume")
    assert revived.run() == 1
    assert reg.value("dwpa_client_resume_skipped_total") == checkpointed
    res = revived.last_result
    assert res.accepted and [f.psk for f in res.founds] == [RULE_PSK]
    assert res.candidates_tried == n * sum(jblocks[2:])


def test_mask_unit_abandoned_as_unsupported(server, tmp_path):
    """A unit carrying mask shards used to be abandoned as unsupported;
    now run() cracks it: the shard's planted PSK is generated on the
    device, found and accepted, and the unit is not abandoned."""
    mask_psk = b"00000777"
    _ingest(server, [jtfx.make_pmkid_line(mask_psk, ESSID, seed="mu1")])
    _add_dict(server, [b"base-word-1"])
    client = _client(server, tmp_path)
    work = client.api.get_work(1)
    work["masks"] = [{"mask": "?d" * 8, "custom": {}, "skip": 700, "limit": 100}]
    client._write_resume(work)  # the unit comes back through the resume file
    calls = []
    real = client.process_work
    client.process_work = lambda w: (calls.append(1), real(w))[1]
    _run_until_idle(client)
    assert calls == [1]
    assert not os.path.exists(client.resume_path)
    res = client.last_result
    assert res.accepted and [f.psk for f in res.founds] == [mask_psk]
    assert server.db.q1("SELECT n_state FROM nets")["n_state"] == 1


def test_pass1_candidates_match_jax_client(server, tmp_path):
    """The pass-1 stream of the port client equals the JAX client's for
    the same work dict: targeted families, hash material, the PR-dict
    snapshot, cracked/rkg files and the additional dictionary."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, b"PLDTHOMEFIBR1a", seed="p1a"),
                     jtfx.make_eapol_line(PSK, b"PLDTHOMEFIBR1a", keyver=2, seed="p1b")])
    _add_dict(server, [PSK])
    extra = tmp_path / "extra.txt"
    extra.write_bytes(b"extra-word-1\n$HEX[6869]\nextra-word-2\n")
    cracked = tmp_path / "cracked.txt.gz"
    cracked.write_bytes(gzip.compress(b"cracked-1\ncracked-2\n"))
    client = _client(server, tmp_path, additional_dict=str(extra))
    work = client.api.get_work(1)
    work["_prdict_cache"] = [b"probed-ssid".hex(), b"$HEX[4142]".hex()]
    jclient = JTpuCrackClient(
        JClientConfig(base_url="http://loopback/", workdir=str(tmp_path / "jwork"),
                      additional_dict=str(extra)),
        api=JLoopbackAPI(make_wsgi_app(server)), log=lambda *a, **k: None)
    got = list(client._pass1_candidates(work, [], [str(cracked)]))
    ref = list(jclient._pass1_candidates(work, [], [str(cracked)]))
    assert got == ref
    assert got[-5:] == [b"extra-word-1", b"$HEX[6869]", b"extra-word-2",
                        b"cracked-1", b"cracked-2"]
    assert b"probed-ssid" in got and b"PLDTWIFI00000" in got
    # with the unit's rules, the cracked/rkg files expand on the host
    text = ":\nu\n$1 $2\n@c\nsr$"
    work["rules"] = base64.b64encode(text.encode()).decode()
    rules, jrules = client._rules(work), jclient._rules(work)
    assert [r.text for r in rules] == [r.text for r in jrules] == text.splitlines()
    got = list(client._pass1_candidates(work, rules, [str(cracked)]))
    assert got == list(jclient._pass1_candidates(work, jrules, [str(cracked)]))
    assert got[-10:] == [b"cracked-1", b"CRACKED-1", b"cracked-112", b"raked-1", b"c$acked-1",
                         b"cracked-2", b"CRACKED-2", b"cracked-212", b"raked-2", b"c$acked-2"]


def test_unported_features_refused(server, tmp_path, monkeypatch):
    """Nothing is refused as unported any more: ``device_streams="on"``
    (the last refusal) constructs a client that routes its passes through
    streams; a mode the JAX client lacks is still a ValueError, and with
    no card and no explicit device the client raises instead of falling
    back to the CPU."""
    assert _client(server, tmp_path, device_streams="on")._use_streams()
    assert not _client(server, tmp_path, device_streams="off")._use_streams()
    with pytest.raises(ValueError):
        _client(server, tmp_path, device_streams="always")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _client(server, tmp_path, device_streams="on", device=None)
    # unit fusion is ported: its knobs construct a client
    assert _client(server, tmp_path, unit_queue=2, fuse_max_units=4).cfg.unit_queue == 2


def test_client_cli_refuses_deferred_flags(monkeypatch):
    """No flag is deferred any more (the multi-host flags and
    ``--device-streams on`` are real); what the CLI still refuses with
    exit 2 is a command line it cannot run: ``--multihost`` without the
    env:// variables, a partial manual slice, no ``--url``."""
    from dwpa_tpu_torch.client.__main__ import build_parser, main
    from dwpa_tpu_torch.parallel.mesh import ENV_VARS

    a = build_parser().parse_args(["--url", "http://s/", "--device", "cuda:0"])
    assert (a.url, a.device) == ("http://s/", "cuda:0")
    a = build_parser().parse_args(["--url", "http://s/", "--device-streams", "on",
                                   "--coordinator", "127.0.0.1:1", "--num-processes",
                                   "2", "--process-id", "1"])
    assert (a.device_streams, a.coordinator, a.num_processes, a.process_id) == (
        "on", "127.0.0.1:1", 2, 1)
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    for argv in (["--url", "http://s/", "--multihost"],
                 ["--url", "http://s/", "--coordinator", "127.0.0.1:1"],
                 []):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2


def test_client_cli_rule_workers(server, tmp_path, monkeypatch):
    """--rule-workers reaches ClientConfig (default 0), and the client
    hands it to the pass-1 rule expansion."""
    from dwpa_tpu_torch.client import __main__ as cli

    seen = []

    class Recorder:
        def __init__(self, cfg):
            seen.append(cfg)

        def run(self):
            return 0

    monkeypatch.setattr(cli, "TpuCrackClient", Recorder)
    cli.main(["--url", "http://s/", "--rule-workers", "3", "--device", "cpu"])
    cli.main(["--url", "http://s/", "--device", "cpu"])
    assert [c.rule_workers for c in seen] == [3, 0]
    calls = []
    monkeypatch.setattr(cm, "apply_rules",
                        lambda rules, stream, workers=0: calls.append(workers) or iter(()))
    client = _client(server, tmp_path, rule_workers=seen[0].rule_workers)
    assert list(client._stream_cracked(["unused.gz"], parse_rules([":"]))) == []
    assert calls == [3]


def test_client_cli_dict_cache_flags(monkeypatch, tmp_path):
    """--dict-cache-dir / --dict-cache-max-bytes reach ClientConfig (the
    cap defaults to 4 GiB, as the JAX client's), and the client opens the
    cache there."""
    from dwpa_tpu_torch.client import __main__ as cli

    seen = []
    monkeypatch.setattr(cli, "TpuCrackClient", lambda cfg: seen.append(cfg) or cli)
    monkeypatch.setattr(cli, "run", lambda: 0, raising=False)
    cli.main(["--url", "http://s/", "--device", "cpu", "--dict-cache-dir", str(tmp_path / "dc"),
              "--dict-cache-max-bytes", "12345"])
    cli.main(["--url", "http://s/", "--device", "cpu"])
    assert [(c.dict_cache_dir, c.dict_cache_max_bytes) for c in seen] == [
        (str(tmp_path / "dc"), 12345), (None, 4 << 30)]
    assert ClientConfig(base_url="x").dict_cache_max_bytes == \
        JClientConfig(base_url="x").dict_cache_max_bytes


# -- the packed-dictionary cache ---------------------------------------------


def _dictcache_client(server, tmp_path, workdir, registry=None, **kw):
    return _client(server, tmp_path, workdir=workdir, registry=registry,
                   dict_cache_dir=str(tmp_path / "dictcache"), **kw)


def test_dictcache_metrics_and_warm_unit(server, tmp_path):
    """``tests/test_client_loopback.py::test_dictcache_metrics_and_warm_unit``
    on the port: with dict_cache_dir set, the first unit cold-streams the
    dict while writing the packed cache (misses counted, bytes on disk),
    and a replay of the same unit serves pass 2 from mmap'd packed blocks
    — hits recorded, the warm words/s gauge live, the same finds."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="dc1")])
    _add_dict(server, [b"cacheable-%06d" % i for i in range(30)] + [PSK])
    reg = MetricsRegistry()
    client = _dictcache_client(server, tmp_path, "work", registry=reg)

    work = client.api.get_work(client.dictcount)
    res = client.process_work(dict(work))
    assert res.accepted and [f.psk for f in res.founds] == [PSK]
    assert reg.value("dwpa_dictcache_miss_blocks_total") > 0
    assert not reg.value("dwpa_dictcache_hit_blocks_total")
    assert reg.value("dwpa_dictcache_bytes") > 0
    text = reg.render_prometheus()
    for name in ("dwpa_dictcache_hit_blocks_total",
                 "dwpa_dictcache_miss_blocks_total",
                 "dwpa_dictcache_bytes", "dwpa_dictcache_words_per_s"):
        assert name in text, name

    server.db.x("UPDATE nets SET n_state = 0, pass = NULL, algo = ''")
    misses_before = reg.value("dwpa_dictcache_miss_blocks_total")
    res2 = client.process_work(dict(work))
    assert res2.accepted and [f.psk for f in res2.founds] == [PSK]
    assert res2.candidates_tried == res.candidates_tried
    assert reg.value("dwpa_dictcache_hit_blocks_total") > 0
    assert reg.value("dwpa_dictcache_miss_blocks_total") == misses_before
    assert reg.value("dwpa_dictcache_words_per_s", feed="warm") > 0


def test_rules_unit_warm_from_rbase(server, tmp_path):
    """A rules unit with dict_cache_dir: the cold unit writes an ``.rbase``
    entry per dict, the replay serves every pass-2 base block from them
    (no miss), and finds, candidate count and the rules counters equal
    the cold unit's."""
    _ingest(server, [jtfx.make_pmkid_line(RULE_PSK, ESSID, seed="rw1"),
                     jtfx.make_eapol_line(RULE_PSK, ESSID, keyver=2, seed="rw2")])
    _rules_dicts(server)
    runs = []
    for label in ("cold", "warm"):
        reg = MetricsRegistry()
        client = _dictcache_client(server, tmp_path, "work", registry=reg, batch_size=16)
        work = client.api.get_work(2) if label == "cold" else runs[0][2]
        res = client.process_work(dict(work))
        counters = [reg.value("dwpa_rules_device_expanded_total")] + [
            reg.value("dwpa_rules_host_fallback_total", reason=r) for r in ("purge", "overflow")]
        runs.append((res, reg, work, counters))
        server.db.x("UPDATE nets SET n_state = 0, pass = NULL, algo = ''")
    (cold, creg, _, ccount), (warm, wreg, _, wcount) = runs
    assert sorted(os.listdir(tmp_path / "dictcache")) == sorted(
        f"{h}.rbase" for h in (server.db.q1("SELECT dhash FROM dicts WHERE dname = ?", (n,))["dhash"]
                               for n in ("r1.txt.gz", "r2.txt.gz")))
    assert creg.value("dwpa_dictcache_miss_blocks_total") == 3 + 4
    assert not creg.value("dwpa_dictcache_hit_blocks_total")
    assert wreg.value("dwpa_dictcache_hit_blocks_total") == 3 + 4
    assert not wreg.value("dwpa_dictcache_miss_blocks_total")
    for res in (cold, warm):
        assert res.accepted and sorted(f.psk for f in res.founds) == [RULE_PSK] * 2
    assert warm.candidates_tried == cold.candidates_tried and wcount == ccount


@pytest.mark.parametrize("rules", [False, True], ids=["dict", "rules"])
def test_warm_crash_and_replay_stamps_equal_cold(server, tmp_path, monkeypatch, rules):
    """A warm unit crashed after its 2nd pass-2 checkpoint: every resume
    stamp it wrote equals the cold unit's at the same point, and a fresh
    client replays the rest by an index seek — pass 2 opens no
    ``DictStream`` — skipping exactly the checkpointed count, with the
    cold unit's finds, and is accepted."""
    from dwpa_tpu_torch.gen import dicts as gdicts

    psk = RULE_PSK if rules else PSK
    _ingest(server, [jtfx.make_pmkid_line(psk, ESSID, seed="wc1")])
    if rules:
        _rules_dicts(server)
    else:
        _add_dict(server, [b"filler-%06d" % i for i in range(200)] + [PSK])

    def stamps(client, crash_at=None):
        """Record the resume stamps written once pass 2 has begun."""
        seen, real_write, real_fetch = [], client._write_resume, client._fetch_pass2_paths
        client._fetch_pass2_paths = lambda w: seen.append("pass2") or real_fetch(w)

        def write(w):
            real_write(w)
            if seen and "_progress" in w:
                seen.append(dict(w["_progress"]))
                if len(seen) - 1 == crash_at:
                    raise Crash

        client._write_resume = write
        return seen

    opened = []

    class CountingStream(gdicts.DictStream):
        def __iter__(self):
            opened.append(self.source)
            return super().__iter__()

    monkeypatch.setattr(gdicts, "DictStream", CountingStream)
    cold = _dictcache_client(server, tmp_path, "cold", batch_size=16)
    work = cold.api.get_work(2 if rules else 1)
    cold_stamps = stamps(cold)
    cold_res = cold.process_work(dict(work))
    server.db.x("UPDATE nets SET n_state = 0, pass = NULL, algo = ''")

    crashed = _dictcache_client(server, tmp_path, "warm", batch_size=16)
    warm_stamps = stamps(crashed, crash_at=2)
    with pytest.raises(Crash):
        crashed.process_work(dict(work))
    assert warm_stamps == cold_stamps[:3]
    checkpointed = json.load(open(crashed.resume_path))["_progress"]["done"]
    assert len(opened) == (2 if rules else 1)      # the cold unit's pass 2 only
    del opened[:]

    reg = MetricsRegistry()
    revived = _dictcache_client(server, tmp_path, "warm", registry=reg, batch_size=16,
                                max_work_units=1)
    revived.api.get_work = lambda *a, **k: pytest.fail("must replay the resume")
    assert revived.run() == 1
    res = revived.last_result
    assert reg.value("dwpa_client_resume_skipped_total") == checkpointed
    assert not reg.value("dwpa_dictcache_miss_blocks_total") and opened == []
    assert res.accepted and [(f.psk, f.line.raw) for f in res.founds] == \
        [(f.psk, f.line.raw) for f in cold_res.founds]
    assert checkpointed + res.candidates_tried == cold_stamps[-1]["done"]


def test_client_defaults_to_the_card(server, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _client(server, tmp_path, device=None)


@pytest.mark.gpu
def test_gpu_round_trip(server, tmp_path, cuda_device):  # noqa: F811
    """The main path on the card: a loopback unit against dwpa_tpu.server
    cracked through the CUDA PBKDF2 kernel and accepted."""
    _ingest(server, [jtfx.make_pmkid_line(PSK, ESSID, seed="gpu1"),
                     jtfx.make_eapol_line(PSK, ESSID, keyver=2, seed="gpu2"),
                     jtfx.make_eapol_line(PSK, ESSID, keyver=3, seed="gpu3")])
    _add_dict(server, [b"gpu-filler-%05d" % i for i in range(3000)] + [PSK])
    client = _client(server, tmp_path, batch_size=1024, device=str(cuda_device),
                     max_work_units=1)
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    assert client.run() == 1
    res = client.last_result
    assert res.accepted and sorted(f.psk for f in res.founds) == [PSK] * 3
    assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]
    assert server.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1")["c"] == 3


@pytest.mark.gpu
def test_gpu_rules_round_trip(server, tmp_path, cuda_device):  # noqa: F811
    """A rules unit on the card: pass 2 expands on cuda:0 and runs K1 on
    the mangled rows; the finds are accepted."""
    lines = [jtfx.make_pmkid_line(RULE_PSK, ESSID, seed="gr1"),
             jtfx.make_eapol_line(RULE_PSK, ESSID, keyver=2, seed="gr2"),
             jtfx.make_eapol_line(RULE_PSK, ESSID, keyver=3, seed="gr3")]
    _ingest(server, lines)
    _add_dict(server, [b"gpu-rfill-%05d" % i for i in range(1500)], name="g1.txt.gz",
              rules=":\nu")
    _add_dict(server, [b"gpu-rfill2-%05d" % i for i in range(1500)] + [b"rulesbase77!"],
              name="g2.txt.gz", rules="c $1\n@a\n$1 $2")
    reg = MetricsRegistry()
    client = _client(server, tmp_path, batch_size=1024, device=str(cuda_device),
                     max_work_units=1, registry=reg, dictcount=2)
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    assert client.run() == 1
    res = client.last_result
    assert res.accepted and sorted(f.psk for f in res.founds) == [RULE_PSK] * 3
    assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]
    assert reg.value("dwpa_rules_device_expanded_total") > 0
    assert server.db.q1("SELECT COUNT(*) c FROM nets WHERE n_state = 1")["c"] == 3

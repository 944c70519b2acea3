"""The port's server (``dwpa_tpu_torch.server``) against ``dwpa_tpu.server``.

- One request sequence through both packages' ``make_wsgi_app``: capture
  ingest and resubmit, ``get_work`` (dict and mask-shard units),
  ``put_work`` bad, good and stale, the lease rows, the key issue, the
  UI pages and the stats.  Bodies, the headers a client reads, and
  every table row must be equal; then each server serves the rest of
  the sequence on the OTHER package's database.  Nondeterminism is
  pinned in both packages' ``core`` modules (``gen_key`` and ``now``);
  the SQL-default timestamp columns are left out of the row comparison.
- The capture builders of ``dwpa_tpu_torch.testing``: the same bytes as
  JAX's, and the same hashlines out of both packages' extractors.
- The CLI: ``serve`` / ``jobs`` and the eight operator subcommands'
  argument parsing against JAX's, the real ``jobs``, ``ks-add`` and
  ``ks-list`` (the tools themselves run in ``test_torch_tools.py``).
- The analyser's server-only rules (DW114 write atomicity, DW115 no
  scalar oracle loop outside the pre-crack): each port server file,
  linted under its ``dwpa_tpu/server/`` name, has no violation that the
  JAX file lacks.  The port's own path is outside both rules' scope.
"""

import gzip
import hashlib
import io
import itertools
import json
import shutil
import types
from contextlib import closing
from pathlib import Path

import pytest

import dwpa_tpu.obs.metrics as jmetrics
import dwpa_tpu.server.__main__ as jmain
import dwpa_tpu.server.core as jcore
from dwpa_tpu import testing as jtfx
from dwpa_tpu.analysis.linter import lint_source
from dwpa_tpu.server import Database as JDatabase
from dwpa_tpu.server import ServerCore as JServerCore
from dwpa_tpu.server import make_wsgi_app as jmake_wsgi_app
from dwpa_tpu.server.capture import extract_hashlines as jextract
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import hashline as hl
from dwpa_tpu_torch.obs import metrics as tmetrics
from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app
from dwpa_tpu_torch.server import __main__ as tmain
from dwpa_tpu_torch.server import core as tcore
from dwpa_tpu_torch.server.capture import extract_hashlines

ROOT = Path(__file__).resolve().parent.parent
PSK = b"correct-battery"
ESSID = b"TestLanParty"
PACKAGES = {
    "torch": (ServerCore, Database, make_wsgi_app),
    "jax": (JServerCore, JDatabase, jmake_wsgi_app),
}
#: columns filled by SQL ``strftime('%s','now')`` defaults
TIME_COLS = {"ts", "sts", "issued"}


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """The same key stream and clock in both packages' cores, and the
    clock ``gzip`` stamps into a header when a caller gives no ``mtime``
    (both servers' ``?prdict`` bodies), so equal bodies never depend on
    the two runs falling in the same second.  Each package's
    process-default metrics registry starts empty, so a server's
    ``?metrics`` page holds what this test registered, not what an
    earlier test in the same process did."""
    for mod in (tcore, jcore):
        keys = itertools.count(1)
        monkeypatch.setattr(mod, "gen_key", lambda k=keys: "%032x" % next(k))
        monkeypatch.setattr(mod, "now", lambda: 1_700_000_000.0)
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))
    for metrics in (tmetrics, jmetrics):
        monkeypatch.setattr(metrics, "_DEFAULT", metrics.MetricsRegistry())


def call(app, method="GET", qs="", body=b"", path="/", ctype=None, cookie=None,
         accept=None):
    out = {}

    def start_response(status, headers):
        out["status"], out["headers"] = status, headers

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": qs,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body),
               "REMOTE_ADDR": "9.9.9.9"}
    if ctype:
        environ["CONTENT_TYPE"] = ctype
    if cookie:
        environ["HTTP_COOKIE"] = cookie
    if accept:
        environ["HTTP_ACCEPT"] = accept
    body = b"".join(app(environ, start_response))
    headers = sorted((k, v) for k, v in out["headers"]
                     if k in ("Content-Type", "Set-Cookie", "Location", "Retry-After"))
    return out["status"], headers, body


def add_dict(core, words, name="small.txt.gz"):
    Path(core.dictdir).mkdir(parents=True, exist_ok=True)
    blob = gzip.compress(b"\n".join(words) + b"\n", mtime=0)
    (Path(core.dictdir) / name).write_bytes(blob)
    core.add_dict(f"dict/{name}", name, hashlib.md5(blob).hexdigest(), len(words))


def dump(db):
    """Every row of every table, timestamp-default columns left out."""
    out = {}
    for (name,) in db.conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name"):
        cols = [r[1] for r in db.conn.execute(f"PRAGMA table_info({name})")
                if r[1] not in TIME_COLS]
        out[name] = [tuple(r) for r in db.conn.execute(
            f"SELECT {', '.join(cols)} FROM {name} ORDER BY rowid")]
    return out


def schema(db):
    return db.conn.execute(
        "SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()


def first_half(app, core):
    """Ingest, dict units, put_work, a mask shard, the key issue."""
    blob, _ = tfx.make_handshake_capture(PSK, ESSID, probes=[b"PrSsid"])
    other, _ = tfx.make_handshake_capture(b"other-pass-9", b"OtherNet", seed="c2",
                                          with_pmkid=False)
    resp = [
        call(app),
        call(app, "POST", "get_work=2.0.0"),
        call(app, "POST", "get_work=2.2.0", json.dumps({"dictcount": 1}).encode()),
        call(app, "POST", body=blob),
        call(app, "POST", body=blob),
        call(app, "POST", body=other),
        call(app, "POST", body=b"not a capture"),
    ]
    core.db.x("UPDATE nets SET algo = '' WHERE algo IS NULL")
    add_dict(core, [b"xxxxxxxxx", PSK])
    add_dict(core, [b"y" * 9] * 3, name="bigger.txt.gz")
    status, hdrs, body = call(app, "POST", "get_work=2.2.0",
                              json.dumps({"dictcount": 1}).encode())
    resp.append((status, hdrs, body))
    work = json.loads(body)
    bssid = hl.parse(work["hashes"][0]).mac_ap.hex()
    resp += [
        call(app, path="/" + work["dicts"][0]["dpath"]),
        call(app, qs="prdict=" + work["hkey"]),
        call(app, "POST", "put_work", json.dumps({
            "hkey": work["hkey"], "type": "bssid",
            "cand": [{"k": bssid, "v": b"wrongpass1".hex()}]}).encode()),
        call(app, "POST", "put_work", json.dumps({
            "hkey": work["hkey"], "type": "bssid",
            "cand": [{"k": bssid, "v": PSK.hex()}]}).encode()),
        call(app, "POST", "put_work", json.dumps({
            "hkey": "f" * 32, "type": "bssid",
            "cand": [{"k": bssid, "v": PSK.hex()}]}).encode()),
        call(app, "POST", "put_work", b"{broken"),
        call(app, "POST", "get_work=2.2.0", json.dumps({"dictcount": "x"}).encode()),
    ]
    core.ks_add(r"^Other", r"^other-pass-\d$")
    resp.append(call(app, "POST", "get_work=2.2.0", json.dumps({"dictcount": 3}).encode()))
    resp.append(call(app, "POST", body=b"mail=someone%40example.org",
                     ctype="application/x-www-form-urlencoded"))
    return resp


def second_half(app, core):
    """Finish the units, guesses through the UI, the pages and stats."""
    resp = []
    for _ in range(3):
        status, hdrs, body = call(app, "POST", "get_work=2.2.0",
                                  json.dumps({"dictcount": 2}).encode())
        resp.append((status, hdrs, body))
        if not body.startswith(b"{"):
            break
        work = json.loads(body)
        resp.append(call(app, "POST", "put_work", json.dumps({
            "hkey": work["hkey"], "type": "bssid", "cand": []}).encode()))
    net = core.db.q1("SELECT hash FROM nets WHERE ssid = ?", (b"OtherNet",))
    key = "0" * 31 + "4"
    resp.append(call(app, "POST", "nets", f"{net['hash'].hex()}=other-pass-9".encode(),
                     ctype="application/x-www-form-urlencoded"))
    core.db.x("UPDATE nets SET ts = 1700000000, sts = 1700000000")
    core.db.x("UPDATE submissions SET ts = 1700000000")
    for qs in ("home", "nets", "dicts", "submit", "get_key", "search&search=Test",
               "search&search=zzz", "my_nets", "stats", "api&key=" + key,
               "get_key=" + key):
        resp.append(call(app, qs=qs, cookie=f"key={key}", accept="text/html"))
    resp.append(call(app, qs="stats"))
    resp.append(call(app, qs="metrics"))
    return resp


def metric_names(text: bytes):
    return sorted(ln.split()[2] for ln in text.decode().splitlines()
                  if ln.startswith("# TYPE"))


def _run(pkg, path, half, tmp_path, monkeypatch):
    """``half`` of the sequence on ``pkg``'s server over ``path``, in a
    directory of its own: the artifact paths the rows hold are relative,
    so they are the same for both packages."""
    Core, Db, make_app = PACKAGES[pkg]
    work = tmp_path / f"{pkg}-{half.__name__}"
    work.mkdir()
    monkeypatch.chdir(work)
    core = Core(Db(path), dictdir="dicts", capdir="caps")
    resp = half(make_app(core), core)
    rows = dump(core.db)
    core.db.close()
    return resp, rows


def _equal(a, b):
    (ra, rows_a), (rb, rows_b) = a, b
    assert [r[:2] for r in ra] == [r[:2] for r in rb]
    for x, y in zip(ra, rb):
        if b"# TYPE" in x[2]:
            assert metric_names(x[2]) == metric_names(y[2])
        else:
            assert x[2] == y[2], (x, y)
    assert rows_a == rows_b


def test_request_sequence_matches_jax_and_databases_swap(tmp_path, monkeypatch):
    paths = {pkg: str(tmp_path / f"{pkg}.db") for pkg in PACKAGES}
    first = {pkg: _run(pkg, paths[pkg], first_half, tmp_path, monkeypatch)
             for pkg in PACKAGES}
    _equal(first["torch"], first["jax"])
    resp = first["torch"][0]
    assert resp[1][2] == b"Version" and resp[2][2] == b"No nets"
    assert json.loads(resp[3][2])["new"] == 2 and json.loads(resp[4][2])["dup"] == 2
    assert [r[2] for r in resp[10:12]] == [b"OK", b"OK"]
    assert json.loads(resp[-2][2])["masks"], resp[-2]
    rows = first["torch"][1]
    assert rows["leases"] and any(PSK in r for r in rows["nets"])
    with closing(Database(paths["torch"])) as c, closing(JDatabase(paths["jax"])) as d:
        assert schema(c) == schema(d)

    # each server on the other package's database
    swapped = {}
    for pkg, other in (("torch", "jax"), ("jax", "torch")):
        copy = str(tmp_path / f"{pkg}-on-{other}.db")
        shutil.copy(paths[other], copy)
        swapped[pkg] = _run(pkg, copy, second_half, tmp_path, monkeypatch)
    _equal(swapped["torch"], swapped["jax"])
    # the guess posted through the UI cracked OtherNet on both databases
    assert any(b"other-pass-9" in r for r in swapped["torch"][1]["nets"])
    assert all(r[0] in ("200 OK", "302 Found") for r in swapped["torch"][0])


# ---------------------------------------------------------------------------
# capture builders and extraction
# ---------------------------------------------------------------------------

FRAMES = dict(psk=PSK, essid=ESSID, seed="cb", probes=[b"Cafe", b"Airport-Free"])
TIMES = [1700000000.25 * 1 + i * 0.5 for i in range(5)]


@pytest.mark.parametrize("case", [
    "frames", "frames_nopmkid", "capture", "pcap_be_nsec", "pcap_times", "pcapng",
    "pcapng_simple_be", "radiotap", "ppi", "eapol_key_frame", "beacon", "probe"])
def test_capture_builders_match_jax(case):
    def build(m):
        frames, n = m.make_handshake_frames(**FRAMES)
        return {
            "frames": lambda: (frames, n),
            "frames_nopmkid": lambda: m.make_handshake_frames(PSK, ESSID, with_pmkid=False),
            "capture": lambda: m.make_handshake_capture(**FRAMES),
            "pcap_be_nsec": lambda: m.pcap_bytes(frames, endian=">", nsec=True),
            "pcap_times": lambda: m.pcap_bytes(frames, times=TIMES),
            "pcapng": lambda: m.pcapng_bytes(frames, times=TIMES),
            "pcapng_simple_be": lambda: m.pcapng_bytes(frames, endian=">", simple=True),
            "radiotap": lambda: m.pcap_bytes(m.radiotap_wrap(frames), linktype=127),
            "ppi": lambda: m.pcap_bytes(m.ppi_wrap(frames, ppi_len=12), linktype=192),
            "eapol_key_frame": lambda: m.build_eapol_key_frame(
                0x010A, 7, b"n" * 32, mic=b"m" * 16, key_data=b"kd"),
            "beacon": lambda: m.beacon_frame(b"\x01" * 6, ESSID),
            "probe": lambda: m.probe_request_frame(b"\x02" * 6, ESSID),
        }[case]()

    got, want = build(tfx), build(jtfx)
    assert got == want
    blob = got[0] if isinstance(got, tuple) else got
    if case.startswith(("capture", "pcap", "radiotap", "ppi")):
        assert extract_hashlines(blob) == jextract(blob)
        assert extract_hashlines(blob)[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["serve", "--db", "w.db", "--port", "0", "--with-jobs"],
    ["serve", "--db", "w.db", "--precrack-device", "off", "--precrack-batch", "131072",
     "--no-precrack-ingest", "--max-inflight", "8"],
    ["jobs", "--db", "w.db", "--loop", "--precrack-limit", "7",
     "--precrack-dict-limit", "0", "--vendor-data", "v.json"],
    ["jobs", "--db", "w.db", "--precrack-device", "on"],
])
def test_cli_parses_like_jax(monkeypatch, argv):
    seen = {}
    for mod, tag in ((tmain, "torch"), (jmain, "jax")):
        for name in ("cmd_serve", "cmd_jobs"):
            monkeypatch.setattr(mod, name, lambda a, t=tag: seen.__setitem__(t, vars(a)))
        mod.main(argv)
    for args in seen.values():
        args.pop("fn")
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["precrack_device"] in ("auto", "off", "on")


def test_cli_device_choice_and_real_subcommands(tmp_path, capsys, monkeypatch):
    db = str(tmp_path / "cli.db")
    out = {}
    for mod, tag in ((tmain, "torch"), (jmain, "jax")):
        mod.main(["ks-add", "--db", db + tag, "--ssid-re", "^Home", "--pass-re", r"^pw\d{2}$"])
        mod.main(["ks-list", "--db", db + tag])
        mod.main(["jobs", "--db", db + tag, "--precrack-device", "off",
                  "--dictdir", str(tmp_path / tag)])
        out[tag] = capsys.readouterr().out.splitlines()
    assert out["torch"][:2] == out["jax"][:2]
    assert json.loads(out["torch"][1])[0]["keyspace"] == 100
    jobs_t, jobs_j = json.loads(out["torch"][2]), json.loads(out["jax"][2])
    assert jobs_t["precrack"] == jobs_j["precrack"] == {
        "processed": 0, "cracked": 0, "candidates": 0}
    assert set(jobs_t) == set(jobs_j)

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["jobs", "--db", db + "torch"])


TOOL_CMDS = {"recrack": "cmd_recrack", "pack-dict": "cmd_pack_dict",
             "dedup-dicts": "cmd_dedup_dicts", "fill-pr": "cmd_fill_pr",
             "enrich": "cmd_enrich", "reorder-captures": "cmd_reorder_captures",
             "pack-client": "cmd_pack_client", "migrate": "cmd_migrate"}


@pytest.mark.parametrize("argv", [
    ["recrack", "--db", "w.db", "--limit", "5"],
    ["pack-dict", "--db", "w.db", "words.txt", "--name", "top", "--default-rules"],
    ["dedup-dicts", "a.txt.gz", "b.txt.gz", "--db", "w.db"],
    ["fill-pr", "--db", "w.db", "--native", "--limit", "3"],
    ["enrich", "--db", "w.db", "--native"],
    ["reorder-captures", "--db", "w.db", "--capdir", "caps"],
    ["pack-client", "--hcdir", "hc", "--version", "9.9.9"],
    ["migrate", "--db", "w.db", "legacy.hccapx", "old.16800", "--no-verify"],
], ids=lambda a: a[0])
def test_cli_tool_subcommands_parse_like_jax(monkeypatch, argv):
    seen = {}
    name = TOOL_CMDS[argv[0]]
    for mod, tag in ((tmain, "torch"), (jmain, "jax")):
        monkeypatch.setattr(mod, name, lambda a, t=tag: seen.__setitem__(t, vars(a)))
        mod.main(argv)
    for args in seen.values():
        assert args.pop("fn").__name__ == "<lambda>"
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["cmd"] == argv[0]


# ---------------------------------------------------------------------------
# the analyser's server-only rules on the port
# ---------------------------------------------------------------------------

SERVER_FILES = sorted(p.name for p in (ROOT / "dwpa_tpu_torch" / "server").glob("*.py"))


@pytest.mark.parametrize("name", SERVER_FILES)
def test_port_server_file_keeps_dw114_dw115(name):
    as_jax = f"dwpa_tpu/server/{name}"

    def found(path):
        return sorted((v.code, v.snippet) for v in lint_source(path.read_text(), as_jax)
                      if v.code in ("DW114", "DW115"))

    port, ref = found(ROOT / "dwpa_tpu_torch" / "server" / name), found(ROOT / as_jax)
    assert [v for v in port if v not in ref] == []

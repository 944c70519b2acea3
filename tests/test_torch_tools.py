"""The port's operator tools (``dwpa_tpu_torch.server.tools`` and the
eight CLI subcommands) against ``dwpa_tpu.server.tools``.

One seeded server directory (a database with cracked nets, an archived
capture with probe requests whose net lost its message pair, a flat
legacy capture, two wordlists) is copied once per package; each
package's tool runs on its copy from inside it, so the relative
artifact paths the rows hold are the same.  The tools' return values
and every table row (the SQL-default timestamp columns left out) must be
equal, ``pack_dict`` / ``dedup_dicts`` output byte-equal.  Then the
recrack abort on a corrupted row, ``migrate`` of hccapx and 16800
records, and ``pack_client``: a deterministic, runnable archive of
``dwpa_tpu_torch`` that the port client's ``check_update`` accepts.
"""

import gzip
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import urllib.parse
from contextlib import closing
from pathlib import Path

import pytest

import dwpa_tpu.server.__main__ as jmain
from dwpa_tpu import testing as jtfx
from dwpa_tpu.server import Database as JDatabase
from dwpa_tpu.server import ServerCore as JServerCore
from dwpa_tpu.server import tools as jtools
from dwpa_tpu_torch import __version__
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
from dwpa_tpu_torch.client.protocol import ServerAPI
from dwpa_tpu_torch.models import hashline as hl
from dwpa_tpu_torch.server import Database, ServerCore, make_wsgi_app
from dwpa_tpu_torch.server import __main__ as tmain
from dwpa_tpu_torch.server import tools as ttools
from dwpa_tpu_torch.server.capture import extract_hashlines

PSK = b"ops-battery-1"
ESSID = b"OpsNet"
PACKAGES = {"torch": (ServerCore, Database, ttools, tmain),
            "jax": (JServerCore, JDatabase, jtools, jmain)}
TIME_COLS = {"ts", "sts", "issued"}
CRACKED = [("eapol", b"ops-battery-1", b"OpsNet", "t1"),
           ("pmkid", b"ops-battery-2", b"OpsNetTwo", "t2"),
           ("eapol", b"ops-battery-3", b"OpsNetThree", "t3")]


def dump(db):
    out = {}
    for (name,) in db.conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name"):
        cols = [r[1] for r in db.conn.execute(f"PRAGMA table_info({name})")
                if r[1] not in TIME_COLS]
        out[name] = [tuple(r) for r in db.conn.execute(
            f"SELECT {', '.join(cols)} FROM {name} ORDER BY rowid")]
    return out


def hccapx(line: str) -> bytes:
    """A parsed m22000 EAPOL line packed back into a 393-byte hccapx
    record (the hashcat v4 struct the legacy storage holds)."""
    h = hl.parse(line)
    rec = bytearray(393)
    rec[0:4] = b"HCPX"
    rec[4:8] = (4).to_bytes(4, "little")
    rec[8] = h.message_pair or 0
    rec[9] = len(h.essid)
    rec[10:10 + len(h.essid)] = h.essid
    rec[42] = h.keyver
    rec[43:59] = h.pmkid_or_mic
    rec[59:65] = h.mac_ap
    rec[65:97] = h.anonce
    rec[97:103] = h.mac_sta
    rec[103:135] = h.eapol[17:49]
    rec[135:137] = len(h.eapol).to_bytes(2, "little")
    rec[137:137 + len(h.eapol)] = h.eapol
    return bytes(rec)


def legacy_records():
    eap = tfx.make_eapol_line(PSK, ESSID, keyver=2, seed="mig3")
    p = tfx.make_pmkid_line(PSK, ESSID, seed="mig4").split("*")
    return [hccapx(eap), ":".join(p[2:6]).encode(), b"garbage line"]


@pytest.fixture
def servers(tmp_path, monkeypatch):
    """{pkg: directory} — one seeded server directory, copied per package."""
    seed = tmp_path / "seed"
    seed.mkdir()
    monkeypatch.chdir(seed)
    core = ServerCore(Database("wpa.db"), dictdir="dicts", capdir="caps")
    for kind, psk, essid, tag in CRACKED:
        line = (tfx.make_eapol_line(psk, essid, keyver=2, seed=tag) if kind == "eapol"
                else tfx.make_pmkid_line(psk, essid, seed=tag))
        core.add_hashlines([line])
        net = core.db.q1("SELECT * FROM nets ORDER BY net_id DESC")
        assert core.put_work({"hkey": "0" * 32,
                              "cand": [{"k": net["struct"].split("*")[3], "v": psk.hex()}]})
    blob, _ = tfx.make_handshake_capture(PSK, b"CaptureNet", seed="pr1",
                                         probes=(b"CoffeeShop", b"airport-free"))
    s_id = core.add_submission(blob)
    core.add_hashlines(extract_hashlines(blob)[0], s_id=s_id)
    core.db.x("UPDATE nets SET message_pair = NULL WHERE ssid = ?", (b"CaptureNet",))
    flat, _ = tfx.make_handshake_capture(b"flat-psk-123", b"FlatNet", seed="fl1")
    name = hashlib.md5(flat).hexdigest()
    Path("caps", name).write_bytes(flat)
    core.db.x("INSERT INTO submissions(localfile, hash, ip) VALUES (?, ?, '')",
              (os.path.join("caps", name), hashlib.md5(flat).digest()))
    Path("lists").mkdir()
    jtools._write_gz("lists/a.txt.gz", [b"shared-word", b"alpha-only", b"zz-top-word"])
    jtools._write_gz("lists/b.txt.gz", [b"zzz-long-word-here", b"shared-word", b"bb-word"])
    Path("lists/c.txt").write_bytes(b"cc-word-1\nalpha-only\n\nbb-word\n")
    for dname in ("a.txt.gz", "b.txt.gz"):
        data = Path("lists", dname).read_bytes()
        core.add_dict(f"dict/{dname}", dname, hashlib.md5(data).hexdigest(), 3)
    Path("old.hccapx").write_bytes(legacy_records()[0])
    Path("old.16800").write_bytes(b"\n".join(legacy_records()[1:]) + b"\n")
    core.db.close()
    out = {}
    for pkg in PACKAGES:
        out[pkg] = tmp_path / pkg
        shutil.copytree(seed, out[pkg])
    return out


def run(pkg, where, monkeypatch, fn):
    """``fn(tools, core)`` on ``pkg``'s copy; returns (result, rows)."""
    Core, Db, tools, _ = PACKAGES[pkg]
    monkeypatch.chdir(where[pkg])
    with closing(Db("wpa.db")) as db:
        out = fn(tools, Core(db, dictdir="dicts", capdir="caps"))
        return out, dump(db)


def both(where, monkeypatch, fn):
    got = {pkg: run(pkg, where, monkeypatch, fn) for pkg in PACKAGES}
    assert got["torch"] == got["jax"]
    return got["torch"]


TOOL_RUNS = {
    "recrack_verify": lambda t, c: t.recrack_verify(c),
    "recrack_verify_limit": lambda t, c: t.recrack_verify(c, limit=2),
    "pack_dict": lambda t, c: [t.pack_dict(c, [b"password", b"letmein99", b"hunter22"], "mini",
                                           rules=":\nu\n"),
                               t.pack_dict(c, "lists/c.txt", "fromfile.txt.gz")],
    "dedup_dicts": lambda t, c: t.dedup_dicts(["dicts/a.txt.gz", "dicts/b.txt.gz"]),
    "dedup_dicts_rows": lambda t, c: t.dedup_dicts(
        ["dicts/a.txt.gz", "dicts/b.txt.gz", "lists/c.txt"], core=c),
    "fill_pr": lambda t, c: [t.fill_pr(c), t.fill_pr(c, limit=1)],
    "fill_pr_native": lambda t, c: t.fill_pr(c, extractor=t.get_extractor(native=True)),
    "enrich_message_pair": lambda t, c: [t.enrich_message_pair(c), t.enrich_message_pair(c)],
    "enrich_native": lambda t, c: t.enrich_message_pair(c, extractor=t.get_extractor(native=True)),
    "convert_legacy": lambda t, c: [t.convert_legacy(r) for r in legacy_records()]
    + [t.convert_legacy("a:b"), t.convert_legacy(legacy_records()[1].decode())],
    "migrate_legacy": lambda t, c: t.migrate_legacy(c, legacy_records(), ip="1.2.3.4"),
    "reorder_captures": lambda t, c: [t.reorder_captures(c), t.reorder_captures(c)],
}


@pytest.mark.parametrize("tool", list(TOOL_RUNS))
def test_tool_matches_jax(servers, monkeypatch, tool):
    if tool.startswith("dedup"):
        for d in servers.values():
            (d / "dicts").mkdir(exist_ok=True)
            for n in ("a.txt.gz", "b.txt.gz"):
                shutil.copy(d / "lists" / n, d / "dicts" / n)
    out, rows = both(servers, monkeypatch, TOOL_RUNS[tool])
    for sub in ("dicts", "lists", "caps"):
        files = {pkg: sorted((p.relative_to(d).as_posix(), p.read_bytes())
                             for p in (d / sub).rglob("*") if p.is_file())
                 for pkg, d in servers.items() if (d / sub).exists()}
        assert files.get("torch") == files.get("jax"), sub
    if tool == "recrack_verify":
        assert out == {"checked": len(CRACKED)}
    if tool == "pack_dict":
        data = (servers["torch"] / "dicts" / "mini.txt.gz").read_bytes()
        assert gzip.decompress(data) == b"password\nletmein99\nhunter22\n"
        assert out[0]["dhash"] == hashlib.md5(data).hexdigest() and out[1]["wcount"] == 3
    if tool == "dedup_dicts_rows":
        assert out["dicts/b.txt.gz"] == {"before": 3, "after": 2}
        assert out["lists/c.txt"] == {"before": 3, "after": 1}
    if tool == "fill_pr":
        assert out[0] == {"submissions": 2, "probes": 2}
    if tool == "enrich_message_pair":   # the capture's PMKID and EAPOL nets
        assert out == [{"updated": 2}, {"updated": 0}]
    if tool == "migrate_legacy":
        assert out["converted"] == 2 and out["unconvertible"] == 1 and out["new"] == 2
    if tool == "reorder_captures":
        assert out == [{"moved": 1, "db_updated": 1}, {"moved": 0, "db_updated": 0}]
        assert not any(p.is_file() for p in (servers["torch"] / "caps").iterdir())


@pytest.mark.parametrize("column,value", [("pass", b"wrong-pass-99"), ("pmk", b"\x13" * 32)])
def test_recrack_aborts_on_a_corrupted_row(servers, monkeypatch, column, value):
    def corrupt_then_recrack(tools, core):
        core.db.x(f'UPDATE nets SET "{column}" = ? WHERE ssid = ?', (value, b"OpsNetTwo"))
        with pytest.raises(tools.RecrackError) as e:
            tools.recrack_verify(core)
        return str(e.value)

    msg, _ = both(servers, monkeypatch, corrupt_then_recrack)
    assert "does not re-crack its hashline" in msg


def test_pack_dict_is_deterministic(servers, monkeypatch):
    md5s = []
    for _ in range(2):
        out, _ = run("torch", servers, monkeypatch,
                     lambda t, c: t.pack_dict(c, [b"alpha-key", b"beta-key-2"], "twice"))
        md5s.append((out["dhash"], hashlib.md5(Path("dicts/twice.txt.gz").read_bytes()).hexdigest()))
    assert md5s[0] == md5s[1] and md5s[0][0] == md5s[0][1]


# -- the CLI ----------------------------------------------------------------


CLI = {
    "recrack": ["recrack", "--db", "wpa.db"],
    "pack-dict": ["pack-dict", "--db", "wpa.db", "lists/c.txt", "--name", "cli",
                  "--dictdir", "dicts", "--default-rules"],
    "dedup-dicts": ["dedup-dicts", "lists/a.txt.gz", "lists/b.txt.gz", "--db", "wpa.db"],
    "fill-pr": ["fill-pr", "--db", "wpa.db", "--native"],
    "enrich": ["enrich", "--db", "wpa.db"],
    "reorder-captures": ["reorder-captures", "--db", "wpa.db", "--capdir", "caps"],
    "pack-client": ["pack-client", "--hcdir", "hc", "--version", "9.9.9"],
    "migrate": ["migrate", "--db", "wpa.db", "old.hccapx", "old.16800"],
}


@pytest.mark.parametrize("cmd", list(CLI))
def test_cli_tool_matches_jax(servers, monkeypatch, capsys, cmd):
    got = {}
    for pkg, (_, Db, _, main) in PACKAGES.items():
        monkeypatch.chdir(servers[pkg])
        main.main(CLI[cmd])
        out = json.loads(capsys.readouterr().out)
        with closing(Db("wpa.db")) as db:
            got[pkg] = (out, dump(db))
    if cmd == "pack-client":   # each package packs itself: compare the shape
        for pkg, (out, _) in got.items():
            assert out["version"] == "9.9.9" and out["files"] > 20
            manifest = (servers[pkg] / "hc" / "dwpa_tpu.version").read_text().split()
            assert manifest == ["9.9.9", out["md5"]]
            out.pop("md5"), out.pop("files")
    assert got["torch"] == got["jax"]
    if cmd == "recrack":
        assert got["torch"][0] == {"checked": len(CRACKED)}


# -- client distribution ----------------------------------------------------


def test_pack_client_deterministic_runnable_and_accepted(tmp_path):
    a = ttools.pack_client(str(tmp_path / "a"))
    b = ttools.pack_client(str(tmp_path / "b"))
    assert a["md5"] == b["md5"] and a["files"] == b["files"] > 20
    assert a["version"] == __version__
    pyz = tmp_path / "a" / "dwpa_tpu.pyz"
    assert hashlib.md5(pyz.read_bytes()).hexdigest() == a["md5"]
    import zipfile

    with zipfile.ZipFile(pyz) as z:
        names = z.namelist()
        assert "__main__.py" in names
        assert all(n == "__main__.py" or n.startswith("dwpa_tpu_torch/") for n in names)
        assert "dwpa_tpu_torch/native/capture_fast.cpp" in names
        assert b"dwpa_tpu_torch.client.__main__" in z.read("__main__.py")
    r = subprocess.run([sys.executable, str(pyz), "--help"], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0 and "--device" in r.stdout
    with pytest.raises(ValueError, match="rejected"):
        ttools.pack_client(str(tmp_path / "c"), version="v2.0-rc1")

    # the port client's self-update probe against the port's server
    hcdir = str(tmp_path / "hc")
    out = ttools.pack_client(hcdir, version="999.0.0")
    app = make_wsgi_app(ServerCore(Database(":memory:"), hcdir=hcdir))

    class API(ServerAPI):
        def _transport(self, url, body=None, headers=None):
            parsed = urllib.parse.urlparse(url)
            env = {"REQUEST_METHOD": "GET", "PATH_INFO": parsed.path or "/",
                   "QUERY_STRING": parsed.query, "CONTENT_LENGTH": "0",
                   "wsgi.input": io.BytesIO(b""), "REMOTE_ADDR": "1.2.3.4"}
            st = {}
            body = b"".join(app(env, lambda s, h: st.update(status=s)))
            if not st["status"].startswith("200"):
                raise ConnectionError(st["status"])
            return body

        def fetch(self, url, data=None, max_tries=None):
            return self._transport(url)

    cfg = ClientConfig(base_url="http://x/", workdir=str(tmp_path / "w"), device="cpu")
    client = TpuCrackClient(cfg, api=API("http://x/"), log=lambda *a: None)
    assert client.check_update()
    got = Path(cfg.workdir, "dwpa_tpu-999.0.0.pyz").read_bytes()
    assert hashlib.md5(got).hexdigest() == out["md5"]
    # JAX's packer makes the same artifact names, which both clients fetch
    jout = jtools.pack_client(str(tmp_path / "jhc"))
    assert {Path(jout["pyz"]).name, "dwpa_tpu.version"} == \
        set(os.listdir(tmp_path / "jhc")) == set(os.listdir(hcdir))


def test_cli_conf_file_and_missing_db(tmp_path, capsys):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"db": str(tmp_path / "conf.db"), "dictdir": str(tmp_path / "d"),
                                "hcdir": str(tmp_path / "hc")}))
    tmain.main(["recrack", "--conf", str(conf)])
    assert json.loads(capsys.readouterr().out) == {"checked": 0}
    tmain.main(["pack-client", "--conf", str(conf)])
    assert (tmp_path / "hc" / "dwpa_tpu.version").is_file()
    with pytest.raises(SystemExit):
        tmain.main(["recrack"])
    with pytest.raises(SystemExit, match="hcdir"):
        tmain.main(["pack-client"])
    # the capture builders agree, so both seeds above are JAX's too
    assert tfx.make_handshake_capture(PSK, ESSID, seed="x")[0] == \
        jtfx.make_handshake_capture(PSK, ESSID, seed="x")[0]

"""The port's server pre-crack (``dwpa_tpu_torch.server.precrack``)
against ``dwpa_tpu.server.precrack`` on the same seeded inputs.

- ``verify_batch`` on the host path against JAX's and the oracle.
- ``PmkBatcher._derive_device`` on ``device="cpu"`` against JAX's at
  ``iterations=2`` (the plain torch PBKDF2 at 4096 takes minutes on a
  CPU): both packages' ``pmk_kernel`` are wrapped at 2 iterations, the
  JAX one on its XLA PBKDF2, at every fused width and word-column trim.
- ``prewarm`` with duplicate pairs and out-of-range lengths, the PMK
  store read across the packages, a poisoned store entry.
- ``PrecrackEngine`` sweeps of both packages over copies of one
  database, equal ``nets`` / ``rkg`` rows, a mid-sweep crash included.
  The port's engine derives on ``device="cpu"`` with hashlib PMKs
  (``tests/torch_fixtures.hashlib_pmk``), so its whole device seam runs;
  the JAX engine derives on the host (``device="off"``).
- ``device="auto"`` needs a card: it raises without one.
"""

import shutil

import numpy as np
import pytest
import torch
from torch_fixtures import hashlib_pmk
from torch_jax_refs import jax_xla_pmk

import dwpa_tpu.models.m22000 as jm
from dwpa_tpu.chaos.dbfault import (DbFaultPlan, SimulatedCrash, install,
                                    sweep_invariants)
from dwpa_tpu.obs import MetricsRegistry as JRegistry
from dwpa_tpu.pmkstore import PMKStore as JPMKStore
from dwpa_tpu.server import Database as JDatabase
from dwpa_tpu.server import ServerCore as JServerCore
from dwpa_tpu.server import precrack as jpc
from dwpa_tpu.server.core import SERVER_NC as JSERVER_NC
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.gen.vendors import (easybox_keys, imei_hotspot_keys,
                                        sky_keys)
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.oracle import m22000 as oracle
from dwpa_tpu_torch.pmkstore import PMKStore
from dwpa_tpu_torch.server import Database, ServerCore
from dwpa_tpu_torch.server import jobs
from dwpa_tpu_torch.server import precrack as tpc
from dwpa_tpu_torch.server.core import SERVER_NC

PSK = b"precrack-psk"
ESSID = b"PrecrackLan"


def _mixed_items():
    """Oracle items across keyvers, hash types, $HEX keys, wrong keys,
    multi-key lists, an NC case and an injected first-key PMK."""
    hexed = b"$HEX[" + PSK.hex().encode() + b"]"
    return [
        (tfx.make_pmkid_line(PSK, ESSID, seed="vb-p"), [b"not-the-psk", PSK], None),
        (tfx.make_eapol_line(PSK, ESSID, keyver=1, seed="vb-1"), [PSK], None),
        (tfx.make_eapol_line(PSK, b"OtherLanHere", keyver=2, seed="vb-2"),
         [b"miss-one00", b"miss-two00", PSK], None),
        (tfx.make_eapol_line(PSK, ESSID, keyver=3, seed="vb-3"), [hexed], None),
        (tfx.make_eapol_line(PSK, ESSID, keyver=2, nc_delta=3, seed="vb-n"),
         [b"all", b"of-these0", b"are-wrong"], None),
        (tfx.make_eapol_line(PSK, ESSID, keyver=2, nc_delta=-2, endian="BE",
                             seed="vb-nb"), [PSK], None),
        (tfx.make_eapol_line(PSK, ESSID, keyver=2, seed="vb-i"),
         [PSK, b"never-reached"], oracle.pmk_from_psk(PSK, ESSID)),
        (tfx.make_pmkid_line(PSK, ESSID, seed="vb-o"), [b"short", b"x" * 70, PSK], None),
    ]


def test_verify_batch_host_matches_jax_and_oracle():
    items = _mixed_items()
    got = tpc.verify_batch(items, nc=SERVER_NC)
    assert got == jpc.verify_batch(items, nc=JSERVER_NC)
    assert got == [oracle.check_key_m22000(line, keys, pmk=pmk, nc=SERVER_NC)
                   for line, keys, pmk in items]
    assert any(r is not None for r in got) and any(r is None for r in got)
    assert tpc.verify_batch([], nc=SERVER_NC) == []


def test_verify_batch_cpu_device_matches_host(monkeypatch):
    """The device seam (``device="cpu"``, hashlib PMKs behind the
    kernel entry) gives the host path's verdicts, element for element."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    items = _mixed_items()
    got = tpc.verify_batch(items, nc=SERVER_NC,
                           batcher=tpc.PmkBatcher(device="cpu", batch=8))
    assert got == tpc.verify_batch(items, nc=SERVER_NC)


# ---------------------------------------------------------------------------
# the device derive at reduced iterations
# ---------------------------------------------------------------------------


@pytest.fixture
def two_iterations(monkeypatch):
    """Both packages' ``pmk_kernel`` at 2 PBKDF2 iterations: the port's
    plain torch version, the JAX package's XLA PBKDF2."""
    real = tm.pmk_kernel
    monkeypatch.setattr(tm, "pmk_kernel",
                        lambda pw, s1, s2: real(pw, s1, s2, iterations=2))
    monkeypatch.setattr(jm, "pmk_kernel", lambda rows, s1, s2: jax_xla_pmk(
        np.asarray(rows), np.asarray(s1), np.asarray(s2), 2))


def _pairs(n, max_len, seed):
    rng = np.random.default_rng(seed)
    essids = [b"DeriveNet%d" % i for i in range(3)] + [b"x" * 32]
    out = []
    for i in range(n):
        k = int(rng.integers(8, max_len + 1)) if i else max_len
        out.append((essids[int(rng.integers(0, len(essids)))],
                    bytes(rng.integers(33, 127, k, dtype=np.uint8))))
    return out


# batch 16 -> fused widths 2, 8, 16: one pair runs at width 2, 37 pairs
# in three waves at 16, 16 and 8
@pytest.mark.parametrize("n,max_len", [(1, 12), (37, 63)])
def test_derive_device_matches_jax(two_iterations, n, max_len):
    import hashlib

    pairs = _pairs(n, max_len, seed=n)
    got, fill = tpc.PmkBatcher(device="cpu", batch=16)._derive_device(pairs)
    want, jfill = jpc.PmkBatcher(device="on", batch=16)._derive_device(pairs)
    assert got == want and fill == jfill
    assert got == [hashlib.pbkdf2_hmac("sha1", w, e, 2, 32) for e, w in pairs]


@pytest.mark.parametrize("n,max_len,cols", [(2, 12, 4), (5, 16, 4), (5, 28, 8),
                                            (16, 63, 16), (19, 20, 8)])
def test_derive_device_trims_word_columns(monkeypatch, n, max_len, cols):
    """Each wave ships the word columns its longest candidate fills, as
    the engine's fused path does; the PMKs stay hashlib's."""
    import hashlib

    real, shapes = tm.pmk_kernel, []

    def spy(pw, s1, s2):
        shapes.append((tuple(pw.shape), tuple(s1.shape), pw.dtype))
        return real(pw, s1, s2, iterations=2)

    monkeypatch.setattr(tm, "pmk_kernel", spy)
    pairs = _pairs(n, max_len, seed=n + max_len)
    got, _ = tpc.PmkBatcher(device="cpu", batch=16)._derive_device(pairs)
    assert got == [hashlib.pbkdf2_hmac("sha1", w, e, 2, 32) for e, w in pairs]
    widths = [min(w for w in (2, 8, 16) if w >= min(16, n - lo))
              for lo in range(0, n, 16)]
    assert [s[0] for s in shapes][0][1] == cols
    assert [s[0][0] for s in shapes] == widths
    assert all(s[1] == (s[0][0], 16) and s[2] == torch.int32 for s in shapes)


def test_prewarm_dedups_and_host_derives_oddballs(monkeypatch):
    """Duplicate pairs derive once, out-of-range lengths take the host
    path, and both packages fill the same memo and stats."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    pairs = _pairs(11, 40, seed=3)
    pairs += pairs[:4] + [(b"DeriveNet0", b"short"), (b"DeriveNet1", b"y" * 70)]
    t, j = tpc.PmkBatcher(device="cpu", batch=8), jpc.PmkBatcher(device="off", batch=8)
    st, sj = t.prewarm(pairs), j.prewarm(pairs)
    assert {**st, "fill": 0} == {**sj, "fill": 0}
    assert st["fill"] == 3 / 4  # the last wave: 3 lanes at width 4
    assert (st["requested"], st["unique"], st["derived"]) == (17, 13, 13)
    assert t._memo == j._memo
    assert t.pmk(b"DeriveNet1", b"y" * 70) == oracle.pmk_from_psk(b"y" * 70, b"DeriveNet1")


def test_store_files_read_across_packages(tmp_path):
    """Fresh derivations land in the store; a batcher of the other
    package re-reads every one of them from the same directory."""
    pairs = [(b"StoreNetA", b"storeword%02d" % i) for i in range(5)]
    pairs += [(b"StoreNetB", b"storeword%02d" % i) for i in range(3)]
    for wpc, wstore, rpc, rstore, d in ((tpc, PMKStore, jpc, JPMKStore, "t"),
                                       (jpc, JPMKStore, tpc, PMKStore, "j")):
        writer = wpc.PmkBatcher(store=wstore(str(tmp_path / d)), device="off")
        assert writer.prewarm(pairs)["store_hits"] == 0
        writer.store.close()
        reader = rpc.PmkBatcher(store=rstore(str(tmp_path / d)), device="off")
        s = reader.prewarm(pairs)
        assert s["store_hits"] == len(pairs) and s["derived"] == 0
        for e, w in pairs:
            assert reader.pmk(e, w) == oracle.pmk_from_psk(w, e)


def test_auto_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "on"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpc.PmkBatcher(device=device)
    core = ServerCore(Database(":memory:"), registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.precrack(core)
    assert not tpc.PmkBatcher(device="off").device_enabled()
    assert tpc.PmkBatcher(device="cpu").device_enabled()


# ---------------------------------------------------------------------------
# engine sweeps of both packages over one database
# ---------------------------------------------------------------------------

BSSID = bytes.fromhex("001a2b3c4d5e")
SKY_BSSID = bytes.fromhex("001a2b3c4d10")


def fleet_lines():
    """Nets the sweep cracks through each source, and nets it cannot,
    then the siblings that seed replay and the corpus.  All but one are
    PMKID lines: the oracle's full-width NC search (``SERVER_NC``) makes
    every EAPOL candidate cost hundreds of MICs in Python."""
    sta = bytes.fromhex("02aabbccdd01")
    lines = [
        tfx.make_eapol_line(b"precracknet01" + b"1", b"PrecrackNet01", seed="f-s"),
        tfx.make_pmkid_line(list(easybox_keys(BSSID))[1], b"EasyBox-123456",
                            mac_ap=BSSID, mac_sta=sta, seed="f-e"),
        tfx.make_pmkid_line(list(sky_keys(SKY_BSSID))[0], b"SKY12345",
                            mac_ap=SKY_BSSID, seed="f-k"),
        tfx.make_pmkid_line(list(imei_hotspot_keys())[70], b"AndroidAP-9f", seed="f-i"),
        tfx.make_pmkid_line(b"corpus-secret", b"CorpusLan", seed="f-d"),
        tfx.make_pmkid_line(b"replay-secret", b"ReplayLan", seed="f-r1"),
        tfx.make_pmkid_line(b"genuinely-random-psk!", b"NoVendorLan", seed="f-m"),
        tfx.make_pmkid_line(b"u$@-random-9911x", b"EasyBox-654321", seed="f-m2"),
    ]
    cracked = [
        tfx.make_pmkid_line(b"replay-secret", b"ReplayLan", seed="f-r0"),
        tfx.make_pmkid_line(b"corpus-secret", b"ElsewhereLan", seed="f-d0"),
    ]
    return lines, cracked


def build_db(path, lines, cracked):
    """A port-written database: the fleet and the siblings ingested
    together, then the siblings marked cracked with their PMKs out of
    band (as an accept leaves them, but without its ingest-time replay),
    so only the sweep can reach the fleet."""
    core = ServerCore(Database(path), registry=MetricsRegistry())
    core.add_hashlines(lines + cracked)
    for line, psk in zip(cracked, (b"replay-secret", b"corpus-secret")):
        r = core.db.q1("SELECT net_id, ssid FROM nets WHERE struct = ?", (line,))
        core.db.x("UPDATE nets SET pass = ?, pmk = ?, n_state = 1, algo = 'Manual' "
                  "WHERE net_id = ?", (psk, oracle.pmk_from_psk(psk, r["ssid"]),
                                       r["net_id"]))
    core.db.close()


def net_rows(db):
    return [tuple(r[k] for k in ("net_id", "pass", "pmk", "nc", "endian", "algo",
                                 "n_state"))
            for r in db.q("SELECT * FROM nets ORDER BY net_id")]


def rkg_rows(db):
    return [(r["net_id"], r["algo"], r["pass"], r["n_state"])
            for r in db.q("SELECT * FROM rkg ORDER BY net_id, pass")]


def db_copies(tmp_path, lines, cracked=()):
    """One port-written database, copied for each package."""
    src = str(tmp_path / "fleet.db")
    build_db(src, lines, list(cracked))
    paths = {}
    for tag in ("t", "j"):
        paths[tag] = str(tmp_path / f"{tag}.db")
        shutil.copy(src, paths[tag])
    return paths


@pytest.fixture
def fleet_dbs(tmp_path):
    return db_copies(tmp_path, *fleet_lines())


def _cores(paths, tmp_path):
    t = ServerCore(Database(paths["t"]), dictdir=str(tmp_path / "dt"),
                   registry=MetricsRegistry())
    j = JServerCore(JDatabase(paths["j"]), dictdir=str(tmp_path / "dj"),
                    registry=JRegistry())
    return t, j


def test_engine_sweep_matches_jax(fleet_dbs, tmp_path, monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    t, j = _cores(fleet_dbs, tmp_path)
    tout = tpc.PrecrackEngine(t, device="cpu", batch=64).run()
    jout = jpc.PrecrackEngine(j, device="off", batch=64).run()
    assert tout == jout
    assert net_rows(t.db) == net_rows(j.db)
    assert rkg_rows(t.db) == rkg_rows(j.db)
    cracked = {r["ssid"]: r["algo"] for r in t.db.q(
        "SELECT ssid, algo FROM nets WHERE n_state = 1 AND algo != 'Manual'")}
    assert cracked == {b"PrecrackNet01": "Single", b"EasyBox-123456": "EasyBox",
                       b"SKY12345": "Sky", b"AndroidAP-9f": "IMEI",
                       b"CorpusLan": "Dict", b"ReplayLan": "Replay"}
    assert t.db.q1("SELECT COUNT(*) c FROM nets WHERE algo IS NULL")["c"] == 0
    for tag, core in (("t", t), ("j", j)):
        with open(f"{core.dictdir}/rkg.txt.gz", "rb") as f:
            core.rkg_blob = f.read()
    assert t.rkg_blob == j.rkg_blob


def test_poisoned_store_entry_is_a_miss(tmp_path, monkeypatch):
    """A wrong PMK in the store for a net's winning pair turns the hit
    into a miss in both packages (the net is released uncracked); it
    never makes an accept."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    t, j = _cores(db_copies(tmp_path, fleet_lines()[0][:2]), tmp_path)
    essid, word = b"PrecrackNet01", b"precracknet011"
    stores = (PMKStore(str(tmp_path / "ts")), JPMKStore(str(tmp_path / "js")))
    for store in stores:
        store.put_many([(essid, [word], [b"\xee" * 32])])
    tout = tpc.PrecrackEngine(t, device="cpu", batch=64, store=stores[0]).run()
    jout = jpc.PrecrackEngine(j, device="off", batch=64, store=stores[1]).run()
    assert tout == jout
    assert net_rows(t.db) == net_rows(j.db)
    row = t.db.q1("SELECT algo, n_state, pass FROM nets WHERE ssid = ?", (essid,))
    assert (row["algo"], row["n_state"], row["pass"]) == ("", 0, None)


def test_mid_sweep_crash_matches_jax(tmp_path, monkeypatch):
    """A crash at the last rkg insert of a sweep leaves the same rows in
    both packages, a clean invariant sweep, and a rerun that converges
    to the rows of an uninterrupted sweep."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    lines = fleet_lines()[0]
    fleet_dbs = db_copies(tmp_path, [lines[0], lines[1], lines[6]])
    ref = str(tmp_path / "ref.db")
    shutil.copy(fleet_dbs["t"], ref)
    rcore = ServerCore(Database(ref), registry=MetricsRegistry())
    stmts = []
    real_exec = rcore.db._exec
    rcore.db._exec = lambda sql, params=(): (stmts.append(sql), real_exec(sql, params))[1]
    tpc.PrecrackEngine(rcore, device="cpu", dict_limit=0).run()
    rcore.db._exec = real_exec
    last = max(i for i, sql in enumerate(stmts)
               if sql.lstrip().lower().startswith("insert into rkg"))

    t, j = _cores(fleet_dbs, tmp_path)
    engines = (tpc.PrecrackEngine(t, device="cpu", dict_limit=0),
               jpc.PrecrackEngine(j, device="off", dict_limit=0))
    for core, eng in zip((t, j), engines):
        uninstall = install(core.db, DbFaultPlan(seed=0).force_at(last, "crash"))
        with pytest.raises(SimulatedCrash):
            eng.run()
        uninstall()
        assert sweep_invariants(core.db) == []
    assert net_rows(t.db) == net_rows(j.db)
    assert rkg_rows(t.db) == rkg_rows(j.db)
    assert t.db.q1("SELECT COUNT(*) c FROM nets WHERE algo IS NULL")["c"] >= 1
    for eng in engines:
        eng.run()
    assert net_rows(t.db) == net_rows(j.db) == net_rows(rcore.db)
    assert rkg_rows(t.db) == rkg_rows(j.db) == rkg_rows(rcore.db)


def test_ingest_hook_and_cron_job_match_jax(tmp_path, monkeypatch):
    """The ingestion hook and the cron job, each package on its own
    in-memory database fed the same lines: same rows, same counters."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    lines, _ = fleet_lines()
    rows = []
    for Core, Db, Reg, pc, jb, dev in (
            (ServerCore, Database, MetricsRegistry, tpc, jobs, "cpu"),
            (JServerCore, JDatabase, JRegistry, jpc, __import__(
                "dwpa_tpu.server.jobs", fromlist=["precrack"]), "off")):
        core = Core(Db(":memory:"), dictdir=str(tmp_path / dev), registry=Reg())
        core.precrack = pc.PrecrackEngine(core, device=dev, dict_limit=0)
        report = core.add_hashlines(lines[:2])
        out = jb.precrack(core, device=dev)
        core.add_hashlines(lines[4:6])
        out2 = jb.precrack(core, device=dev)
        reg = core.registry
        rows.append((report, out, out2, net_rows(core.db), rkg_rows(core.db),
                     reg.value("dwpa_precrack_free_founds_total"),
                     [reg.value("dwpa_precrack_candidates_total", source=s)
                      for s in ("single", "vendor", "imei", "replay", "dict")]))
    assert rows[0] == rows[1]
    assert rows[0][0]["new"] == 2 and rows[0][1]["processed"] == 0

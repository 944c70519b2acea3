"""The port's on-device mask generation against the JAX package.

``mask_blocks``, ``device_mask_words`` (on CPU tensors) and the engine's
``crack_mask`` are held to ``dwpa_tpu.gen.mask`` and the JAX engine on
the same inputs, exactly; the volunteer client's mask pass is held to
the JAX client's checkpoints against ``dwpa_tpu.server`` over loopback,
as ``tests/test_mask_shards.py`` holds the JAX client.  The port's engine
runs on the CPU with hashlib PMKs (``hashlib_pmk``), as in the port's
other engine-level tests; the JAX engine runs its own full path.
"""

import json

import numpy as np
import pytest
from test_torch_client import LoopbackAPI
from torch_fixtures import hashlib_pmk

from dwpa_tpu import testing as jtfx
from dwpa_tpu.client.main import ClientConfig as JClientConfig
from dwpa_tpu.client.main import TpuCrackClient as JTpuCrackClient
from dwpa_tpu.gen import mask as jmask
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.server import Database, ServerCore, make_wsgi_app
from dwpa_tpu.utils import bytesops as jbo
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.client.main import ClientConfig, TpuCrackClient
from dwpa_tpu_torch.gen import mask as tmask
from dwpa_tpu_torch.models import m22000 as tm

#: 8a's masks: (mask, custom, start) — the keyspace end, a start beyond
#: 2**32, a custom charset with bytes 0 and >= 128, 63 positions.
DEVICE_CASES = [
    ("?d" * 8, None, 0),
    ("?d" * 8, None, 99_999_980),
    ("ab?l?d", None, 7),
    ("?d" * 10, None, 9_999_999_000),
    ("?1?b?1?b?d?d", {"1": b"\x00\x7f\x80\xff"}, 123_456_789),
    ("?l?u" * 31 + "?d", None, 10 ** 85 + 12_345),
]


@pytest.mark.parametrize("mask,batch,skip,limit", [
    ("?d?d?d", 128, 0, None),
    ("?d?d?d", 128, 100, 300),      # a partial last block
    ("?d?d?d", 64, 990, 50),        # limit past the keyspace end
    ("?l?d?d", 100, 2555, None),
    ("ab?1?1", 7, 3, 2),
    ("?d?d", 16, 100, 5),           # skip past the end: no blocks
])
def test_mask_blocks_match_jax(mask, batch, skip, limit):
    custom = {"1": b"xyz"} if "?1" in mask else None
    got = [(b.offset, b.count, b.words, b.prep.mask, b.prep.custom, b.prep.start)
           for b in tmask.mask_blocks(mask, batch, skip=skip, limit=limit, custom=custom)]
    ref = [(b.offset, b.count, b.words, b.prep.mask, b.prep.custom, b.prep.start)
           for b in jmask.mask_blocks(mask, batch, skip=skip, limit=limit, custom=custom)]
    assert got == ref
    assert all(hasattr(b.prep, "mask_gen") for b in tmask.mask_blocks(mask, batch, skip=skip,
                                                                      limit=limit, custom=custom))


@pytest.mark.parametrize("mask,custom,start", DEVICE_CASES)
def test_device_mask_words_matches_jax_and_host_pack(mask, custom, start):
    batch = 40
    got = tmask.device_mask_words(mask, start, batch, custom, device="cpu")
    got = got.numpy().view(np.uint32)
    w = tm._trim_cols(len(tmask.parse_mask(mask, custom)))
    assert got.shape == (batch, w) and got.flags.c_contiguous
    ref = np.asarray(jmask.device_mask_words(mask, start, batch, custom))
    np.testing.assert_array_equal(got, ref[:, :w])
    assert not ref[:, w:].any()
    host = list(jmask.mask_words(mask, custom, skip=start, limit=batch))
    assert host == list(tmask.mask_words(mask, custom, skip=start, limit=batch))
    np.testing.assert_array_equal(got[:len(host)], jbo.pack_passwords_be(host)[:, :w])


def test_device_mask_words_keeps_jax_checks():
    for args in (("?d" * 64, 0, 4), ("?d" * 8, 0, 0), ("?d" * 8, 0, 2 ** 31)):
        for fn in (jmask.device_mask_words, tmask.device_mask_words):
            kw = {"device": "cpu"} if fn is tmask.device_mask_words else {}
            with pytest.raises(ValueError):
                fn(*args, **kw)


MASK = "?d" * 8
MASK_PSK = b"77345678"


def mask_lines():
    # one PMKID net: the JAX engine's step then equals the one the client
    # legs below compile, so the module pays one XLA compile
    return [jtfx.make_pmkid_line(MASK_PSK, b"MaskNet", seed="mk1")]


def found_key(f):
    return (f.line.raw, f.psk, f.nc, f.endian, f.pmk)


@pytest.fixture(scope="module")
def jax_crack_mask():
    """The JAX engine's ``crack_mask`` over a skip/limit slice holding the
    PSK (index 77,345,678) in its second, partial block."""
    eng = jm.M22000Engine(mask_lines(), batch_size=64, mesh=default_mesh())
    reports = []
    founds = eng.crack_mask(MASK, skip=77_345_600, limit=100,
                            on_batch=lambda n, new: reports.append((n, sorted(map(found_key, new)))))
    return reports, founds


def test_crack_mask_matches_jax_engine(monkeypatch, jax_crack_mask):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    jreports, jfounds = jax_crack_mask
    eng = tm.M22000Engine(mask_lines(), batch_size=64, device="cpu")
    reports = []
    founds = eng.crack_mask(MASK, skip=77_345_600, limit=100,
                            on_batch=lambda n, new: reports.append((n, sorted(map(found_key, new)))))
    assert reports == jreports and [n for n, _ in reports] == [64, 36]
    assert sorted(map(found_key, founds)) == sorted(map(found_key, jfounds))
    assert [f.psk for f in founds] == [MASK_PSK]
    # a slice that excludes the PSK finds nothing, on either side of it
    for skip, limit in ((0, 128), (77_345_679, 64)):
        eng = tm.M22000Engine(mask_lines(), batch_size=64, device="cpu")
        assert eng.crack_mask(MASK, skip=skip, limit=limit) == []


def test_crack_mask_uploads_no_candidates(monkeypatch):
    """A mask block reaches the PBKDF2 as rows generated from the
    keyspace: the native packer and the host packer never run."""
    from dwpa_tpu_torch import native

    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    calls = native.CALLS
    monkeypatch.setattr(tm.bo, "pack_passwords_be",
                        lambda *a: pytest.fail("mask words were packed on the host"))
    eng = tm.M22000Engine([tfx.make_pmkid_line(MASK_PSK, b"MaskNet", seed="mk4")],
                          batch_size=32, device="cpu")
    founds = eng.crack_mask(MASK, skip=77_345_670, limit=20)
    assert [f.psk for f in founds] == [MASK_PSK]
    assert native.CALLS == calls


# ---------------------------------------------------------------------------
# the client's mask pass against dwpa_tpu.server over loopback
# ---------------------------------------------------------------------------

PSK = b"wifipass77"   # index 77 of the 100-word ^wifipass\d{2}$ keyspace
ESSID = b"MaskNet"


@pytest.fixture(autouse=True)
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


def _mask_core(tmp_path, span=200, psk=PSK):
    core = ServerCore(Database(":memory:"), dictdir=str(tmp_path / "dicts"),
                      capdir=str(tmp_path / "caps"))
    core.mask_shard_span = span
    core.add_hashlines([jtfx.make_pmkid_line(psk, ESSID, seed="lb1")])
    core.db.x("UPDATE nets SET algo = ''")
    core.ks_add(r"^MaskNet$", r"^wifipass\d{2}$")
    return core


def _client(core, tmp_path, workdir="work", **cfg_kw):
    cfg_kw.setdefault("batch_size", 64)
    cfg_kw.setdefault("dictcount", 1)
    cfg = ClientConfig(base_url="http://loopback/", workdir=str(tmp_path / workdir),
                       device="cpu", **cfg_kw)
    return TpuCrackClient(cfg, api=LoopbackAPI(make_wsgi_app(core)),
                          log=lambda *a, **k: None)


def _masks(work):
    return [(m["mask"], m["skip"], m["limit"]) for m in work["masks"]]


def test_pure_mask_unit_accepted_with_zero_dict_bytes(tmp_path):
    core = _mask_core(tmp_path)
    client = _client(core, tmp_path)
    work = client.api.get_work(1)
    assert work["dicts"] == [] and _masks(work) == [("wifipass?d?d", 0, 100)]
    res = client.process_work(work)
    assert res.accepted and [f.psk for f in res.founds] == [PSK]
    assert core.db.q1("SELECT n_state, pass FROM nets")["pass"] == PSK
    assert [u for _, u in client.api.requests if "dict" in u] == []
    assert core.db.q1("SELECT COUNT(*) c FROM n2m")["c"] == 0
    assert client.registry.value("dwpa_client_pmk_per_s", **{"pass": "mask"}) > 0


def _mask_done_checkpoints(client, work):
    snaps = []
    real = client._write_resume
    client._write_resume = lambda w: (
        snaps.append(json.loads(json.dumps(w.get("_progress")))), real(w))[1]
    res = client.process_work(work)
    client._write_resume = real
    return res, [s["mask_done"] for s in snaps if s]


def test_mask_done_checkpoints_equal_jax_client(tmp_path):
    """``mask_done`` advances in exact keyspace indices (block counts),
    checkpoint for checkpoint as the JAX client's do on the same unit."""
    core = _mask_core(tmp_path)
    client = _client(core, tmp_path)
    work = client.api.get_work(1)
    res, dones = _mask_done_checkpoints(client, json.loads(json.dumps(work)))
    assert res.accepted and dones[-1] == 100 and 64 in dones
    jclient = JTpuCrackClient(
        JClientConfig(base_url="http://loopback/", workdir=str(tmp_path / "jwork"),
                      batch_size=64, dictcount=1, device_streams="off"),
        api=LoopbackAPI(make_wsgi_app(core)), log=lambda *a, **k: None)
    jres, jdones = _mask_done_checkpoints(jclient, json.loads(json.dumps(work)))
    assert [f.psk for f in jres.founds] == [f.psk for f in res.founds] == [PSK]
    assert dones == jdones
    assert res.candidates_tried == jres.candidates_tried


def test_mid_shard_restart_replays_exactly_the_suffix(tmp_path):
    """A crash after the first 64-wide mask block: the revived client
    replays exactly the uncovered suffix and still finds the PSK past
    the checkpoint."""
    core = _mask_core(tmp_path)
    crashed = _client(core, tmp_path)
    work = crashed.api.get_work(1)
    work["_progress"] = {"done": 10 ** 6, "mask_done": 64, "cand": []}
    crashed._write_resume(work)
    revived = _client(core, tmp_path)
    replayed = revived._read_resume()
    assert replayed == work
    res = revived.process_work(replayed)
    assert res.accepted
    assert res.candidates_tried == 100 - 64
    assert [f.psk for f in res.founds] == [PSK]
    assert revived.registry.value("dwpa_client_resume_skipped_total") >= 10 ** 6 + 64


def test_restart_fast_forwards_finished_shards(tmp_path):
    """A unit carrying several shards resumes past fully-done shards via
    the cumulative ``mask_done`` and mid-resumes the next one."""
    core = _mask_core(tmp_path, span=40, psk=b"wifipass92")
    client = _client(core, tmp_path, dictcount=3)
    work = client.api.get_work(3)
    assert _masks(work) == [("wifipass?d?d", 0, 40), ("wifipass?d?d", 40, 40),
                            ("wifipass?d?d", 80, 20)]
    work["_progress"] = {"done": 10 ** 6, "mask_done": 50, "cand": []}
    res = client.process_work(work)
    assert res.accepted
    assert res.candidates_tried == 100 - 50
    assert [f.psk for f in res.founds] == [b"wifipass92"]

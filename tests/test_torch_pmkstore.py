"""The port's PMK store against ``dwpa_tpu.pmkstore`` and the oracle.

- the store files: one package writes, the other reads the same PMKs,
  and the segment bytes are equal for the same puts;
- ``split_block`` and ``mix_step`` equal the JAX package's on the same
  store and inputs;
- the engine's mixed hit/miss blocks, as ``tests/test_pmkstore.py``
  holds the JAX engine: all-miss write-back, all-hit, the poisoned-cache
  control, interleaved, multi-ESSID, resume across cached blocks, and the
  ``dwpa_pmkstore_*`` metrics — on the CPU with hashlib PMKs
  (``hashlib_pmk``), against the oracle's PBKDF2 (hashlib).
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import hashlib_pmk

from dwpa_tpu import pmkstore as jps
from dwpa_tpu import testing as jtfx
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu.parallel.step import mix_step as jmix_step
from dwpa_tpu.utils import bytesops as jbo
from dwpa_tpu_torch import pmkstore as tps
from dwpa_tpu_torch.feed import CandidateFeed
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.parallel.step import mix_step

ESSID = b"StoreNet"
PSK = b"store-psk-777"


def _pmk(word, essid=ESSID):
    """The oracle's PBKDF2 (hashlib) — the parity reference."""
    return hashlib.pbkdf2_hmac("sha1", word, essid, 4096, 32)


def _seed(store, words, essid=ESSID):
    store.put(essid, words, [_pmk(w, essid) for w in words])


@pytest.fixture(autouse=True)
def _hashlib_pmks(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)


# ---------------------------------------------------------------------------
# store files across the two packages
# ---------------------------------------------------------------------------

def _segments(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _puts():
    words = [b"xpkg-%04d" % i for i in range(40)]
    return [(ESSID, words[:25]), (b"OtherNet", words[10:]), (ESSID, words[20:])]


@pytest.mark.parametrize("writer,reader", [(tps, jps), (jps, tps)])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    st = writer.PMKStore(str(tmp_path), segment_bytes=1 << 20, registry=MetricsRegistry())
    for essid, words in _puts():
        _seed(st, words, essid)
    st.close()
    st = reader.PMKStore(str(tmp_path), registry=MetricsRegistry())
    words = [b"xpkg-%04d" % i for i in range(40)]
    assert st.lookup(ESSID, words) == [_pmk(w) for w in words]
    assert st.lookup(b"OtherNet", words) == [None] * 10 + [_pmk(w, b"OtherNet")
                                                           for w in words[10:]]
    assert st.lookup(b"NoSuchNet", words[:3]) == [None] * 3


def test_segment_bytes_equal_for_the_same_puts(tmp_path):
    """Same puts, same rotation and eviction settings: byte-identical
    files under identical names, torn-tail handling included."""
    roots = {}
    for name, pkg in (("jax", jps), ("torch", tps)):
        root = str(tmp_path / name)
        st = pkg.PMKStore(root, max_bytes=6000, segment_bytes=1500,
                          registry=MetricsRegistry())
        for essid, words in _puts():
            st.put(essid, words, np.stack([np.frombuffer(_pmk(w, essid), ">u4")
                                           for w in words], 1).astype(np.uint32))
        st.close()
        roots[name] = root
    jfiles, tfiles = _segments(roots["jax"]), _segments(roots["torch"])
    assert jfiles and jfiles == tfiles
    # a torn last frame: both packages keep the same intact prefix
    path = sorted(jfiles)[-1]
    for root in roots.values():
        with open(os.path.join(root, path), "ab") as f:
            f.write(b"PMKF\x05\x00\x00\x00garbage")
    words = [b"xpkg-%04d" % i for i in range(40)]
    got = {name: pkg.PMKStore(roots[name], registry=MetricsRegistry()).lookup(ESSID, words)
           for name, pkg in (("jax", jps), ("torch", tps))}
    assert got["jax"] == got["torch"]


# ---------------------------------------------------------------------------
# split_block and mix_step
# ---------------------------------------------------------------------------

def _split_fields(mp):
    out = [mp.packed, mp.lens, mp.nvalid, mp.batch, sorted(mp.entries)]
    for essid in sorted(mp.entries):
        e = mp.entries[essid]
        out.append((e.nmiss, e.nhit, e.miss_words))
        out.extend(a for a in (e.miss_rows, e.miss_lens, e.idx, e.cached))
    return out


@pytest.mark.parametrize("seeded", ["none", "all", "odd", "few", "many"])
def test_split_block_equals_jax(tmp_path, seeded):
    words = [b"splitword-%03d" % i for i in range(29)]
    pick = {"none": [], "all": words, "odd": words[1::2], "few": words[:3],
            "many": words[:-2]}[seeded]
    root = str(tmp_path / "s")
    st = tps.PMKStore(root, registry=MetricsRegistry())
    _seed(st, pick)
    _seed(st, words[::3], b"Second")
    st.close()
    lens = np.asarray([len(w) for w in words], np.uint8)
    packed = np.zeros((32, 16), np.uint32)
    packed[:len(words)] = jbo.pack_passwords_be(words)
    essids = [ESSID, b"Second", b"Cold"]
    got = tps.split_block(tps.PMKStore(root, registry=MetricsRegistry()), essids,
                          packed, lens, len(words), 32, 1)
    ref = jps.split_block(jps.PMKStore(root, registry=MetricsRegistry()), essids,
                          packed, lens, len(words), 32, 1)
    for a, b in zip(_split_fields(got), _split_fields(ref)):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert tps.miss_widths(32, 1) == jps.miss_widths(32, 1)
    assert [tps.miss_width(32, 1, m) for m in range(33)] == \
        [jps.miss_width(32, 1, m) for m in range(33)]


def test_mix_step_equals_jax():
    rng = np.random.default_rng(5)
    B, width = 64, 8
    pm = rng.integers(0, 2 ** 32, (8, width), dtype=np.uint64).astype(np.uint32)
    cached = rng.integers(0, 2 ** 32, (8, B), dtype=np.uint64).astype(np.uint32)
    idx = width + np.arange(B, dtype=np.int32)
    cols = np.sort(rng.choice(B, 6, replace=False))
    idx[cols] = np.arange(6, dtype=np.int32)
    got = mix_step(*(torch.from_numpy(a.view(np.int32)) for a in (pm, cached)),
                   torch.from_numpy(idx))
    ref = np.asarray(jmix_step(default_mesh())(jnp.asarray(pm), jnp.asarray(cached),
                                               jnp.asarray(idx)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


# ---------------------------------------------------------------------------
# the engine's mixed hit/miss blocks vs the oracle
# ---------------------------------------------------------------------------

def _engine(store, psk=PSK, essid=ESSID, batch=32, seed="pmks-1"):
    line = jtfx.make_pmkid_line(psk, essid, seed=seed)
    return tm.M22000Engine([line], batch_size=batch, device="cpu", pmk_store=store)


def _crack(engine, words, registry=None, skip=0, on_batch=None):
    feed = CandidateFeed(iter(words), batch_size=engine.batch_size, producers=1,
                         skip=skip, prepack=engine.host_packer(),
                         registry=registry or MetricsRegistry())
    try:
        return engine.crack_blocks(feed, on_batch=on_batch)
    finally:
        feed.close()


def test_all_miss_blocks_write_back_oracle_pmks(tmp_path):
    store = tps.PMKStore(str(tmp_path))
    words = [b"coldword-%04d" % i for i in range(63)] + [PSK]
    founds = _crack(_engine(store), words)
    assert [f.psk for f in founds] == [PSK]
    assert store.lookup(ESSID, words) == [_pmk(w) for w in words]


def test_all_hit_blocks_use_cached_pmks(tmp_path, monkeypatch):
    """Warm store: no PBKDF2 at all, and the find still comes out of the
    cached PMK matrix."""
    store = tps.PMKStore(str(tmp_path))
    words = [b"warmword-%04d" % i for i in range(63)] + [PSK]
    _seed(store, words)
    monkeypatch.setattr(tm, "_pmk_impl", lambda *a: pytest.fail("PBKDF2 ran on an all-hit block"))
    founds = _crack(_engine(store), words)
    assert [f.psk for f in founds] == [PSK]


def test_all_hit_path_trusts_the_cache(tmp_path):
    """Poisoned cache: the PSK's cached PMK is wrong, so the device check
    (which sees only the cached matrix) must miss the find."""
    store = tps.PMKStore(str(tmp_path))
    words = [b"poison-%04d" % i for i in range(63)] + [PSK]
    _seed(store, words[:-1])
    store.put(ESSID, [PSK], [b"\x00" * 32])
    assert _crack(_engine(store), words) == []


def test_interleaved_hit_miss_parity(tmp_path):
    for in_hits in (True, False):
        store = tps.PMKStore(str(tmp_path / f"hit{in_hits}"))
        words = [b"mixword-%04d" % i for i in range(63)] + [PSK]
        seeded = [w for i, w in enumerate(words) if i % 2 == 0 and w != PSK]
        if in_hits:
            seeded.append(PSK)
        _seed(store, seeded)
        founds = _crack(_engine(store), words)
        assert [f.psk for f in founds] == [PSK], f"in_hits={in_hits}"
        assert store.lookup(ESSID, words) == [_pmk(w) for w in words]


def test_multi_essid_groups_split_independently(tmp_path):
    store = tps.PMKStore(str(tmp_path))
    e2 = b"OtherStoreNet"
    psk2 = b"store-psk-888"
    words = [b"dualword-%04d" % i for i in range(62)] + [PSK, psk2]
    _seed(store, words)  # ESSID fully cached; e2 fully cold
    lines = [jtfx.make_pmkid_line(PSK, ESSID, seed="du1"),
             jtfx.make_pmkid_line(psk2, e2, seed="du2")]
    eng = tm.M22000Engine(lines, batch_size=32, device="cpu", pmk_store=store)
    founds = _crack(eng, words)
    assert sorted(f.psk for f in founds) == sorted([PSK, psk2])
    assert store.lookup(e2, words) == [_pmk(w, e2) for w in words]


def test_resume_skip_across_cached_blocks(tmp_path):
    store = tps.PMKStore(str(tmp_path))
    words = [b"resume-%04d" % i for i in range(127)] + [PSK]
    _seed(store, words[:64])
    _seed(store, words[96:112:2])
    skip = 48
    consumed = []
    founds = _crack(_engine(store), words, skip=skip,
                    on_batch=lambda c, f: consumed.append(c))
    assert [f.psk for f in founds] == [PSK]
    assert sum(consumed) == len(words) - skip
    assert store.lookup(ESSID, words[skip:]) == [_pmk(w) for w in words[skip:]]


def test_mixed_block_pbkdf2_runs_on_the_miss_width(tmp_path, monkeypatch):
    """A mixed block hashes only its bucketed miss sub-batch: the PBKDF2
    sees ``miss_width`` rows, never the full batch."""
    store = tps.PMKStore(str(tmp_path))
    words = [b"width-%04d" % i for i in range(31)] + [PSK]
    _seed(store, words[3:])
    rows = []
    monkeypatch.setattr(tm, "_pmk_impl",
                        lambda pw, s1, s2: (rows.append(pw.shape[0]), hashlib_pmk(pw, s1, s2))[1])
    founds = _crack(_engine(store), words)
    assert [f.psk for f in founds] == [PSK]
    assert rows == [tps.miss_width(32, 1, 3)] == [4]
    assert store.lookup(ESSID, words[:3]) == [_pmk(w) for w in words[:3]]


def test_pmkstore_metrics_through_engine(tmp_path):
    reg = MetricsRegistry()
    store = tps.PMKStore(str(tmp_path), registry=reg)
    words = [b"obsword-%04d" % i for i in range(31)] + [PSK]
    _crack(_engine(store), words, registry=reg)
    assert reg.value("dwpa_pmkstore_misses_total") >= len(words)
    assert reg.value("dwpa_pmkstore_writes_total") == len(words)
    _crack(_engine(store, seed="pmks-2"), words, registry=reg)
    assert reg.value("dwpa_pmkstore_hits_total") >= len(words)
    assert 0 < reg.value("dwpa_pmkstore_hit_ratio") < 1

"""The port's packed-dictionary cache held to ``dwpa_tpu``'s, exactly.

- file formats: a ``.dcache`` and an ``.rbase`` written by the port are
  byte for byte the JAX package's for the same dict, and each package
  reads the other's entry warm;
- block streams: ``DictFeedSource`` and ``RulesFeedSource``, cold and
  warm, equal JAX's block for block (offsets, counts, words, packed rows
  and lengths, the rules split) at several batch sizes and skips, and a
  warm block carries what the cold block's words pack to;
- the fault cases of ``tests/test_dictcache.py``: a torn tail, CRC
  corruption, a dhash mismatch, LRU eviction under the byte cap, a
  partial consume that never commits, a missing native packer; and a
  cold pass that skips into a dict, which the port leaves uncached;
- the engine: ``crack_blocks`` warm against cold and against the JAX
  engine — the founds and the ``on_batch`` counts — and warm blocks
  through the PMK store's split.  ``crack_rules_blocks`` on warm
  ``RulesPrep`` blocks is held to JAX's in ``test_torch_rules.py``, beside
  the JAX rules-step compile it shares.

The port's PBKDF2 is ``hashlib_pmk`` here (the plain torch PBKDF2 at 4096
iterations takes minutes on a CPU); the JAX side runs its own.
"""

import gzip
import os
import shutil

import jax
import numpy as np
import pytest
from test_torch_rules import BATCH as RULES_BATCH
from test_torch_rules import _engine_words
from torch_fixtures import SLICE_PSK, five_net_group, hashlib_pmk

from dwpa_tpu import feed as jfeed
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.obs import MetricsRegistry as JRegistry
from dwpa_tpu.parallel import default_mesh
from dwpa_tpu_torch import feed as tfeed
from dwpa_tpu_torch.feed import dictcache as tdc
from dwpa_tpu_torch.gen.dicts import md5_file
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.native import pack_candidates_fast
from dwpa_tpu_torch.obs import MetricsRegistry


def _seeded_words(n=1200, seed=2026):
    """Seeded words of 1-70 bytes over printable ASCII and bytes >= 128
    (no line breaks: ``DictStream`` splits on them)."""
    rng = np.random.default_rng(seed)
    alphabet = np.array([b for b in range(32, 256) if b != 127], np.uint8)
    return [bytes(rng.choice(alphabet, int(k))) for k in rng.integers(1, 71, n)]


#: every packer and rules-split edge — ``$HEX`` decode (valid, too short,
#: non-hex), the 8/63 length filter, 64+ byte bases (rules fallback),
#: ``HEX[`` carriers — then seeded words
WORDS = (
    [b"$HEX[70617373776f72643132]", b"$HEX[616263]", b"$HEX[zzzz]", b"short",
     b"x" * 63, b"y" * 64, b"z" * 70, b"eight888", b"plainHEX[word"]
    + _seeded_words()
)


def _dict_file(tmp_path, words, tag=b""):
    """A gz dict named ``<dhash>.gz`` (the client's naming): (path, dhash)."""
    blob = b"\n".join(list(words) + ([tag] if tag else [])) + b"\n"
    tmp = os.path.join(str(tmp_path), "staging.gz")
    with gzip.open(tmp, "wb") as f:
        f.write(blob)
    dhash = md5_file(tmp)
    path = os.path.join(str(tmp_path), dhash + ".gz")
    os.replace(tmp, path)
    return path, dhash


def _two_dicts(tmp_path):
    return [_dict_file(tmp_path, WORDS), _dict_file(tmp_path, WORDS[:301], tag=b"second-dict")]


def _caches(tmp_path):
    """One cache per package, and the port cache's registry: (port, JAX,
    registry)."""
    reg = MetricsRegistry()
    return (tdc.DictCache(str(tmp_path / "torch"), registry=reg),
            jfeed.DictCache(str(tmp_path / "jax"), registry=JRegistry()), reg)


def _blocks_served(reg):
    """(hit, miss) blocks counted by a port cache's registry."""
    return tuple(int(reg.value(f"dwpa_dictcache_{k}_blocks_total") or 0)
                 for k in ("hit", "miss"))


def _dict_blocks(pkg, units, cache, bs, skip=0):
    """Drain a ``DictFeedSource`` of ``pkg`` (``tfeed`` or ``jfeed``)
    through its ``CandidateFeed``: ([(offset, count, padded, words, rows,
    lens, nvalid)], skipped), packed preps copied out of the mmap."""
    src = pkg.DictFeedSource(units, batch_size=bs, cache=cache, skip=skip)
    reg = MetricsRegistry() if pkg is tfeed else JRegistry()
    feed = pkg.CandidateFeed(None, batch_size=bs, frames=src, producers=1, prepack=None,
                             registry=reg)
    out = []
    try:
        for b in feed:
            rows = lens = nv = None
            if b.prep is not None:
                rows, lens, nv = np.array(b.prep[0]), np.array(b.prep[1]), b.prep[2]
            out.append((b.offset, b.count, b.padded, list(b.words), rows, lens, nv))
    finally:
        feed.close()
    return out, src.skipped


def _rules_blocks(pkg, units, cache, bs):
    """Drain a ``RulesFeedSource``: ([(offset, count, words, rows, lens,
    nplain, fallback)], skipped); cold blocks carry no prep."""
    src = pkg.RulesFeedSource(units, batch_size=bs, cache=cache)
    out = []
    for b in src:
        p = b.prep
        out.append((b.offset, b.count, list(b.words))
                   + ((None,) * 4 if p is None else
                      (np.array(p.rows), np.array(p.lens), p.nplain, [bytes(w) for w in p.fallback])))
    return out, src.skipped


def _same(a, b):
    """Blocks equal field by field (arrays by value)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                assert np.array_equal(u, v) and u.dtype == v.dtype
            else:
                assert u == v


def _warm_packs_cold(cold, warm, bs):
    """A warm dict block carries exactly what the native packer makes of
    the cold block's words."""
    assert [c[:3] for c in cold] == [w[:3] for w in warm]
    for c, w in zip(cold, warm):
        assert w[3] == []                     # warm never decodes words
        rows, lens, nv = pack_candidates_fast(c[3], 8, 63, capacity=bs)
        assert nv == w[6] and np.array_equal(rows, w[4])
        assert np.array_equal(np.asarray(lens[:nv], np.uint8), w[5])


def _warm_splits_cold(cold, warm):
    """A warm rules block carries the engine's split of the cold block's
    words: eligible bases packed with their raw lengths, the rest verbatim."""
    assert [c[:2] for c in cold] == [w[:2] for w in warm]
    for c, w in zip(cold, warm):
        plain = [x for x in c[2] if tdc._MAX_LEN >= len(x) and b"HEX[" not in x]
        assert w[2] == [] and w[5] == len(plain)
        assert w[6] == [x for x in c[2] if len(x) > tdc._MAX_LEN or b"HEX[" in x]
        assert list(w[4]) == [len(x) for x in plain]
        if plain:
            assert np.array_equal(w[3], pack_candidates_fast(plain, 0, 63)[0])


# ---------------------------------------------------------------------------
# file formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rules", [False, True], ids=["dcache", "rbase"])
def test_cache_files_byte_identical_and_cross_read(tmp_path, rules):
    """The same cold pass writes the same bytes in both packages, and each
    package serves the other's entry warm, block for block as its own."""
    units = _two_dicts(tmp_path)
    tc, jc, _ = _caches(tmp_path)
    drain = _rules_blocks if rules else _dict_blocks
    ext = ".rbase" if rules else ".dcache"
    for pkg, cache in ((tfeed, tc), (jfeed, jc)):
        drain(pkg, units, cache, 256)
    for _, h in units:
        with open(tc._path(h, ext), "rb") as f, open(jc._path(h, ext), "rb") as g:
            mine = f.read()
            assert mine == g.read() and len(mine) > tdc.HEADER
    own = {pkg: drain(pkg, units, cache, 256) for pkg, cache in ((tfeed, tc), (jfeed, jc))}
    # each package over the other's directory: all hits, the same blocks
    reg, jreg = MetricsRegistry(), JRegistry()
    cross = {tfeed: drain(tfeed, units, tdc.DictCache(jc.root, registry=reg), 256),
             jfeed: drain(jfeed, units, jfeed.DictCache(tc.root, registry=jreg), 256)}
    for pkg in (tfeed, jfeed):
        _same(cross[pkg][0], own[pkg][0])
    _same(own[tfeed][0], own[jfeed][0])
    assert _blocks_served(reg) == (len(own[tfeed][0]), 0)
    assert jreg.value("dwpa_dictcache_hit_blocks_total") == len(own[tfeed][0])
    assert not jreg.value("dwpa_dictcache_miss_blocks_total")


# ---------------------------------------------------------------------------
# block streams against the JAX sources
# ---------------------------------------------------------------------------

TOTAL = len(WORDS) + 302
GEOMETRIES = [(256, 0), (256, 100), (64, len(WORDS) - 1), (100, len(WORDS) + 5),
              (1000, TOTAL - 1), (4096, TOTAL + 99)]


@pytest.mark.parametrize("bs,skip", GEOMETRIES)
def test_dict_feed_source_streams_match_jax(tmp_path, bs, skip):
    """Cold and warm, at skips mid-dict, across the dict boundary and past
    every word: the port's blocks and ``skipped`` equal JAX's, and the
    warm blocks carry what the cold blocks' words pack to."""
    units = _two_dicts(tmp_path)
    tc, jc, reg = _caches(tmp_path)
    cold = _dict_blocks(tfeed, units, None, bs, skip)
    _same(cold[0], _dict_blocks(jfeed, units, None, bs, skip)[0])
    assert cold[1] == _dict_blocks(jfeed, units, None, bs, skip)[1] == min(skip, TOTAL)
    filling = _dict_blocks(tfeed, units, tc, bs)          # writes both entries
    _same(filling[0], _dict_blocks(jfeed, units, jc, bs)[0])
    warm = _dict_blocks(tfeed, units, tc, bs, skip)
    jwarm = _dict_blocks(jfeed, units, jc, bs, skip)
    _same(warm[0], jwarm[0])
    assert warm[1] == jwarm[1] == cold[1]
    _warm_packs_cold(cold[0], warm[0], bs)
    if skip < TOTAL:
        assert warm[0][0][0] == skip
    assert _blocks_served(reg) == (len(warm[0]), len(filling[0]))


@pytest.mark.parametrize("bs", [33, 64, 100, 256, 1000, 4096])
def test_rules_feed_source_streams_match_jax(tmp_path, bs):
    """The ``.rbase`` twin: cold word blocks and warm ``RulesPrep`` blocks
    equal JAX's (rows, raw lengths, the fallback words), and a warm block
    is the engine's split and pack of the cold block's words.  The source
    takes no skip (the engine owns the rules resume window)."""
    units = _two_dicts(tmp_path)
    tc, jc, _ = _caches(tmp_path)
    cold = _rules_blocks(tfeed, units, None, bs)
    _same(cold[0], _rules_blocks(jfeed, units, None, bs)[0])
    _rules_blocks(tfeed, units, tc, bs)
    _rules_blocks(jfeed, units, jc, bs)
    warm = _rules_blocks(tfeed, units, tc, bs)
    jwarm = _rules_blocks(jfeed, units, jc, bs)
    _same(warm[0], jwarm[0])
    assert warm[1] == jwarm[1] == cold[1] == 0
    assert sum(b[1] for b in warm[0]) == TOTAL
    _warm_splits_cold(cold[0], warm[0])
    assert all(hasattr(b.prep, "rules_base")
               for b in tfeed.RulesFeedSource(units, bs, cache=tc))


def test_cold_skip_into_a_dict_writes_no_entry(tmp_path):
    """A cold pass whose resume window ends inside a dict streams that
    dict's tail only, so the port writes no entry for it (the next pass
    from word 0 fills it); the JAX source commits the tail as the whole
    dict — a later warm pass would serve 700 of 1000 words at offsets
    0-699."""
    path, h = _dict_file(tmp_path, WORDS[:1000])
    tc, jc, reg = _caches(tmp_path)
    for pkg, cache in ((tfeed, tc), (jfeed, jc)):
        blocks, skipped = _dict_blocks(pkg, [(path, h)], cache, 256, skip=300)
        assert skipped == 300 and sum(b[1] for b in blocks) == 700
    assert tc.entry(h, fill=False)[0] is None and os.listdir(tc.root) == []
    assert jc.reader(h).total_words == 700          # the reference's entry
    full, _ = _dict_blocks(tfeed, [(path, h)], tc, 256)
    assert _blocks_served(reg) == (0, 3 + 4) and tc.entry(h, fill=False)[0].total_words == 1000
    warm, _ = _dict_blocks(tfeed, [(path, h)], tc, 256)
    _warm_packs_cold(full, warm, 256)


def test_entry_is_one_warm_cold_decision(tmp_path):
    """``entry`` returns a reader for a complete entry, else a writer only
    when the pass fills from word 0, and nothing for a malformed key or
    without the native packer; each species separately."""
    path, h = _dict_file(tmp_path, WORDS[:50])
    cache = tdc.DictCache(str(tmp_path / "dc"))
    for rules, species in ((False, ".dcache"), (True, ".rbase")):
        assert cache.entry(h, rules=rules, fill=False) == (None, None)
        rd, wr = cache.entry(h, rules=rules)
        assert rd is None and isinstance(wr, tdc.RulesBaseWriter if rules else tdc.DictCacheWriter)
        wr.add_many(WORDS[:50])
        assert wr.commit() and os.path.exists(cache._path(h, species))
        rd, wr = cache.entry(h, rules=rules)
        assert wr is None and rd.total_words == 50
    assert cache.entry("not-a-dhash") == (None, None) == cache.entry(None, rules=True)
    cache._native_ok = False
    assert cache.entry("0" * 32) == (None, None)


# ---------------------------------------------------------------------------
# fault cases (tests/test_dictcache.py's, on the port)
# ---------------------------------------------------------------------------


def _flip_middle_byte(entry):
    with open(entry, "r+b") as f:
        f.seek(os.path.getsize(entry) // 2)  # inside some chunk payload
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _tear_tail(entry):
    with open(entry, "r+b") as f:
        f.truncate(os.path.getsize(entry) - 13)  # mid-frame, not a boundary


@pytest.mark.parametrize("damage", [_tear_tail, _flip_middle_byte], ids=["torn", "crc"])
@pytest.mark.parametrize("rules", [False, True], ids=["dcache", "rbase"])
def test_damaged_entry_falls_back_cold_with_correct_words(tmp_path, damage, rules):
    path, h = _dict_file(tmp_path, WORDS)
    cache = tdc.DictCache(str(tmp_path / "dc"))
    drain = _rules_blocks if rules else _dict_blocks
    cold, _ = drain(tfeed, [(path, h)], cache, 256)
    damage(cache._path(h, ".rbase" if rules else ".dcache"))
    assert cache.entry(h, rules=rules, fill=False) == (None, None)
    again, _ = drain(tfeed, [(path, h)], cache, 256)
    _same(again, cold)                       # cold again: the same word blocks
    assert cache.entry(h, rules=rules, fill=False)[0] is not None   # rewritten


def test_dhash_mismatch_invalidates(tmp_path):
    """An entry keyed to different dict bytes reads as a miss — the
    embedded-dhash check, independent of the filename."""
    path, h = _dict_file(tmp_path, WORDS)
    cache = tdc.DictCache(str(tmp_path / "dc"))
    _dict_blocks(tfeed, [(path, h)], cache, 256)
    other = "f" * 32
    os.replace(cache._path(h), cache._path(other))
    assert cache.entry(other, fill=False)[0] is None
    assert cache.entry(h, fill=False)[0] is None
    assert cache.entry("not-a-dhash", fill=False)[0] is None


def test_eviction_under_byte_cap_is_lru(tmp_path):
    reg = MetricsRegistry()
    cache = tdc.DictCache(str(tmp_path / "dc"), registry=reg)
    units = []
    for k in range(3):
        p, h = _dict_file(tmp_path, WORDS[:900], tag=b"evict-%d" % k)
        units.append((p, h))
        _dict_blocks(tfeed, [(p, h)], cache, 256)
    sizes = {h: os.path.getsize(cache._path(h)) for _, h in units}
    assert cache.entry(units[0][1], fill=False)[0] is not None    # dict 1 is now the LRU victim
    cache.max_bytes = sum(sizes.values()) - 1
    cache.evict()
    assert cache.entry(units[1][1], fill=False)[0] is None
    assert cache.entry(units[0][1], fill=False)[0] is not None
    assert cache.entry(units[2][1], fill=False)[0] is not None
    assert cache._bytes_used() <= cache.max_bytes
    assert reg.value("dwpa_dictcache_bytes") == cache._bytes_used()


@pytest.mark.parametrize("rules", [False, True], ids=["dcache", "rbase"])
def test_partial_consume_never_commits(tmp_path, rules):
    """A consumer that stops mid-dict aborts the write: a partial entry
    served warm would silently truncate the keyspace."""
    path, h = _dict_file(tmp_path, WORDS)
    cache = tdc.DictCache(str(tmp_path / "dc"))
    src = (tfeed.RulesFeedSource if rules else tfeed.DictFeedSource)([(path, h)], 64, cache=cache)
    for _ in src:
        break
    assert cache.entry(h, rules=rules, fill=False) == (None, None)
    assert os.listdir(cache.root) == []


def test_native_packer_absent_stays_cold_and_correct(tmp_path):
    path, h = _dict_file(tmp_path, WORDS[:50])
    cache = tdc.DictCache(str(tmp_path / "dc"))
    cache._native_ok = False
    assert cache.entry(h) == cache.entry(h, rules=True) == (None, None)
    blocks, _ = _dict_blocks(tfeed, [(path, h)], cache, 256)
    assert [w for b in blocks for w in b[3]] == WORDS[:50]
    assert os.listdir(cache.root) == []


# ---------------------------------------------------------------------------
# the engine: warm against cold and against the JAX engine
# ---------------------------------------------------------------------------


def _found_key(f):
    return (f.line.raw, f.psk, f.nc, f.endian, f.pmk)


def test_warm_blocks_compose_with_the_pmk_store_split(monkeypatch, tmp_path):
    """``host_packer``'s ``pre=`` bypass hands a warm block's rows to the
    PMK store's split as JAX's does: a cold pass fills the dict cache and
    the store, and the warm pass (every block a cache hit and every word a
    store hit) gives the same founds and counts as a plain cold run."""
    from dwpa_tpu_torch.pmkstore import MixedPrep, PMKStore

    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    words = [b"store-dcache-%04d" % i for i in range(90)] + [SLICE_PSK]
    units = [_dict_file(tmp_path, words)]
    tc, _, reg = _caches(tmp_path)
    lines = five_net_group()
    plain = _crack(tfeed, tm.M22000Engine(lines, batch_size=32, device="cpu"), units, None, 0)
    sreg = MetricsRegistry()
    store = PMKStore(str(tmp_path / "store"), registry=sreg)
    seen = []
    for _ in ("cold", "warm"):
        eng = tm.M22000Engine(lines, batch_size=32, device="cpu", pmk_store=store)
        pack = eng.host_packer()

        def spy(words, pre=None, pack=pack):
            out = pack(words, pre=pre)
            seen.append((pre is not None, isinstance(out, MixedPrep)))
            return out

        spy.supports_pre = True
        monkeypatch.setattr(eng, "host_packer", lambda spy=spy: spy)
        assert _crack(tfeed, eng, units, tc, 0) == plain
    assert seen == [(False, True)] * 3 + [(True, True)] * 3
    assert _blocks_served(reg) == (3, 3)
    assert sreg.value("dwpa_pmkstore_hits_total") == len(words)
    store.close()


def _jengine(lines, batch_size):
    """The JAX engine on a one-device CPU mesh (the port's engine is one
    device; an 8-device mesh adds collectives the reference does not
    need here)."""
    return jm.M22000Engine(lines, batch_size=batch_size,
                           mesh=default_mesh(devices=jax.devices()[:1]))


def _crack(pkg, engine, units, cache, skip):
    """(sorted founds, on_batch counts) of ``crack_blocks`` over a
    ``DictFeedSource`` with the engine's host packer."""
    consumed = []
    src = pkg.DictFeedSource(units, batch_size=engine.batch_size, cache=cache, skip=skip)
    feed = pkg.CandidateFeed(None, batch_size=engine.batch_size, frames=src, producers=1,
                             prepack=engine.host_packer(),
                             registry=MetricsRegistry() if pkg is tfeed else JRegistry())
    try:
        founds = engine.crack_blocks(feed, on_batch=lambda c, f: consumed.append(c))
    finally:
        feed.close()
    return sorted(map(_found_key, founds)), consumed


@pytest.mark.parametrize("skip", [0, 37, 130])
def test_crack_blocks_warm_equals_cold_and_jax(monkeypatch, tmp_path, skip):
    """Five nets, the PSK in the dict's last block: the warm run's founds
    and per-block counts equal the cold run's and the JAX engine's (cold,
    and warm from the port's entry file), with and without a resume
    skip."""
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    # one key width (W = 4) keeps the JAX side to one compile; the
    # packer's edges ride along: a $HEX word, and filtered ones
    words = ([b"engine-%04d-word" % i for i in range(157)]
             + [b"$HEX[70617373776f72643132]", b"short", b"y" * 64, SLICE_PSK])
    units = [_dict_file(tmp_path, words)]
    tc, jc, reg = _caches(tmp_path)
    lines = five_net_group()

    def teng():
        return tm.M22000Engine(lines, batch_size=32, device="cpu")

    _crack(tfeed, teng(), units, tc, 0)                       # fills the entry
    shutil.copy(tc._path(units[0][1]), jc._path(units[0][1]))
    cold = _crack(tfeed, teng(), units, None, skip)
    warm = _crack(tfeed, teng(), units, tc, skip)
    jcold = _crack(jfeed, _jengine(lines, 32), units, None, skip)
    jwarm = _crack(jfeed, _jengine(lines, 32), units, jc, skip)
    assert warm == cold == jcold == jwarm
    assert len(warm[0]) == len(lines)
    assert sum(warm[1]) == len(words) - skip
    assert _blocks_served(reg) == (len(warm[1]), 6)




def test_warm_rules_block_rows_never_alias_the_mmap(tmp_path):
    """A warm rules block's rows, lengths and the rows it uploads are
    arrays of their own, so no tensor ever views the mmap that eviction
    may unlink."""
    units = [_dict_file(tmp_path, _engine_words())]
    cache = tdc.DictCache(str(tmp_path / "dc"))
    list(tfeed.RulesFeedSource(units, RULES_BATCH, cache=cache))
    blk = list(tfeed.RulesFeedSource(units, RULES_BATCH, cache=cache))[1]
    rows = blk.prep.padded_rows(64)
    for a in (blk.prep.rows, blk.prep.lens, rows):
        assert a.flags.owndata and a.flags.writeable
    assert rows.dtype == np.uint32 and np.array_equal(rows[:blk.prep.nplain], blk.prep.rows)
    shutil.rmtree(cache.root)                 # the entry is gone; the block is not
    assert [bytes(w) for w in blk.prep.fallback] == [b"y" * 70]
    base = tm._BaseWords(blk.prep.rows, blk.prep.lens, blk.prep.nplain)
    assert list(base) == [w for w in _engine_words()[RULES_BATCH:2 * RULES_BATCH]
                          if w != b"y" * 70]

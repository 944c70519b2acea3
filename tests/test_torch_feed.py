"""The port's native packer, candidate feed, stager and ``crack_blocks``
against the JAX package.

Both packages get the same seeded inputs (numpy); every comparison is
exact.  The port's engine runs on the CPU with hashlib PMKs
(``hashlib_pmk``), as in test_torch_m22000.py; the JAX engine runs its
own full path.
"""

import threading

import numpy as np
import pytest
import torch
from torch_fixtures import five_net_group, hashlib_pmk, slice_dictionary

from dwpa_tpu import feed as jfeed
from dwpa_tpu import native as jnative
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.obs import MetricsRegistry as JRegistry
from dwpa_tpu_torch import feed as tfeed
from dwpa_tpu_torch import native as tnative
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.obs import MetricsRegistry
from dwpa_tpu_torch.oracle.m22000 import hc_unhex
from dwpa_tpu_torch.utils import bytesops as bo


def seeded_words(n, seed=3):
    """``n`` seeded candidates: lengths 1..70 (so the filter drops some),
    a few in ``$HEX[...]`` form, one malformed ``$HEX``."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, int(k), dtype=np.uint8))
             for k in rng.integers(1, 71, n)]
    for i in range(0, n, 7):
        words[i] = b"$HEX[" + words[i][:40].hex().encode() + b"]"
    if n > 5:
        words[5] = b"$HEX[zz" + b"00" * 5 + b"]"
    return words


def block_key(b):
    return (b.offset, b.count, list(b.words), b.padded)


def _feed_threads():
    return [t for t in threading.enumerate() if t.name.startswith("dwpa-feed")]


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 47, 97, 200])
@pytest.mark.parametrize("bs", [4, 13, 16])
def test_frame_blocks_match_jax(n, bs):
    words = seeded_words(n)
    for nproc in (1, 3):
        for pid in range(nproc):
            for base in (0, 1000):
                kw = dict(nproc=nproc, pid=pid, pad_word=b"", base_offset=base)
                got = [block_key(b) for b in tfeed.frame_blocks(iter(words), bs, **kw)]
                ref = [block_key(b) for b in jfeed.frame_blocks(iter(words), bs, **kw)]
                assert got == ref, (n, bs, nproc, pid, base)


@pytest.mark.parametrize("k", [0, 4, 10, 30])
def test_skip_stream_matches_jax(k):
    words = seeded_words(12)
    a, b = iter(words), iter(words)
    assert tfeed.skip_stream(a, k) == jfeed.skip_stream(b, k)
    assert list(a) == list(b)


# ---------------------------------------------------------------------------
# the feed pipeline
# ---------------------------------------------------------------------------


def feed_pair(words, bs, producers, skip, prepack=None, jprepack=None, **kw):
    port = tfeed.CandidateFeed(iter(words), bs, producers=producers, skip=skip,
                               prepack=prepack, registry=MetricsRegistry(), **kw)
    ref = jfeed.CandidateFeed(iter(words), bs, producers=producers, skip=skip,
                              nproc=1, pid=0, prepack=jprepack,
                              registry=JRegistry(), **kw)
    try:
        got, exp = list(port), list(ref)
        return got, exp, port.skipped, ref.skipped
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("producers", [0, 1, 2])
@pytest.mark.parametrize("bs,skip", [(16, 0), (13, 5), (64, 40), (7, 500)])
def test_candidate_feed_blocks_match_jax(producers, bs, skip):
    words = seeded_words(230)
    got, exp, skipped, jskipped = feed_pair(words, bs, producers, skip, depth=2)
    assert [block_key(b) for b in got] == [block_key(b) for b in exp]
    assert skipped == jskipped == min(skip, len(words))
    assert not _feed_threads()


@pytest.mark.parametrize("producers", [0, 1, 2])
def test_candidate_feed_prepack_matches_jax(producers):
    """Prepacked blocks carry the same ``(rows, lens, nvalid)`` as the
    JAX engine's host packer makes for them."""
    words = seeded_words(150, seed=8)
    lines = five_net_group()
    teng = tm.M22000Engine(lines, batch_size=32, device="cpu")
    jeng = jm.M22000Engine(lines, batch_size=32)
    got, exp, _, _ = feed_pair(words, 32, producers, 3, prepack=teng.host_packer(),
                               jprepack=jeng.host_packer())
    assert [block_key(b) for b in got] == [block_key(b) for b in exp]
    for g, e in zip(got, exp):
        (grows, glens, gn), (erows, elens, en) = g.prep, e.prep
        assert gn == en
        np.testing.assert_array_equal(grows, erows)
        np.testing.assert_array_equal(glens, elens)


@pytest.mark.parametrize("producers", [0, 1, 2])
def test_producer_fault_offset_matches_jax(producers):
    def faulty():
        for i in range(200):
            if i == 150:
                raise ValueError("disk on fire")
            yield b"x%06d" % i

    errs = []
    for pkg, reg in ((tfeed, MetricsRegistry()), (jfeed, JRegistry())):
        feed = pkg.CandidateFeed(faulty(), batch_size=64, producers=producers,
                                 registry=reg)
        got = []
        with pytest.raises(pkg.FeedError) as e:
            for b in feed:
                got.append(b.offset)
        feed.close()
        errs.append((got, e.value.offset, type(e.value.__cause__), str(e.value)))
    assert errs[0] == errs[1]
    assert errs[0][:2] == ([0, 64], 128)
    assert not _feed_threads()


def test_feed_telemetry_and_backpressure():
    reg = MetricsRegistry()
    pulled = [0]

    def src():
        for i in range(40 * 16):
            pulled[0] += 1
            yield b"c%06d" % i

    feed = tfeed.CandidateFeed(src(), batch_size=16, depth=2, registry=reg, name="t1")
    taken = 0
    for _ in feed:
        taken += 1
        # frames in flight <= depth; +1 block may be mid-framing
        assert pulled[0] <= (taken + 2 + 1) * 16
    feed.close()
    assert taken == 40
    assert reg.value("dwpa_feed_blocks_total", feed="t1") == 40
    assert reg.value("dwpa_feed_candidates_total", feed="t1") == 640
    assert reg.value("dwpa_feed_bytes_total", feed="t1") == 7 * 640
    assert reg.value("dwpa_feed_consumer_starve_seconds", feed="t1") == 40
    assert reg.value("dwpa_span_seconds", span="feed:produce") == 40
    assert not _feed_threads()


# ---------------------------------------------------------------------------
# the native packer
# ---------------------------------------------------------------------------


PACK_CASES = [
    [b"password01", b"short", b"okaypass9"],
    [b"$HEX[41414141415a5a5a]", b"$HEX[zzzz]pad", b"$HEX[61]"],
    [b"x" * 63, b"x" * 64, b"y" * 8, b"z" * 7],
    [b"$HEX[" + b"61" * 63 + b"]", b"$HEX[" + b"62" * 64 + b"]"],
    [bytes(range(8, 40)), b"emb\x00edded0", b"nl\nin\nword"],
    [b"$HEX[4141414141414141"],
    [],
    [b"", b"\r\n", b"1234567"],
]


@pytest.mark.parametrize("case", range(len(PACK_CASES) + 1))
def test_pack_candidates_fast_matches_jax_and_python(case):
    words = PACK_CASES[case] if case < len(PACK_CASES) else seeded_words(300, seed=5)
    before = tnative.CALLS
    got = tnative.pack_candidates_fast(words, 8, 63, capacity=64)
    ref = jnative.pack_candidates_fast(words, 8, 63, capacity=64)
    assert tnative.CALLS == before + 1
    assert got[2] == ref[2]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    valid = [p for p in (hc_unhex(w) for w in words) if 8 <= len(p) <= 63]
    assert got[2] == len(valid)
    if valid:
        np.testing.assert_array_equal(got[0][:len(valid)], bo.pack_passwords_be(valid))
        assert list(got[1]) == [len(p) for p in valid]
    assert not got[0][len(valid):].any()


def test_native_library_builds_outside_the_package():
    from dwpa_tpu_torch.ops import _nvcc

    lib = tnative.load_pack()
    assert lib is not None
    so = _nvcc.library_path(tnative._PACK_SRC)
    assert so.exists() and so.parent == _nvcc.BUILD_DIR
    assert not list(tnative._PACK_SRC.parent.glob("*.so"))


def test_pack_refuses_non_bytes():
    assert tnative.pack_candidates_fast(["str-word-1"], 8, 63) is None


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self, with_stager):
        self.device = torch.device("cpu")
        self.staged = []
        self.with_stager = with_stager

    def _prepare_block(self, blk, stager=None):
        self.staged.append(blk.offset)
        return ("prep", blk.offset)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_device_stager_order_matches_jax(depth):
    blocks = [tfeed.Block(offset=i * 4, count=4, words=[b"w"] * 4) for i in range(5)]
    runs = []
    for stager_cls, with_stager in ((tfeed.DeviceStager, True),
                                    (jfeed.DeviceStager, False)):
        eng = _FakeEngine(with_stager)
        if not with_stager:  # the JAX stager calls _prepare_block(blk)
            eng._prepare_block = lambda blk, e=eng: (e.staged.append(blk.offset),
                                                     ("prep", blk.offset))[1]
        seen = []
        for blk, prep in stager_cls(eng, iter(blocks), depth=depth):
            # block N is handed over with N+1..N+depth already staged
            seen.append((blk.offset, prep, list(eng.staged)))
        runs.append(seen)
    assert runs[0] == runs[1]
    for i, (off, prep, staged) in enumerate(runs[0]):
        assert staged == [b.offset for b in blocks[:min(len(blocks), i + depth + 1)]]


def test_device_stager_rows_equal_host_rows_on_cpu():
    eng = tm.M22000Engine(five_net_group(), batch_size=16, device="cpu")
    words = seeded_words(80, seed=11)
    blocks = list(tfeed.CandidateFeed(iter(words), 16, producers=0,
                                      prepack=eng.host_packer(),
                                      registry=MetricsRegistry()))
    stager = tfeed.DeviceStager(eng, iter(blocks), depth=2)
    out = list(stager)
    assert stager.staged == len(blocks) and stager.stream is None
    assert [b.offset for b, _ in out] == [b.offset for b in blocks]
    for blk, prep in out:
        rows, lens, nvalid = blk.prep
        if nvalid == 0:
            assert prep is None
            continue
        w = tm._trim_cols(int(lens.max()))
        assert prep[1] == nvalid
        np.testing.assert_array_equal(
            prep[2].numpy(), rows[:max(16, nvalid), :w].view(np.int32))


@pytest.mark.parametrize("traced", [True, False])
def test_device_stager_spans_come_from_the_engine(traced):
    """With a tracer on the engine every pull is a ``feed:next`` span (the
    last meets the stream's end) and every staging a ``feed:stage``; an
    engine without one gives a stager that opens none."""
    from dwpa_tpu_torch.obs import SpanTracer

    tracer = SpanTracer(MetricsRegistry())
    eng = tm.M22000Engine(five_net_group(), batch_size=8, device="cpu",
                          tracer=tracer if traced else None)
    stager = tfeed.DeviceStager(eng, tfeed.frame_blocks(iter(seeded_words(40, seed=5)), 8))
    n = sum(1 for _ in stager)
    assert n == stager.staged == 5
    names = [r["name"] for r in tracer.records()]
    assert (names.count("feed:next"), names.count("feed:stage")) == ((6, 5) if traced else (0, 0))


def test_device_stager_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class NoDevice:
        device = None

    with pytest.raises(RuntimeError):
        tfeed.DeviceStager(NoDevice(), iter(()))


def test_prepare_block_refuses_unported_preps(tmp_path):
    """The mask and PMK-store preps, which ``_prepare_block`` refused
    until they were ported, now prepare: a mask block generates its own
    rows, a store-split block stages its misses."""
    from dwpa_tpu_torch.gen.mask import MaskPrep, device_mask_words
    from dwpa_tpu_torch.pmkstore import MixedPrep, PMKStore

    eng = tm.M22000Engine(five_net_group(), batch_size=16, device="cpu",
                          pmk_store=PMKStore(str(tmp_path)))
    blk = tfeed.Block(offset=5, count=3, words=[], prep=MaskPrep("?d" * 8, None, 5))
    pws, nvalid, rows = eng._prepare_block(blk)
    assert nvalid == 3 and pws[2] == b"00000007"
    assert torch.equal(rows, device_mask_words("?d" * 8, 5, 3, device="cpu"))
    words = [b"feedword-%02d" % i for i in range(10)]
    mixed = eng.host_packer()(words)
    assert isinstance(mixed, MixedPrep)
    pws, nvalid, prep = eng._prepare_block(
        tfeed.Block(offset=0, count=10, words=words, prep=mixed))
    assert nvalid == 10 and prep is mixed and pws[9] == words[9]
    assert [t.shape for t in prep.device_tensors()] == [(16, 4)]


# ---------------------------------------------------------------------------
# crack_blocks against the JAX engine
# ---------------------------------------------------------------------------


def found_key(f):
    return (f.line.raw, f.psk, f.nc, f.endian, f.pmk)


CRACK_WORDS = slice_dictionary() + [b"x"] * 20 + [b"tail-%05d" % i for i in range(10)]


@pytest.fixture(scope="module")
def jax_crack_blocks():
    """The JAX engine's ``crack_blocks`` over the framed CRACK_WORDS:
    its ``on_batch`` reports and founds (run once for the module)."""
    jeng = jm.M22000Engine(five_net_group(), batch_size=32)
    reports = []
    founds = jeng.crack_blocks(
        jfeed.frame_blocks(iter(CRACK_WORDS), 32),
        on_batch=lambda n, new: reports.append((n, sorted(map(found_key, new)))))
    return reports, founds


@pytest.mark.parametrize("prepack", [True, False])
def test_crack_blocks_on_batch_matches_jax(monkeypatch, prepack, jax_crack_blocks):
    lines = five_net_group()
    words = CRACK_WORDS
    jreports, jfounds = jax_crack_blocks
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    teng = tm.M22000Engine(lines, batch_size=32, device="cpu")
    feed = tfeed.CandidateFeed(iter(words), 32,
                               prepack=teng.host_packer() if prepack else None,
                               registry=MetricsRegistry())
    treports = []
    tfounds = teng.crack_blocks(
        feed, on_batch=lambda n, new: treports.append((n, sorted(map(found_key, new)))))
    feed.close()
    assert treports == jreports
    assert sorted(map(found_key, tfounds)) == sorted(map(found_key, jfounds))
    assert len(tfounds) == len(lines)


def test_crack_blocks_skips_invalid_block_but_reports_count(monkeypatch):
    monkeypatch.setattr(tm, "_pmk_impl", hashlib_pmk)
    eng = tm.M22000Engine([tfx.make_pmkid_line(b"skipblk-psk", b"SkipNet", seed="sb1")],
                          batch_size=16, device="cpu")
    words = [b"x"] * 16 + [b"valid-%05d" % i for i in range(16)]
    reg = MetricsRegistry()
    feed = tfeed.CandidateFeed(iter(words), 16, prepack=eng.host_packer(),
                               registry=reg, name="res")
    reports = []
    eng.crack_blocks(feed, on_batch=lambda c, f: reports.append(c))
    feed.close()
    assert reports == [16, 16]
    # producer pack time lives in the feed span, the engine keeps the keys
    assert reg.value("dwpa_span_seconds", span="feed:produce") == 2
    assert set(eng.stage_times) == {"prepare", "dispatch", "collect"}


def test_engine_native_and_python_paths_agree(monkeypatch):
    """``_prepare``'s native fast path and its Python fallback (str
    candidates force it) stage the same rows."""
    eng = tm.M22000Engine(five_net_group(), batch_size=16, device="cpu")
    words = seeded_words(40, seed=12)
    before = tnative.CALLS
    fast = eng._prepare(words)
    assert tnative.CALLS == before + 1
    monkeypatch.setattr(tm, "pack_candidates_fast", lambda *a, **k: None)
    slow = eng._prepare(words)
    assert fast[1] == slow[1]
    assert torch.equal(fast[2], slow[2])
    assert [fast[0][i] for i in range(fast[1])] == [slow[0][i] for i in range(slow[1])]

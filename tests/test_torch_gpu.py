"""The port on a CUDA device: the PBKDF2 kernel, the engine, the SM
probe kernel, the rule interpreter, the mask generator, the PMK
store's mixed blocks, mixed-ESSID unit fusion, the packed-dictionary
cache's warm blocks and the server pre-crack's batcher.

Every test here carries the ``gpu`` marker and takes the ``cuda_device``
fixture, which skips where there is no card.  On the GPU:

    python -m pytest -m gpu tests/test_torch_*.py

The file imports nothing of JAX, so on a machine without JAX it runs
alone with ``--noconftest``.
"""

import hashlib

import numpy as np
import pytest
import torch
from torch_fixtures import (  # noqa: F401  (cuda_device is a fixture)
    PBKDF2_ESSID, SLICE_ESSID, SLICE_PSK, cuda_device, five_net_group, pbkdf2_inputs, salt_essid,
    slice_dictionary)

from dwpa_tpu_torch.client.challenge import challenge
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import pbkdf2, pbkdf2_cuda, sm_probe
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.utils import bytesops as bo


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("w", [4, 8, 16])
def test_kernel_matches_plain(cuda_device, w, rank):  # noqa: F811
    _, packed, s1, s2 = pbkdf2_inputs(w, rank)
    args = [to_torch(a, cuda_device) for a in (packed[:, :w], s1, s2)]
    for iterations in (1, 2, 5):
        got = pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(*args, iterations=iterations)
        assert torch.equal(got, pbkdf2.pbkdf2_sha1_pmk(*args, iterations=iterations))


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [1, 2])
def test_kernel_matches_hashlib(cuda_device, rank):  # noqa: F811
    words, packed, s1, s2 = pbkdf2_inputs(16, rank)
    before = pbkdf2_cuda.LAUNCHES
    out = to_numpy(tm._pmk_impl(*(to_torch(a, cuda_device) for a in (packed, s1, s2))))
    assert pbkdf2_cuda.LAUNCHES == before + 1
    for i, word in enumerate(words):
        essid = PBKDF2_ESSID if rank == 1 else salt_essid(to_torch(s1[i], "cpu"))
        assert bo.words_to_bytes_be(out[:, i]) == hashlib.pbkdf2_hmac("sha1", word, essid, 4096, 32)


@pytest.mark.gpu
def test_kernel_wrapper_refuses_strided_rows(cuda_device):  # noqa: F811
    _, packed, s1, s2 = pbkdf2_inputs(16, 1)
    pw = to_torch(packed, cuda_device)[:, :8]
    with pytest.raises(ValueError):
        pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(pw, to_torch(s1, cuda_device), to_torch(s2, cuda_device))


@pytest.mark.gpu
def test_engine_and_challenge(cuda_device):  # noqa: F811
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    assert challenge(device=cuda_device)
    eng = tm.M22000Engine(five_net_group(), batch_size=32, device=cuda_device)
    founds = eng.crack(slice_dictionary())
    assert len(founds) == 5 and {f.psk for f in founds} == {SLICE_PSK}
    assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("mix", sorted(sm_probe.MIXES))
def test_probe_kernel_matches_plain(cuda_device, mix):  # noqa: F811
    rng = np.random.default_rng(11)
    for n in (1000, 132 * 128):  # a ragged edge, then whole blocks
        x = to_torch(rng.integers(0, 2**32, (5, n), dtype=np.uint64).astype(np.uint32),
                     cuda_device)
        for iters in (1, 2):
            before = sm_probe.LAUNCHES
            got = sm_probe.probe_cuda(x, mix, iters)
            assert sm_probe.LAUNCHES == before + 1
            assert torch.equal(got, sm_probe.probe_plain(x, mix, iters))


@pytest.mark.gpu
def test_stager_rows_equal_host_rows(cuda_device):  # noqa: F811
    """Five blocks staged on the side stream, two ahead of dispatch: each
    block's device rows equal its host rows when the compute stream
    reads them, while PBKDF2 batches keep the compute stream busy."""
    from dwpa_tpu_torch.feed import CandidateFeed, DeviceStager
    from dwpa_tpu_torch.obs import MetricsRegistry

    bs = 65536
    rng = np.random.default_rng(17)
    words = [bytes(rng.integers(33, 127, int(k), dtype=np.uint8))
             for k in rng.integers(8, 40, 5 * bs)]
    eng = tm.M22000Engine(five_net_group(), batch_size=bs, device=cuda_device)
    feed = CandidateFeed(iter(words), bs, prepack=eng.host_packer(),
                         registry=MetricsRegistry())
    stager = DeviceStager(eng, feed, depth=2)
    step = eng._step_for(next(iter(eng.groups)))
    n = 0
    for blk, prep in stager:
        rows, lens, nvalid = blk.prep
        w = tm._trim_cols(int(lens.max()))
        assert prep[2].is_cuda and prep[1] == nvalid
        step.compute_pmk(prep[2])  # queue a kernel on the compute stream
        assert np.array_equal(prep[2].cpu().numpy(), rows[:bs, :w].view(np.int32))
        n += 1
    feed.close()
    assert n == stager.staged == 5 and stager.stream is not None


@pytest.mark.gpu
def test_crack_blocks_on_the_card(cuda_device):  # noqa: F811
    from dwpa_tpu_torch.feed import CandidateFeed
    from dwpa_tpu_torch.obs import MetricsRegistry

    words = [b"card-filler-%06d" % i for i in range(3000)] + [SLICE_PSK]
    eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=cuda_device)
    feed = CandidateFeed(iter(words), 1024, prepack=eng.host_packer(),
                         registry=MetricsRegistry())
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    reports = []
    founds = eng.crack_blocks(feed, on_batch=lambda c, f: reports.append((c, len(f))))
    feed.close()
    assert len(founds) == 5 and {f.psk for f in founds} == {SLICE_PSK}
    assert reports == [(1024, 0), (1024, 0), (953, 5)]
    assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]


@pytest.mark.gpu
def test_expand_on_the_card_matches_cpu(cuda_device):  # noqa: F811
    """Every rule of the bundled ruleset expands 4096 seeded words (bytes
    >= 128 included) on the card exactly as on the CPU."""
    from dwpa_tpu_torch.rules import wpa_rules
    from dwpa_tpu_torch.rules.device import encode_rule, expand_batch

    rng = np.random.default_rng(23)
    words = [bytes(rng.integers(1, 256, int(k), dtype=np.uint8))
             for k in rng.integers(1, 64, 4096)]
    packed = torch.from_numpy(bo.pack_passwords_be(words).view(np.int32))
    lens = torch.tensor([len(w) for w in words], dtype=torch.int32)
    packed_dev, lens_dev = packed.to(cuda_device), lens.to(cuda_device)
    for rule in wpa_rules():
        steps = encode_rule(rule)
        got = expand_batch(packed_dev, lens_dev, steps)
        assert got.is_cuda and torch.equal(got.cpu(), expand_batch(packed, lens, steps)), rule


@pytest.mark.gpu
@pytest.mark.parametrize("mask,custom,start", [
    ("?d" * 8, None, 0),
    ("?d" * 8, None, 99_999_980),
    ("ab?l?d", None, 7),
    ("?d" * 10, None, 9_999_999_000),
    ("?1?b?1?b?d?d", {"1": b"\x00\x7f\x80\xff"}, 123_456_789),
    ("?l?u" * 31 + "?d", None, 10 ** 85 + 12_345),
])
def test_device_mask_words_on_the_card_matches_cpu(cuda_device, mask, custom, start):  # noqa: F811
    """The mask generator on cuda:0 equals its CPU run and the host pack
    (the keyspace end, a start beyond 2**32, bytes 0 and >= 128, 63
    positions)."""
    from dwpa_tpu_torch.gen.mask import device_mask_words, mask_words

    got = device_mask_words(mask, start, 4099, custom, device=cuda_device)
    assert got.is_cuda and got.dtype == torch.int32
    ref = device_mask_words(mask, start, 4099, custom, device="cpu")
    assert torch.equal(got.cpu(), ref)
    host = list(mask_words(mask, custom, skip=start, limit=4099))
    w = got.shape[1]
    np.testing.assert_array_equal(to_numpy(got)[:len(host)], bo.pack_passwords_be(host)[:, :w])


@pytest.mark.gpu
def test_mixed_store_block_through_the_kernel(cuda_device, tmp_path):  # noqa: F811
    """A PMK-store block with hits and misses on the card: K1 hashes the
    miss sub-batch only, the cached PMKs are gathered in, the planted PSK
    (a hit) is found, and every written-back PMK equals hashlib's."""
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import CandidateFeed
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.pmkstore import PMKStore, miss_width

    essid = b"card-store"
    words = [b"card-store-%05d" % i for i in range(1023)] + [SLICE_PSK]
    seeded = words[::3] + [SLICE_PSK]
    store = PMKStore(str(tmp_path), registry=MetricsRegistry())
    store.put(essid, seeded, [hashlib.pbkdf2_hmac("sha1", w, essid, 4096, 32) for w in seeded])
    eng = tm.M22000Engine([tfx.make_pmkid_line(SLICE_PSK, essid, seed="card-st")],
                          batch_size=1024, device=cuda_device, pmk_store=store)
    feed = CandidateFeed(iter(words), 1024, prepack=eng.host_packer(),
                         registry=MetricsRegistry())
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    founds = eng.crack_blocks(feed)
    feed.close()
    assert [f.psk for f in founds] == [SLICE_PSK]
    assert pbkdf2_cuda.LAUNCHES == before[0] + 1 and pbkdf2.CALLS == before[1]
    assert miss_width(1024, 1, 1024 - len(seeded)) == 1024  # 682 misses: the full width
    assert store.lookup(essid, words) == [hashlib.pbkdf2_hmac("sha1", w, essid, 4096, 32)
                                          for w in words]


def _fused_units(tfx):
    """Eight units of the five kinds in turn, each with its own ESSID and
    PSK planted among 100 seeded words."""
    kinds = [dict(keyver=2), None, dict(keyver=2, nc_delta=-2, endian="BE"),
             dict(keyver=1), dict(keyver=3)]
    rng = np.random.default_rng(29)
    lines, parts = [], []
    for u in range(8):
        essid, psk = b"card-fused-%d" % u, b"fused-psk-%03d" % u
        kind = kinds[u % 5]
        lines.append(tfx.make_pmkid_line(psk, essid, seed=f"cf{u}") if kind is None
                     else tfx.make_eapol_line(psk, essid, seed=f"cf{u}", **kind))
        words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
                 for k in rng.integers(8, 20, 100)]
        words.insert(int(rng.integers(0, 100)), psk)
        parts.append((essid, words))
    return lines, parts


@pytest.mark.gpu
def test_crack_fused_on_the_card_matches_serial(cuda_device):  # noqa: F811
    """Eight units of mixed kinds fused into one 1024-lane batch on
    cuda:0: one K1 launch, every planted PSK found, and the finds equal
    the serial path's (one engine per unit)."""
    from dwpa_tpu_torch import testing as tfx

    lines, parts = _fused_units(tfx)
    eng = tm.M22000Engine(lines, batch_size=1024, device=cuda_device)
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    widths = []
    fused = eng.crack_fused(parts, on_fused=lambda fb: widths.append(fb.width))
    assert pbkdf2_cuda.LAUNCHES == before[0] + 1 and pbkdf2.CALLS == before[1]
    assert widths == [1024]
    serial = []
    for line, (_, words) in zip(lines, parts):
        serial += tm.M22000Engine([line], batch_size=1024, device=cuda_device).crack(words)

    def key(f):
        return (f.line.raw, f.psk, f.nc, f.endian, f.pmk)

    assert sorted(map(key, fused)) == sorted(map(key, serial))
    assert sorted(f.psk for f in fused) == [b"fused-psk-%03d" % u for u in range(8)]
    assert {(f.nc, f.endian) for f in fused} >= {(-2, "BE")}


@pytest.mark.gpu
def test_fused_pmk_step_on_the_card_matches_plain(cuda_device):  # noqa: F811
    """The unit-table gather + K1 on cuda:0 equals the plain PBKDF2 at 2
    iterations, every row trim."""
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.parallel.step import fused_pmk_step
    from dwpa_tpu_torch.sched import fuse_units

    _, parts = _fused_units(tfx)
    fb = fuse_units([(e, w, len(w)) for e, w in parts], 1024, 1, 8)
    for w in (4, 8, 16):
        args = [to_torch(a, cuda_device) for a in (
            np.ascontiguousarray(fb.miss_rows[:, :w]), fb.unit_id, fb.table1, fb.table2)]
        before = pbkdf2_cuda.LAUNCHES
        got = fused_pmk_step(*args, iterations=2)
        assert pbkdf2_cuda.LAUNCHES == before + 1
        t1, t2 = (t.index_select(0, args[1]) for t in args[2:])
        assert torch.equal(got, pbkdf2.pbkdf2_sha1_pmk(args[0], t1, t2, iterations=2))


def _gz_dict(tmp_path, words):
    """A gz dict named by its md5, as the client stores server dicts."""
    import gzip

    blob = gzip.compress(b"\n".join(words) + b"\n")
    dhash = hashlib.md5(blob).hexdigest()
    path = tmp_path / f"{dhash}.gz"
    path.write_bytes(blob)
    return [(str(path), dhash)]


@pytest.mark.gpu
def test_warm_crack_blocks_on_the_card(cuda_device, tmp_path):  # noqa: F811
    """Cold, then warm from the ``.dcache`` entry the cold pass wrote:
    the same founds and reports, K1 launched on the warm blocks, and the
    PMKs equal hashlib's."""
    from dwpa_tpu_torch.feed import CandidateFeed, DictCache, DictFeedSource
    from dwpa_tpu_torch.obs import MetricsRegistry

    units = _gz_dict(tmp_path, [b"card-dcache-%06d" % i for i in range(2500)] + [SLICE_PSK])
    reg = MetricsRegistry()
    cache = DictCache(str(tmp_path / "dc"), registry=reg)
    runs = []
    for _ in ("cold", "warm"):
        eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=cuda_device)
        feed = CandidateFeed(None, 1024, frames=DictFeedSource(units, 1024, cache=cache),
                             prepack=eng.host_packer(), registry=MetricsRegistry())
        before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
        reports = []
        founds = eng.crack_blocks(feed, on_batch=lambda c, f: reports.append((c, len(f))))
        feed.close()
        assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]
        runs.append((sorted((f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in founds), reports))
    assert runs[0] == runs[1] and runs[1][1] == [(1024, 0), (1024, 0), (453, 5)]
    assert reg.value("dwpa_dictcache_hit_blocks_total") == 3
    assert {k[4] for k in runs[1][0]} == {hashlib.pbkdf2_hmac("sha1", SLICE_PSK, SLICE_ESSID,
                                                             4096, 32)}


@pytest.mark.gpu
def test_warm_crack_rules_blocks_on_the_card(cuda_device, tmp_path):  # noqa: F811
    """A rules pass cold, then warm from ``.rbase``: the base blocks arrive
    pre-split and pre-packed, expand on cuda:0, and give the cold run's
    founds and reports; the PSK's PMK equals hashlib's."""
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.feed import DictCache, RulesFeedSource
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.rules import parse_rules

    essid, psk = b"card-rbase", b"Cardrulebase7!"          # 'cardrulebase7!' through 'c'
    words = [b"card-rbase-%05d" % i for i in range(1500)]
    words[1200:1200] = [b"cardrulebase7!", b"y" * 70, b"$HEX[6162636465666768]"]
    units = _gz_dict(tmp_path, words)
    rules = parse_rules([":", "u", "c", "$1"])
    reg = MetricsRegistry()
    cache = DictCache(str(tmp_path / "dc"), registry=reg)
    runs = []
    for _ in ("cold", "warm"):
        eng = tm.M22000Engine([tfx.make_pmkid_line(psk, essid, seed="card-rb")],
                              batch_size=1024, device=cuda_device)
        before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
        reports = []
        founds = eng.crack_rules_blocks(RulesFeedSource(units, 1024, cache=cache), rules,
                                        on_batch=lambda c, f: reports.append((c, len(f))))
        assert pbkdf2_cuda.LAUNCHES > before[0] and pbkdf2.CALLS == before[1]
        runs.append(([(f.psk, f.pmk) for f in founds], reports))
    assert runs[0] == runs[1] == (
        [(psk, hashlib.pbkdf2_hmac("sha1", psk, essid, 4096, 32))], [(4096, 0), (1916, 1)])
    assert reg.value("dwpa_dictcache_hit_blocks_total") == 2


@pytest.mark.gpu
def test_server_precrack_batcher_on_the_card(cuda_device):  # noqa: F811
    """The server's ``PmkBatcher`` on ``cuda:0`` (``device="auto"``): one K1
    launch a wave at the fused widths, hashlib-exact PMKs with duplicates
    and out-of-range lengths mixed in, and ``verify_batch`` verdicts equal
    to the host path's over keyver 1/2/3, NC and PMKID items."""
    from dwpa_tpu_torch import testing as tfx
    from dwpa_tpu_torch.server.core import SERVER_NC
    from dwpa_tpu_torch.server.precrack import PmkBatcher, verify_batch

    rng = np.random.default_rng(12)
    pairs = [(b"card-net-%d" % int(rng.integers(0, 5)),
              bytes(rng.integers(33, 127, int(rng.integers(8, 64)), dtype=np.uint8)))
             for _ in range(300)]
    batcher = PmkBatcher(device="auto", batch=256)
    assert batcher.device_enabled()
    before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
    stats = batcher.prewarm(pairs + pairs[:20] + [(b"card-net-0", b"short")])
    assert (pbkdf2_cuda.LAUNCHES - before[0], pbkdf2.CALLS) == (2, before[1])
    assert stats["unique"] == 301 and stats["fill"] == 44 / 128  # waves 256, 44 of 128
    for essid, word in pairs + [(b"card-net-0", b"short")]:
        assert batcher.pmk(essid, word) == hashlib.pbkdf2_hmac("sha1", word, essid, 4096, 32)

    psk, essid = b"card-precrack", b"CardPrecrack"
    items = [
        (tfx.make_pmkid_line(psk, essid, seed="cp-p"), [b"wrong-one1", psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=1, seed="cp-1"), [psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=2, nc_delta=3, seed="cp-n"), [psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=3, seed="cp-3"), [b"wrong-two2", psk], None),
        (tfx.make_eapol_line(psk, essid, keyver=2, seed="cp-m"), [b"wrong-3333"], None),
    ]
    got = verify_batch(items, nc=SERVER_NC, batcher=PmkBatcher(device="auto"))
    assert got == verify_batch(items, nc=SERVER_NC)
    assert [r is not None for r in got] == [True, True, True, True, False]

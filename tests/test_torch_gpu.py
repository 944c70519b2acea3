"""The port on a CUDA device: the PBKDF2 kernel, the verify kernels
(K3), the engine, the SM probe kernel, the rule interpreter, the mask generator, the PMK
store's mixed blocks, mixed-ESSID unit fusion, the packed-dictionary
cache's warm blocks, the client's cold pass-2 feed, the server pre-crack's
batcher, the Thomson serial sweep, and per-device streams on one card.

Every test here carries the ``gpu`` marker and takes the ``cuda_device``
fixture, which skips where there is no card.  On the GPU:

    python -m pytest -m gpu tests/test_torch_*.py

The file imports nothing of JAX, so on a machine without JAX it runs
alone with ``--noconftest``.
"""

import collections
import hashlib
import re

import numpy as np
import pytest
import torch
from torch_fixtures import (  # noqa: F401  (cuda_device is a fixture)
    PBKDF2_ESSID, SLICE_ESSID, SLICE_PSK, cuda_device, five_net_group, hashlib_pmk, pbkdf2_inputs,
    salt_essid, slice_dictionary)

from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.client.challenge import challenge
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import _nvcc, pbkdf2, pbkdf2_cuda, sm_probe, verify, verify_cuda
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.ops.sass import loop_opcodes, pipe_split, sass_text
from dwpa_tpu_torch.utils import bytesops as bo


#: K1's ALU-pipe share of its loop's SASS on an H100 (ptxas of CUDA
#: 12.8), which ``test_kernel_loop_keeps_its_pipe_split`` holds to within
#: 2 points.
LOOP_ALU_SHARE = 0.644
#: Rows of K1's launches: a ragged block, and the cells' full batch.
K1_WIDTHS = [333, 131072]


@pytest.mark.gpu
@pytest.mark.parametrize("n", K1_WIDTHS)
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("w", [4, 8, 16])
def test_kernel_matches_plain(cuda_device, w, rank, n):  # noqa: F811
    _, packed, s1, s2 = pbkdf2_inputs(w, rank, n=n)
    args = [to_torch(a, cuda_device) for a in (packed[:, :w], s1, s2)]
    for iterations in (1, 2, 5):
        got = pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(*args, iterations=iterations)
        assert torch.equal(got, pbkdf2.pbkdf2_sha1_pmk(*args, iterations=iterations))


@pytest.mark.gpu
@pytest.mark.parametrize("n", K1_WIDTHS)
@pytest.mark.parametrize("rank", [1, 2])
def test_kernel_matches_hashlib(cuda_device, rank, n):  # noqa: F811
    words, packed, s1, s2 = pbkdf2_inputs(16, rank, n=n)
    before = pbkdf2_cuda.LAUNCHES
    out = to_numpy(tm._pmk_impl(*(to_torch(a, cuda_device) for a in (packed, s1, s2))))
    assert pbkdf2_cuda.LAUNCHES == before + 1
    for i in sorted({*range(0, n, max(1, n // 16)), n - 1}):
        essid = PBKDF2_ESSID if rank == 1 else salt_essid(to_torch(s1[i], "cpu"))
        assert bo.words_to_bytes_be(out[:, i]) == hashlib.pbkdf2_hmac(
            "sha1", words[i], essid, 4096, 32)


@pytest.mark.gpu
def test_kernel_loop_keeps_its_pipe_split(cuda_device):  # noqa: F811
    """K1's loop keeps its share of ALU-pipe opcodes (a ptxas that folds
    the IMADs back into IADD3s raises it), and the kernel stays at 64
    registers or fewer with no spills (``__launch_bounds__``: eight blocks
    an SM, a 131,072-row batch in one wave)."""
    so = _nvcc.build(pbkdf2_cuda.SOURCE)[0]
    split = pipe_split(loop_opcodes(sass_text(so), "pbkdf2_sha1_pmk_kernel"))
    assert split["alu"] / sum(split.values()) <= LOOP_ALU_SHARE + 0.02, split
    ptxas = so.with_suffix(".ptxas.txt").read_text()
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    assert len(registers) == 1 and registers[0] <= 64, ptxas
    assert not re.search(r"[1-9]\d* bytes spill", ptxas), ptxas


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
def test_gate_inflight_on_the_card(cuda_device):  # noqa: F811
    """One in-flight sample a gated batch, each between 0 and
    ``PIPELINE_DEPTH``; and the gate does not drain the card: a batch's
    collect returns while about 50 ms of work queued behind it (a
    ``torch.cuda._sleep``, standing in for later batches) still runs, and
    the batch dispatched after that sleep counts as in flight."""
    from dwpa_tpu_torch.feed import frame_blocks
    from dwpa_tpu_torch.obs import MetricsRegistry, SpanTracer

    reg = MetricsRegistry()
    tracer = SpanTracer(reg)
    words = [b"card-filler-%06d" % i for i in range(8 * 1024)] + [SLICE_PSK]
    eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=cuda_device,
                          tracer=tracer)
    assert len(eng.crack_blocks(frame_blocks(iter(words), 1024))) == 5
    hist = reg.snapshot()["dwpa_engine_gate_inflight_batches"]
    assert hist["bucket_bounds"] == [0, 1, 2, 3, 4]
    (sample,) = hist["samples"]
    assert sample["count"] == len(tracer.records("engine:gate")) == 9
    assert sample["buckets"][tm.M22000Engine.PIPELINE_DEPTH + 1:] == [0, 0]
    assert 0 <= sample["sum"] <= tm.M22000Engine.PIPELINE_DEPTH * sample["count"]
    assert eng._inflight == []

    before = sample["sum"]
    eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=cuda_device,
                          tracer=tracer)
    first = eng._dispatch(eng._prepare(words[:1024]))
    torch.cuda._sleep(int(0.05 * 1.98e9))  # about 50 ms at the H100's 1,980 MHz
    slept = torch.cuda.Event()
    slept.record()
    later = eng._dispatch(eng._prepare(words[1024:2048]))
    assert eng._collect(first) == []
    assert not slept.query(), "the gate waited for the work queued behind its batch"
    (sample,) = reg.snapshot()["dwpa_engine_gate_inflight_batches"]["samples"]
    assert sample["count"] == 10 and sample["sum"] >= before + 1
    assert eng._collect(later) == []
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_find_gated_behind_queued_batches(cuda_device, monkeypatch):  # noqa: F811
    """Finds in the second of five 1,024-word blocks: on the card that
    block is gated while the three behind it are queued, and decoded on
    the engine's side stream.  The founds, their PSKs and the
    ``on_batch`` reports (count, founds) equal the CPU engine's, whose
    reads are synchronous, over the same blocks (hashlib PMKs there)."""
    from dwpa_tpu_torch.feed import frame_blocks

    real = tm._pmk_impl
    monkeypatch.setattr(tm, "_pmk_impl", lambda pw, *a, **k: (
        real(pw, *a, **k) if pw.is_cuda else hashlib_pmk(pw, *a, **k)))
    words = [b"card-filler-%06d" % i for i in range(5 * 1024)]
    words[1024 + 517] = SLICE_PSK
    runs = []
    for dev in (cuda_device, "cpu"):
        eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=dev)
        assert eng.PIPELINE_DEPTH == 3
        reports = []
        founds = eng.crack_blocks(frame_blocks(iter(words), 1024),
                                  on_batch=lambda c, f: reports.append((c, f)))
        runs.append((founds, reports))
    (card, card_reports), (cpu, cpu_reports) = runs
    assert len(card) == 5 and {f.psk for f in card} == {SLICE_PSK}
    assert card == cpu and card_reports == cpu_reports
    assert [(c, len(f)) for c, f in card_reports] == [(1024, 0), (1024, 5)] + [(1024, 0)] * 3


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


def cold_unit_on_the_card(workdir, seed, device="cuda:0", **sizes):
    """One unit of ``unit5.cache_off`` (the client at its defaults, no dict
    cache) through ``TpuCrackClient.run()`` on ``device``
    (``port_bench.cell.run_cell``, a window of one unit); ``sizes``
    override the configuration's (``dictcount``, ``dict_words``,
    ``batch_size``).  Every pass-2 block the feed hands the engine is
    recorded as ``(offset, count, CRC-32 of its words)``, the words read
    back from the block's packed rows (the cell's words are 8-63 bytes
    of ``[a-z0-9]``, so the packer keeps each as it is).  -> (is the run
    correct, the window unit's blocks, ``feed_ref``'s blocks over the
    unit's ``.gz`` dicts, the words pass 2 framed in the window)."""
    import os

    from port_bench import feed_ref, run
    from port_bench.cell import run_cell

    from dwpa_tpu_torch.feed import pipeline

    _, config, traffic, _, _ = run.cell_spec("unit5.cache_off")
    config = {**config, **sizes}
    traffic = {**traffic, "dict_pool": config["dictcount"]}
    seen = {}
    record = pipeline.CandidateFeed._record

    def recording(feed, blk):
        if feed.name == "pass2":
            rows, lens, n = blk.prep
            flat = rows[:n].astype(">u4").tobytes()
            words = [flat[64 * i:64 * i + k] for i, k in enumerate(lens[:n].tolist())]
            seen.setdefault(feed, []).append((blk.offset, blk.count, feed_ref.words_crc(words)))
        return record(feed, blk)

    pipeline.CandidateFeed._record = recording
    try:
        w, checks, _, _ = run_cell(config, traffic, seed, 1.0, None, workdir / "work",
                                   device=device)
    finally:
        pipeline.CandidateFeed._record = record
    assert len(w.units) == 1
    paths = []
    for d in w.units[0].dicts:
        paths.append(os.path.join(workdir, d.dhash + ".gz"))
        with open(paths[-1], "wb") as f:
            f.write(d.gz)
    want = [(o, c, feed_ref.words_crc(ws))
            for o, c, ws in feed_ref.blocks(paths, config["batch_size"])]

    def pass2_words(snapshot):
        return sum(s["value"] for s in snapshot["dwpa_feed_framed_words_total"]["samples"]
                   if s["labels"]["feed"] == "pass2")

    words = pass2_words(w.metrics_after) - pass2_words(w.metrics_before)
    # the warm unit's pass 2, then the window's
    return run.is_correct(checks, w), list(seen.values())[1], want, words


@pytest.mark.gpu
def test_cold_unit_through_the_client_matches_feed_ref(cuda_device, tmp_path):  # noqa: F811
    """Two cold dicts of 2**20 words through the client on the card: every
    pass-2 block equal to ``port_bench/feed_ref.py``'s, 16 blocks of the
    batch, all words framed once, and the unit's finds correct."""
    correct, got, want, words = cold_unit_on_the_card(tmp_path, 20261022, dictcount=2)
    assert correct
    assert got == want and [c for _, c, _ in got] == [131072] * 16
    assert words == 2 * 2**20


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
def test_rules_block_at_the_cells_shape(cuda_device, tmp_path, monkeypatch):  # noqa: F811
    """The rules cell's shape (``unit5.rules_warm``): one warm ``.rbase``
    block of 8,192 seeded base words of the rules mix's lengths, at batch
    131,072, with unit5's five nets (one of each verify kind), under all
    105 rules of ``wpa.rule``.  The finds are the ``rule(word)`` PSKs
    planted through four distinct rules, each cracking its net by the
    benchmark's hashlib reference; the fifth net stays uncracked; K1 runs
    once a chunk of 8 rules, over the chunk's 8 x 8,192 packed candidates
    (13 launches of 65,536 columns and one of 8,192 for the last rule),
    and once more for the host tail of overflow pairs only where one of
    them is a valid PSK (in the mix they all come out longer than 63
    bytes); the K1 column counter reads what the plan of
    ``simulate_lens`` predicts."""
    from port_bench import gen, rules_ref
    from port_bench import reference as ref
    from port_bench.run import HERE, load_json

    from dwpa_tpu_torch.feed import DictCache, RulesFeedSource
    from dwpa_tpu_torch.feed.framing import rules_base_eligible
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.rules import parse_rules
    from dwpa_tpu_torch.rules.device import device_supported, simulate_lens

    batch, traffic = 131072, load_json(HERE / "traffic" / "rules_warm.json")
    rule_text = gen.traffic_rules(traffic)
    rules = parse_rules(rule_text)
    rng = np.random.default_rng(20261018)
    words = gen.Dict(*gen.dict_text(rng, traffic["dict_words"], traffic["len_weights"])).words
    planted, used = [], set()
    while len(planted) < 4:
        k, w = int(rng.integers(len(rules))), words[int(rng.integers(len(words)))]
        psk = rules_ref.apply(rule_text[k], w)
        if k not in used and psk is not None and 8 <= len(psk) <= 63 and psk not in planted:
            used.add(k)
            planted.append(psk)
    essid = b"pb-rules-card"
    lines = [tfx.make_eapol_line(planted[0], essid, keyver=2, seed="rc-k2"),
             tfx.make_pmkid_line(planted[1], essid, seed="rc-pmkid"),
             tfx.make_eapol_line(planted[2], essid, keyver=2, nc_delta=-2, endian="BE",
                                 seed="rc-k2be"),
             tfx.make_eapol_line(planted[3], essid, keyver=1, seed="rc-k1"),
             tfx.make_eapol_line(b"uncracked net #5", essid, keyver=3, seed="rc-k3")]
    units = _gz_dict(tmp_path, words)
    reg = MetricsRegistry()
    cache = DictCache(str(tmp_path / "dc"), registry=reg)
    _, writer = cache.entry(units[0][1], rules=True)
    writer.add_many(words)
    assert writer.commit()

    widths, pmk_impl = [], tm._pmk_impl

    def pmk(pw, *args):
        widths.append(pw.shape[0])
        return pmk_impl(pw, *args)

    monkeypatch.setattr(tm, "_pmk_impl", pmk)
    eng = tm.M22000Engine(lines, batch_size=batch, device=cuda_device)
    before = pbkdf2_cuda.LAUNCHES
    founds = eng.crack_rules_blocks(RulesFeedSource(units, batch, cache=cache), rules,
                                    registry=reg)
    launches = pbkdf2_cuda.LAUNCHES - before
    assert reg.value("dwpa_dictcache_hit_blocks_total") == 1
    assert sorted((f.line.raw, f.psk) for f in founds) == sorted(zip(lines[:4], planted))
    for f in founds:
        assert ref.check_psk(f.line.raw, f.psk, eng.nc)
        assert f.pmk == hashlib.pbkdf2_hmac("sha1", f.psk, essid, 4096, 32)

    # the plan: every rule on the device over the whole block but its
    # overflow pairs, which the host tail expands into at most one padded
    # batch, launched only if one of its candidates is 8-63 bytes long
    assert all(map(device_supported, rules)) and all(map(rules_base_eligible, words))
    lens = np.array([len(w) for w in words], np.int32)
    need = [simulate_lens(r, lens)[1] for r in rules]
    expanded = sum(len(words) - int(n.sum()) for n in need)
    tail = [r.apply(words[i]) for r, n in zip(rules, need) for i in np.flatnonzero(n)]
    tail = [t for t in tail if t is not None]
    assert 0 < len(tail) < batch
    in_tail = sum(8 <= len(t) <= 63 for t in tail)
    assert launches == len(widths) == 14 + bool(in_tail)
    assert widths[:14] == [8 * len(words)] * 13 + [len(words)]
    assert reg.value("dwpa_rules_device_expanded_total") == expanded
    assert reg.value("dwpa_rules_k1_columns_total", fill="candidate") == expanded + in_tail
    assert reg.value("dwpa_rules_k1_columns_total", fill="pad") == (
        len(rules) * len(words) + batch * bool(in_tail) - expanded - in_tail)


@pytest.mark.gpu
def test_rules_unit_across_dicts_and_resume_on_the_card(cuda_device, tmp_path):  # noqa: F811
    """A rules unit of three warm dicts of 4,096 seeded base words, one
    base block each at batch 4,096, under all 105 rules of ``wpa.rule``:
    one ``rule(word)`` PSK planted in each dict, through three distinct
    rules, each cracking its own net.  Every PSK is found and checked by
    hashlib, the reports count every (word, rule) pair once, and a run
    resumed past the first dict's pairs finds the two later PSKs alone
    and reports only the pairs after the skip."""
    from port_bench import gen, rules_ref
    from port_bench import reference as ref
    from port_bench.run import HERE, load_json

    from dwpa_tpu_torch.feed import DictCache, RulesFeedSource
    from dwpa_tpu_torch.obs import MetricsRegistry
    from dwpa_tpu_torch.rules import parse_rules

    batch, traffic = 4096, load_json(HERE / "traffic" / "rules_warm.json")
    rule_text = gen.traffic_rules(traffic)
    rules = parse_rules(rule_text)
    rng = np.random.default_rng(20261019)
    dicts = [gen.Dict(*gen.dict_text(rng, batch, traffic["len_weights"])).words
             for _ in range(3)]
    planted, used = [], set()
    for words in dicts:
        while True:
            k, w = int(rng.integers(len(rules))), words[int(rng.integers(len(words)))]
            psk = rules_ref.apply(rule_text[k], w)
            if k not in used and psk is not None and 8 <= len(psk) <= 63:
                break
        used.add(k)
        planted.append(psk)
    essid = b"pb-rules-resume"
    lines = [tfx.make_eapol_line(planted[0], essid, keyver=2, seed="rr-k2"),
             tfx.make_pmkid_line(planted[1], essid, seed="rr-pmkid"),
             tfx.make_eapol_line(planted[2], essid, keyver=1, seed="rr-k1"),
             tfx.make_eapol_line(b"uncracked net #4", essid, keyver=3, seed="rr-k3")]
    units = [u for words in dicts for u in _gz_dict(tmp_path, words)]
    cache = DictCache(str(tmp_path / "dc"), registry=MetricsRegistry())
    for (_, dhash), words in zip(units, dicts):
        _, writer = cache.entry(dhash, rules=True)
        writer.add_many(words)
        assert writer.commit()

    pairs = batch * len(rules)
    for skip, want in ((0, 0), (pairs, 1)):
        eng = tm.M22000Engine(lines, batch_size=batch, device=cuda_device)
        reports = []
        founds = eng.crack_rules_blocks(
            RulesFeedSource(units, batch, cache=cache), rules, skip=skip,
            on_batch=lambda c, f: reports.append((c, len(f))))
        assert sorted((f.line.raw, f.psk) for f in founds) == sorted(
            zip(lines[want:3], planted[want:]))
        for f in founds:
            assert ref.check_psk(f.line.raw, f.psk, eng.nc)
            assert f.pmk == hashlib.pbkdf2_hmac("sha1", f.psk, essid, 4096, 32)
        assert sum(c for c, _ in reports) == 3 * pairs - skip
        assert sum(n for _, n in reports) == 3 - want


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


@pytest.mark.gpu
def test_thomson_sweep_on_the_card_matches_cpu(cuda_device):  # noqa: F811
    """The Thomson serial sweep on ``cuda:0`` equals the CPU sweep and the
    hashlib search over one (yy, ww) window in three chunks, and
    ``device=None`` takes the card."""
    from dwpa_tpu_torch.gen import vendors

    sfx, key = vendors.thomson_key(vendors._thomson_serial(8, 22, "Q7Z"))
    card = list(vendors._thomson_search_device(sfx, [8], [22], chunk=20_000, device=cuda_device))
    assert card == list(vendors._thomson_search_device(sfx, [8], [22], chunk=20_000, device="cpu"))
    assert card == list(vendors.thomson_candidates(sfx, years=[8], weeks=[22], device=False))
    assert key in card
    assert list(vendors.thomson_candidates(sfx, years=[8], weeks=[22])) == card


@pytest.mark.gpu
def test_streams_on_the_card_match_lockstep(cuda_device):  # noqa: F811
    """Two streams on ``cuda:0`` (each its own thread, CUDA stream and
    stager): the founds and per-block reports of ``crack_blocks``, every
    PMK through K1, the launch count exact under two threads."""
    from dwpa_tpu_torch.feed import frame_blocks

    words = [b"card-stream-%06d" % i for i in range(8 * 1024)]
    words[5000] = SLICE_PSK
    runs = []
    for streams in (False, True):
        eng = tm.M22000Engine(five_net_group(), batch_size=1024, device=cuda_device)
        before = pbkdf2_cuda.LAUNCHES, pbkdf2.CALLS
        reports = []
        crack = (lambda b, **k: eng.crack_streams(b, devices=[cuda_device] * 2, **k)) \
            if streams else eng.crack_blocks
        founds = crack(frame_blocks(iter(words), 1024),
                       on_batch=lambda c, f: reports.append((c, len(f))))
        assert (pbkdf2_cuda.LAUNCHES - before[0], pbkdf2.CALLS) == (8, before[1])
        runs.append((sorted((f.line.raw, f.psk, f.nc, f.endian, f.pmk) for f in founds), reports))
    assert runs[0] == runs[1] and len(runs[0][0]) == 5
    assert {k[4] for k in runs[1][0]} == {hashlib.pbkdf2_hmac("sha1", SLICE_PSK, SLICE_ESSID,
                                                             4096, 32)}


# K3: the planted verify cases of ``dwpa_tpu_torch.testing`` (three nets
# each: the exact nonce, an LE and a BE correction), each net's PSK
# planted in two columns of a ragged batch.


#: F = 0 cases of ``test_k3_matches_plain``: the keyver 3 nets with their
#: MIC over one 16-byte (complete) or 7-byte (padded) block.
K3_SHORT = {"kv3_f0_complete": b"sixteen byte msg", "kv3_f0_padded": b"seven b"}


def _k3_case(kind, device, b=1000):
    """(pmk int32[8, b], the nets, their stacked part (kind, static,
    consts), the expected (net, variant, column) hits)."""
    from dwpa_tpu_torch.models import hashline as hl

    specs = tfx.verify_case_specs("kv3" if kind in K3_SHORT else kind)
    lines = tfx.verify_lines(specs, SLICE_ESSID, f"card-k3-{kind}")
    nets = [tm.prep_net(hl.parse(line), device=device) for line, _ in lines]
    pmk = np.random.default_rng(31 + specs[0][0]).integers(0, 2**32, (8, b), dtype=np.uint64)
    pmk = pmk.astype(np.uint32)
    planted = tfx.plant_pmks(pmk, SLICE_ESSID, [psk for _, psk in lines],
                             [(5 + 11 * i, b - 1 - i) for i in range(3)])
    want = tfx.planted_hits(nets, specs, planted)
    if kind in K3_SHORT:   # the MIC under the exact nonce: variant 0
        nets = [tfx.short_cmac_net(net, psk, SLICE_ESSID, K3_SHORT[kind])
                for net, (_, psk) in zip(nets, lines)]
        want = {(i, 0, col) for col, i in planted.items()}
    return to_torch(pmk, device), nets, tfx.stacked_consts(nets), want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(tfx.VERIFY_CASES) + sorted(K3_SHORT))
def test_k3_matches_plain(cuda_device, kind):  # noqa: F811
    """K3 on a ragged batch of three nets: one launch, the plain version's
    found matrix bit for bit on the card and on the CPU, the planted hits
    (non-zero NC variants of both endians, the last column) exactly.  The
    cases cover the AP nonce at offsets 0 and 32 of keyver 1, 2 and 3,
    and keyver 3 at F = 0, 7, 15 and 16."""
    from dwpa_tpu_torch.parallel.step import _KINDS

    pmk, nets, (entry, static, consts), want = _k3_case(kind, cuda_device)
    before = verify_cuda.LAUNCHES[entry], verify.CALLS
    got = _KINDS[entry][2](pmk, static, *consts)
    torch.cuda.synchronize()
    assert (verify_cuda.LAUNCHES[entry], verify.CALLS) == (before[0] + 1, before[1])
    assert torch.equal(got, tfx.plain_part(entry, static, pmk, consts))
    cpu = tfx.plain_part(entry, static, pmk.cpu(), [c.cpu() for c in consts])
    assert torch.equal(got.cpu(), cpu)
    assert {tuple(int(x) for x in ix) for ix in got.nonzero()} == want
    for i, net in enumerate(nets):   # one net, no net axis
        assert torch.equal(tm.net_match(pmk, net), got[i])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 32])
def test_k3_pmkid_nets_match_plain(cuda_device, n):  # noqa: F811
    """K3's PMKID kernel, a thread per column over ``n`` nets (3
    bucket-padded to 4) as a crack step stacks them, on a ragged batch:
    one launch, every byte the plain version's, the planted hits; the
    same bytes with 1, 2 and all nets a thread, and a count outside
    1..N refused."""
    from dwpa_tpu_torch.models import hashline as hl
    from dwpa_tpu_torch.parallel.step import _KINDS, build_crack_step

    b = 1000
    specs = [(100, 0, "", None)] * n
    lines = tfx.verify_lines(specs, SLICE_ESSID, f"card-pmkid-{n}")
    nets = [tm.prep_net(hl.parse(line), device=cuda_device) for line, _ in lines]
    pmk = np.random.default_rng(70 + n).integers(0, 2**32, (8, b), dtype=np.uint64)
    pmk = pmk.astype(np.uint32)
    planted = tfx.plant_pmks(pmk, SLICE_ESSID, [psk for _, psk in lines],
                             [(5 + 13 * i, b - 1 - i) for i in range(n)])
    step = build_crack_step(nets, *tm.essid_salt_blocks(SLICE_ESSID), cuda_device)
    ((_, consts),) = step.parts
    consts = consts[1:]   # the mask first
    assert consts[-1].shape == ({1: 1, 3: 4, 32: 32}[n], 80)
    pmk = to_torch(pmk, cuda_device)
    before = verify_cuda.LAUNCHES["pmkid"], verify.CALLS
    got = _KINDS["pmkid"][2](pmk, (), *consts)
    torch.cuda.synchronize()
    assert (verify_cuda.LAUNCHES["pmkid"], verify.CALLS) == (before[0] + 1, before[1])
    assert torch.equal(got, tfx.plain_part("pmkid", (), pmk, consts))
    assert {tuple(int(x) for x in ix) for ix in got[:n].nonzero()} == \
        tfx.planted_hits(nets, specs, planted)
    blk, tgt, sched = consts
    for per in sorted({p for p in (1, 2, blk.shape[0]) if p <= blk.shape[0]}):
        split = verify_cuda.pmkid_match_cuda(pmk, blk, tgt, (sched,), nets_per_thread=per)
        assert torch.equal(split[:, None], got), per
    for per in (0, blk.shape[0] + 1):
        with pytest.raises(ValueError, match="nets_per_thread"):
            verify_cuda.pmkid_match_cuda(pmk, blk, tgt, (sched,), nets_per_thread=per)


@pytest.mark.gpu
def test_k3_wrappers_refuse_strided_operands(cuda_device):  # noqa: F811
    pmk, _, (_, _, (prf, eap, tgt, *_)), _ = _k3_case("kv2", cuda_device)
    before = dict(verify_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        verify_cuda.eapol_match_cuda(pmk, prf.transpose(2, 3).contiguous().transpose(2, 3),
                                     eap, tgt, 2)
    with pytest.raises(ValueError):
        verify_cuda.eapol_match_cuda(pmk[:, ::2], prf, eap, tgt, 2)
    assert dict(verify_cuda.LAUNCHES) == before


@pytest.mark.gpu
def test_engine_verifies_through_k3(cuda_device):  # noqa: F811
    """A five-net unit on the card: every verify part through K3, the
    plain verify never called."""
    eng = tm.M22000Engine(five_net_group(), batch_size=512, device=cuda_device)
    before = collections.Counter(verify_cuda.LAUNCHES), verify.CALLS
    founds = eng.crack(slice_dictionary())
    assert len(founds) == 5 and {f.psk for f in founds} == {SLICE_PSK}
    launched = verify_cuda.LAUNCHES - before[0]
    assert set(launched) == {"pmkid", "eapol", "cmac"} and verify.CALLS == before[1]

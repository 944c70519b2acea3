"""The port on a CUDA device: the PBKDF2 kernel, the engine, the SM
probe kernel and the rule interpreter.

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
    PBKDF2_ESSID, SLICE_PSK, cuda_device, five_net_group, pbkdf2_inputs, salt_essid,
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

"""The port on a CUDA device: the PBKDF2 kernel, the engine and the SM
probe kernel.

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

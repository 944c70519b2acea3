"""The port's PBKDF2 with one ESSID per batch: plain version, CUDA
wrapper, and dispatch.  (Per-lane salts: test_torch_pbkdf2_lanes.py.)

On the CPU the plain version is held, at ``iterations=2``, to the JAX
package's XLA PBKDF2 and to its Pallas kernel in interpret mode (run the
way tests/test_pbkdf2_pallas.py runs it), for every trimmed row width.
The CUDA kernel's own tests are in test_torch_gpu.py.
"""

import hashlib

import numpy as np
import pytest
import torch
from torch_fixtures import PBKDF2_ESSID, pbkdf2_inputs, plain_pmk
from torch_jax_refs import jax_pallas_pmk, jax_xla_pmk

from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import _nvcc, pbkdf2, pbkdf2_cuda
from dwpa_tpu_torch.ops.common import to_torch
from dwpa_tpu_torch.ops.hmac import hmac_sha1_blocks, hmac_sha1_precompute
from dwpa_tpu_torch.ops.sha1 import sha1_compress
from dwpa_tpu_torch.utils import bytesops as bo


@pytest.mark.parametrize("w", [4, 8, 16])
def test_plain_matches_jax_xla(w):
    _, packed, s1, s2 = pbkdf2_inputs(w, 1)
    np.testing.assert_array_equal(plain_pmk(packed, w, s1, s2, 2),
                                  jax_xla_pmk(packed, s1, s2, 2))


def test_plain_matches_pallas_interpret():
    # words of <= 16 bytes fit every trimmed width, so one Pallas run
    # holds all three widths of the port
    _, packed, s1, s2 = pbkdf2_inputs(4, 1)
    ref = jax_pallas_pmk(packed, s1, s2)
    for w in (4, 8, 16):
        np.testing.assert_array_equal(plain_pmk(packed, w, s1, s2, 2), ref)


def test_plain_matches_hashlib_reduced_iterations():
    words, packed, s1, s2 = pbkdf2_inputs(16, 1)
    out = plain_pmk(packed, 16, s1, s2, 3)
    for i, word in enumerate(words):
        assert bo.words_to_bytes_be(out[:, i]) == hashlib.pbkdf2_hmac(
            "sha1", word, PBKDF2_ESSID, 3, 32)


@pytest.mark.parametrize("bad", ["width", "dtype", "salt_shape", "salt_rank"])
def test_inputs_are_checked(bad):
    _, packed, s1, s2 = pbkdf2_inputs(8, 1)
    pw, t1, t2 = (to_torch(a, "cpu") for a in (packed[:, :8], s1, s2))
    if bad == "width":
        pw = to_torch(packed[:, :6], "cpu")
    elif bad == "dtype":
        pw = pw.long()
    elif bad == "salt_shape":
        t1 = t1[:8]
    else:
        t1 = t1.expand(pw.shape[0], 16)
    with pytest.raises(ValueError):
        pbkdf2.pbkdf2_sha1_pmk(pw, t1, t2, iterations=1)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, packed, s1, s2 = pbkdf2_inputs(8, 1)
    before = pbkdf2_cuda.LAUNCHES
    with pytest.raises(ValueError):
        pbkdf2_cuda.pbkdf2_sha1_pmk_cuda(*(to_torch(a, "cpu") for a in (packed[:, :8], s1, s2)))
    assert pbkdf2_cuda.LAUNCHES == before


def test_pmk_dispatch_takes_plain_version_only_for_cpu(monkeypatch):
    """``_pmk_impl`` routes a CPU batch to the plain version and never to
    the kernel (the plain version is stubbed to keep 4096 iterations off
    the CPU)."""
    _, packed, s1, s2 = pbkdf2_inputs(8, 1)
    seen = []
    monkeypatch.setattr(tm, "pbkdf2_sha1_pmk", lambda *a: seen.append(a) or "plain")
    before = pbkdf2_cuda.LAUNCHES
    assert tm._pmk_impl(*(to_torch(a, "cpu") for a in (packed[:, :8], s1, s2))) == "plain"
    assert len(seen) == 1 and pbkdf2_cuda.LAUNCHES == before


def test_library_path_is_keyed_by_source():
    path = _nvcc.library_path(pbkdf2_cuda.SOURCE)
    assert path.parent == _nvcc.BUILD_DIR
    assert path.name.startswith("libpbkdf2_sha1_") and path.suffix == ".so"


@pytest.mark.parametrize("iterations", [1, 2, 5])
def test_half_trip_loop_matches_plain(iterations):
    """The kernel's loop order, emulated on the CPU: a trip is one
    compression of the 20-byte message from the inner pad state on even
    trips and from the outer on odd ones, picked by a mask of the trip's
    parity, and the accumulator takes the odd trips' digests under the
    same mask; the PMKs equal the plain version's."""
    _, packed, s1, s2 = pbkdf2_inputs(8, 2)
    pw, salt1, salt2 = (to_torch(a, "cpu") for a in (packed[:, :8], s1, s2))
    ist, ost = hmac_sha1_precompute([pw[:, i] for i in range(8)] + [0] * 8)
    blocks = []
    for salt in (salt1, salt2):
        u = acc = hmac_sha1_blocks(ist, ost, [[salt[:, i] for i in range(16)]])
        for h in range(2, 2 * iterations):
            outer = -(h & 1)
            st = [(i & ~outer) | (o & outer) for i, o in zip(ist, ost)]
            u = sha1_compress(st, list(u) + [0x80000000] + [0] * 9 + [84 * 8])
            acc = [a ^ (x & outer) for a, x in zip(acc, u)]
        blocks.append(list(acc))
    got = torch.stack(blocks[0] + blocks[1][:3])
    assert torch.equal(got, pbkdf2.pbkdf2_sha1_pmk(pw, salt1, salt2, iterations))

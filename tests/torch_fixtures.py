"""Shared helpers for the tests of the PyTorch port (``test_torch_*.py``)."""

import hashlib

import numpy as np
import pytest
import torch

from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models.m22000 import essid_salt_blocks, essid_salt_lanes
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.ops.pbkdf2 import pbkdf2_sha1_pmk
from dwpa_tpu_torch.utils import bytesops as bo

PBKDF2_ESSID = b"unit-essid"
SLICE_PSK = b"slicepass99"
SLICE_ESSID = b"slice-essid"


def pbkdf2_inputs(w, rank, n=13, seed=77):
    """Seeded PBKDF2 operands as numpy uint32: ``n`` words that fit ``w``
    key-block columns, packed [n, 16], and the salt blocks — one ESSID
    (rank 1, [16]) or one per lane (rank 2, [n, 16])."""
    rng = np.random.default_rng(seed + w)
    hi = min(4 * w, 63)
    words = [bytes(rng.integers(33, 127, int(k), dtype=np.uint8))
             for k in rng.integers(8, hi + 1, n)]
    if rank == 1:
        s1, s2 = essid_salt_blocks(PBKDF2_ESSID)
    else:
        s1, s2 = essid_salt_lanes([b"net-%d" % i for i in rng.integers(0, 4, n)])
    return words, bo.pack_passwords_be(words), s1, s2


def plain_pmk(packed, w, s1, s2, iterations, device="cpu"):
    """The port's plain PBKDF2 on numpy operands -> uint32[8, n]."""
    return to_numpy(pbkdf2_sha1_pmk(
        to_torch(packed[:, :w], device), to_torch(s1, device), to_torch(s2, device),
        iterations=iterations))


def salt_essid(salt_block) -> bytes:
    """The ESSID inside a PBKDF2 salt block ``essid || INT32_BE(i)``, read
    back from the block's length field (64 key bytes + essid + 4)."""
    words = [int(w) for w in to_numpy(salt_block)]
    n = words[15] // 8 - 68
    return bo.words_to_bytes_be(words)[:n]


def hashlib_pmk(pw, salt1, salt2, iterations=4096):
    """Drop-in for ``models.m22000._pmk_impl`` on the CPU: hashlib PMKs.

    The plain torch PBKDF2 at 4096 iterations costs minutes on the CPU,
    so engine-level CPU tests derive PMKs with ``hashlib.pbkdf2_hmac``
    instead; the plain PBKDF2 itself is held to the JAX package at
    reduced iterations (test_torch_pbkdf2.py) and the CUDA kernel to
    hashlib at 4096 on the card.
    """
    rows = to_numpy(pw)
    out = np.zeros((8, rows.shape[0]), np.uint32)
    for b, row in enumerate(rows):
        s1 = salt1 if salt1.dim() == 1 else salt1[b]
        psk = bo.words_to_bytes_be(row).rstrip(b"\x00")
        pmk = hashlib.pbkdf2_hmac("sha1", psk, salt_essid(s1), iterations, 32)
        out[:, b] = bo.be_words(pmk)
    return to_torch(out, pw.device)


def five_net_group():
    """The mixed, permuted kinds of ``__graft_entry__.dryrun_multichip``;
    the second keyver-2 net only cracks through a nonce correction."""
    return [
        tfx.make_eapol_line(SLICE_PSK, SLICE_ESSID, keyver=2, seed="s-k2a"),
        tfx.make_pmkid_line(SLICE_PSK, SLICE_ESSID, seed="s-pmk"),
        tfx.make_eapol_line(SLICE_PSK, SLICE_ESSID, keyver=2, nc_delta=-2, endian="BE", seed="s-k2b"),
        tfx.make_eapol_line(SLICE_PSK, SLICE_ESSID, keyver=1, seed="s-k1"),
        tfx.make_eapol_line(SLICE_PSK, SLICE_ESSID, keyver=3, seed="s-k3"),
    ]


def slice_dictionary():
    """Seeded candidates: filtered-out short words, $HEX[] notation, and
    the SLICE_PSK in $HEX form near the end of the second batch."""
    rng = np.random.default_rng(9)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
             for n in rng.integers(5, 20, 70)]
    words[10] = b"$HEX[" + b"6162636465666768" + b"]"
    words[60] = b"$HEX[" + SLICE_PSK.hex().encode() + b"]"
    return words


@pytest.fixture
def cuda_device():
    """``cuda:0`` for tests marked ``gpu``; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

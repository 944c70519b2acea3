"""The crack step's verify in plain torch: the reference for K3.

Three match functions over a PMK matrix ``pmk`` int32[8, B] and per-net
constants with any leading net dims ``L`` (``models/m22000.prep_net``
builds them): PMKID, EAPOL keyver 1/2 and keyver 3 (AES-128-CMAC), each
over every nonce-correction variant.  They are the plain versions of the
CUDA kernels in ``ops/verify_cuda.py``: the CPU tests run them, and on
the GPU they are only ever run to hold the kernels to them
(``models/m22000`` routes a CPU ``pmk`` here and a CUDA one to K3).
"""

import torch

from . import hmac as hm
from .aes import aes128_cmac
from .common import bswap32, shr32

#: Calls of the plain verify; the chip smoke run asserts that the main
#: path on the GPU never comes here.
CALLS = 0


def _pmk_key_block(pmk):
    return [pmk[i] for i in range(8)] + [0] * 8


def _col(t, extra):
    """A constant word with leading net dims ``[*L]`` -> ``[*L, 1 x extra]``,
    so it broadcasts against ``[*L, ..., B]`` batch words."""
    return t.reshape(tuple(t.shape) + (1,) * extra)


def _eq4(out, target, extra):
    m = out[0] == _col(target[..., 0], extra)
    for i in range(1, 4):
        m = m & (out[i] == _col(target[..., i], extra))
    return m


def _block_words(blocks, extra):
    """[*L, nb, 16] constant blocks -> nb lists of 16 broadcastable words."""
    return [[_col(blocks[..., k, j], extra) for j in range(16)]
            for k in range(blocks.shape[-2])]


def pmkid_plain(pmk, msg_block, target):
    """PMKID match.  ``pmk``: int32[8, B]; ``msg_block``: [*L, 16];
    ``target``: [*L, 4] for any leading net dims ``L``.  -> bool[*L, B]."""
    global CALLS
    CALLS += 1
    ist, ost = hm.hmac_sha1_precompute(_pmk_key_block(pmk))
    out = hm.hmac_sha1_blocks(ist, ost, _block_words(msg_block[..., None, :], 1))
    return _eq4(out, target, 1)


def eapol_match_plain(pmk, prf_blocks, eapol_blocks, target, *, keyver):
    """MIC match for keyver 1/2 over all NC variants.

    ``pmk``: int32[8, B]; ``prf_blocks``: [*L, V, 2, 16];
    ``eapol_blocks``: [*L, E, 16]; ``target``: [*L, 4].
    Returns bool[*L, V, B].
    """
    global CALLS
    CALLS += 1
    ist, ost = hm.hmac_sha1_precompute(_pmk_key_block(pmk))
    prf = hm.hmac_sha1_blocks(ist, ost, _block_words(prf_blocks, 1))
    eap = _block_words(eapol_blocks, 2)
    kck = list(prf[:4])
    if keyver == 1:
        ii, oo = hm.hmac_md5_precompute([bswap32(w) for w in kck] + [0] * 12)
        out = hm.hmac_md5_blocks(ii, oo, eap)
    else:
        ii, oo = hm.hmac_sha1_precompute(kck + [0] * 12)
        out = hm.hmac_sha1_blocks(ii, oo, eap)
    return _eq4(out, target, 2)


def eapol_cmac_match_plain(pmk, prf_blocks, cmac_full, cmac_last, target, *, last_complete):
    """AES-128-CMAC MIC match (keyver 3, WPA2 802.11w).

    ``prf_blocks``: [*L, V, 2, 16]; ``cmac_full``: [*L, F, 16];
    ``cmac_last``/``target``: [*L, 16] byte values.  -> bool[*L, V, B].
    """
    global CALLS
    CALLS += 1
    ist, ost = hm.hmac_sha256_precompute(_pmk_key_block(pmk))
    prf = hm.hmac_sha256_blocks(ist, ost, _block_words(prf_blocks, 1))
    kck_bytes = []
    for w in prf[:4]:
        kck_bytes += [shr32(w, 24), shr32(w, 16) & 0xFF, shr32(w, 8) & 0xFF, w & 0xFF]
    lead = cmac_last.dim() - 1
    full = cmac_full.permute(lead, lead + 1, *range(lead))  # [F, 16, *L]
    mac = aes128_cmac(torch.stack(kck_bytes), full, cmac_last.movedim(-1, 0),
                      last_complete)
    return (mac == _col(target.movedim(-1, 0), 2)).all(dim=0)

"""K3's derived constants: the work on a verify part's constants that is
the same for every PMK column, done once on the host.

The kernels (``csrc/verify.cu``) read these in place of work that every
thread would otherwise repeat:

- message schedules of PMKID's message blocks and of the constant PRF and
  EAPOL blocks, with the round constants folded in: SHA-1 ``W[t] + K[t]``
  (80 words), SHA-256 ``W[t] + K[t]`` (64), and for keyver 1's MD5
  ``M[g(t)] + T[t]`` (64, in round order);
- the order of a net's nonce-correction variants that puts the variants
  whose PRF block 0 is equal next to each other, so a kernel compresses
  block 0 once per distinct value (:func:`variant_order`);
- keyver 3's CMAC blocks, last block and target as big-endian column
  words, four a block.

``derive`` builds them for one verify part from its stacked constants,
on the constants' device; ``parallel/step.py`` calls it once when it
builds a step on the card, never per launch and never for a CPU step,
whose plain versions (``ops/verify.py``) do not read them (``BUILDS``
counts the calls).

:func:`kernel_ttable` reads the AES T-table ``kTe0`` that ``verify.cu``
embeds, so the CPU tests hold the kernel's own table to FIPS-197.
"""

import re
import threading
import time

import numpy as np
import torch

from .md5 import T
from .sha1 import K0, K1, K2, K3
from .sha256 import K

#: ``derive`` calls in this process, and the host seconds they took: a
#: crack step derives each verify part's constants once, when it is built.
#: Stream threads build steps, so the two move together under a lock.
BUILDS = 0
BUILD_SECONDS = 0.0
_count_lock = threading.Lock()

#: Flag of ``order[n, j]``: position ``j`` starts a run of variants that
#: share PRF block 0.  The low 16 bits are the variant's own index.
NEW_BLOCK0 = 1 << 16

SHA1_K = np.repeat(np.array((K0, K1, K2, K3), dtype=np.uint32), 20)
SHA256_K = np.array(K, dtype=np.uint32)
# Round t of MD5 reads message word MD5_G[t] and adds T[t].
MD5_T = np.array(T, dtype=np.uint32)
MD5_G = np.array([t if t < 16 else (5 * t + 1) % 16 if t < 32 else (3 * t + 5) % 16
                  if t < 48 else (7 * t) % 16 for t in range(64)])


def _rotr(x, n):
    return (x >> n) | (x << (32 - n))


def _rounds_first(blocks, rounds, extra=0):
    """uint32 ``[..., 16]`` blocks -> ``[rounds + extra, M]``, the 16
    words in the first rows: the schedule grows a few rounds a step, each
    step a few numpy calls over every block at once."""
    w = np.empty((rounds + extra, blocks[..., 0].size), dtype=np.uint32)
    w[:16] = blocks.reshape(-1, 16).T
    return w


def sha1_schedule(blocks):
    """uint32 ``[..., 16]`` SHA-1 blocks -> ``[..., 80]``: ``W[t] + K[t]``."""
    w = _rounds_first(blocks, 80, 2)  # three rounds a step: W[t] reads W[t - 3]
    for t in range(16, 80, 3):
        x = w[t - 3:t] ^ w[t - 8:t - 5] ^ w[t - 14:t - 11] ^ w[t - 16:t - 13]
        np.bitwise_or(x << 1, x >> 31, out=w[t:t + 3])
    return (w[:80].T + SHA1_K).reshape(blocks.shape[:-1] + (80,))


def sha256_schedule(blocks):
    """uint32 ``[..., 16]`` SHA-256 blocks -> ``[..., 64]``: ``W[t] + K[t]``."""
    w = _rounds_first(blocks, 64)  # two rounds a step: W[t] reads W[t - 2]
    for t in range(16, 64, 2):
        x, y = w[t - 15:t - 13], w[t - 2:t]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w[t:t + 2] = w[t - 16:t - 14] + s0 + w[t - 7:t - 5] + s1
    return (w.T + SHA256_K).reshape(blocks.shape[:-1] + (64,))


def md5_rounds(blocks):
    """uint32 ``[..., 16]`` MD5 blocks (little-endian words) ->
    ``[..., 64]``: the word round ``t`` reads plus ``T[t]``."""
    return blocks[..., MD5_G].astype(np.uint32) + MD5_T


def variant_order(block0):
    """One net's PRF blocks 0, uint32 ``[V, 16]`` -> int32 ``[V]``: the
    variants in the order the kernel visits them, each variant's own
    index, with :data:`NEW_BLOCK0` on the first of each run of equal
    blocks 0.  Runs come in the order their block first appears, and a
    run keeps its variants' order."""
    first = {}
    for v, blk in enumerate(block0):
        first.setdefault(blk.tobytes(), []).append(v)
    order = []
    for run in first.values():
        order.append(run[0] | NEW_BLOCK0)
        order.extend(run[1:])
    return np.array(order, dtype=np.int32)


def eapol_prep(prf_blocks, eapol_blocks, keyver):
    """A keyver 1/2 part's derived constants from its numpy constants
    (``prf_blocks`` uint32 ``[N, V, 2, 16]``, ``eapol_blocks`` ``[N, E,
    16]``) -> ``(order int32[N, V], prf_sched uint32[N, V, 2, 80] in
    visiting order, eapol_sched uint32[N, E, 80]`` (keyver 2, SHA-1) or
    ``[N, E, 64]`` (keyver 1, MD5)``)``."""
    order = np.stack([variant_order(p[:, 0]) for p in prf_blocks])
    visit = order & (NEW_BLOCK0 - 1)
    prf = np.take_along_axis(prf_blocks, visit[:, :, None, None], axis=1)
    if keyver == 1:
        return order, sha1_schedule(prf), md5_rounds(eapol_blocks)
    both = sha1_schedule(np.concatenate([prf.reshape(-1, 16), eapol_blocks.reshape(-1, 16)]))
    k = prf[..., 0].size
    return (order, both[:k].reshape(prf.shape[:-1] + (80,)),
            both[k:].reshape(eapol_blocks.shape[:-1] + (80,)))


def be_words(byte_values):
    """uint32 ``[..., 16]`` byte values -> ``[..., 4]`` big-endian column
    words (byte ``4c + r`` is byte ``r`` of word ``c``, most significant
    first)."""
    b = byte_values.astype(np.uint32).reshape(byte_values.shape[:-1] + (4, 4))
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def cmac_prep(prf_blocks, cmac_full, cmac_last, target):
    """A keyver 3 part's derived constants from its numpy constants ->
    ``(prf_sched uint32[N, 1 + V, 64], cmac_words uint32[N, F + 2, 4])``:
    the shared PRF block 0's schedule, then each variant's block 1's;
    the F full blocks, the last block and the target as column words.
    Raises if a net's variants differ in PRF block 0 (the AP nonce's
    corrected bytes sit in block 1 of a keyver 3 PRF message)."""
    block0 = prf_blocks[:, :, 0]
    if (block0 != block0[:, :1]).any():
        raise ValueError("keyver 3 variants differ in PRF block 0")
    sched = np.concatenate([prf_blocks[:, :1, 0], prf_blocks[:, :, 1]], axis=1)
    words = np.concatenate([be_words(cmac_full), be_words(cmac_last)[:, None],
                            be_words(target)[:, None]], axis=1)
    return sha256_schedule(sched), words


def _to_host(consts):
    """int32 tensors -> uint32 numpy arrays, in one copy from their device."""
    flat = torch.cat([c.reshape(-1) for c in consts]).cpu().numpy().view(np.uint32)
    out, at = [], 0
    for c in consts:
        out.append(flat[at:at + c.numel()].reshape(c.shape))
        at += c.numel()
    return out


def _to_device(arrays, dev):
    """uint32 (or int32) arrays -> int32 tensors on ``dev``, in one copy:
    views of one buffer, each starting at a 16-byte boundary."""
    sizes = [-(-a.size // 4) * 4 for a in arrays]
    buf = np.zeros(sum(sizes), dtype=np.uint32)
    at = 0
    for a, n in zip(arrays, sizes):
        buf[at:at + a.size] = a.reshape(-1).astype(np.uint32)
        at += n
    dbuf = torch.from_numpy(buf.view(np.int32)).to(dev)
    out, at = [], 0
    for a, n in zip(arrays, sizes):
        out.append(dbuf[at:at + a.size].view(a.shape))
        at += n
    return tuple(out)


def derive(kind, static, consts):
    """K3's derived constants of one verify part (``kind`` and ``static``
    as in ``parallel/step._KINDS``; ``consts`` its stacked int32 tensors
    with a leading net axis), as int32 tensors on the constants' device,
    in the order the kind's match function takes them after ``consts``.
    One copy to the host and one back."""
    global BUILDS, BUILD_SECONDS
    t0 = time.perf_counter()
    arrays = _to_host(consts)
    if kind == "pmkid":   # each net's message block's schedule, [N, 80]
        out = (sha1_schedule(arrays[0]),)
    elif kind == "eapol":
        out = eapol_prep(arrays[0], arrays[1], static[0])
    else:
        out = cmac_prep(*arrays)
    out = _to_device(out, consts[0].device)
    with _count_lock:
        BUILDS += 1
        BUILD_SECONDS += time.perf_counter() - t0
    return out


def kernel_ttable(source=None):
    """The AES T-table ``kTe0`` embedded in ``csrc/verify.cu`` (or
    ``source``), as uint32[256]."""
    from ._nvcc import CSRC

    text = (source or CSRC / "verify.cu").read_text()
    body = re.search(r"kTe0\[256\]\s*=\s*\{(.*?)\};", text, re.S).group(1)
    words = [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]{8})u", body)]
    if len(words) != 256:
        raise ValueError(f"kTe0 has {len(words)} entries")
    return np.array(words, dtype=np.uint32)

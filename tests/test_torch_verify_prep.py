"""K3's derived constants (``ops/verify_prep.py``) against the JAX package.

The kernels read message schedules with the round constants folded in
(PMKID's message blocks, the PRF and EAPOL blocks), a variant order in
which equal PRF blocks 0 are adjacent, CMAC blocks as column words and
the AES T-table that ``csrc/verify.cu`` embeds.  The kernels run only on
a card; here each derived constant, and a numpy emulation of how the
kernel uses it, is held to the JAX package's functions on seeded inputs,
exactly: SHA-1, SHA-256 and MD5 compressions from the schedules, the
PMKID kernel's loop (the PMK's pad states once a column, then each net)
against JAX's ``_pmkid_impl`` and the plain version, the variant order
of nets prepped by ``dwpa_tpu``, AES-128 through the kernel's T-table
rounds.  The census (``ops/opcount.verify_census``) must count a PRF
block 0 that variants share once, and a crack step must derive its
parts' constants once, when it is built.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch_fixtures import SLICE_ESSID as ESSID

import jax.numpy as jnp
from dwpa_tpu.models import hashline as jhl
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu.ops import aes as jaes
from dwpa_tpu.ops import md5 as jmd5
from dwpa_tpu.ops import sha1 as jsha1
from dwpa_tpu.ops import sha256 as jsha256
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import hashline as hl
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import opcount
from dwpa_tpu_torch.ops import verify as vf
from dwpa_tpu_torch.ops import verify_cuda
from dwpa_tpu_torch.ops import verify_prep as vp
from dwpa_tpu_torch.ops.common import to_torch
from dwpa_tpu_torch.oracle import m22000 as oracle
from dwpa_tpu_torch.parallel.step import _KINDS, _pad_nets, build_crack_step

N = 64  # seeded states and blocks a test


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


# numpy emulations of csrc/verify.cu's compressions over a schedule read
# from memory (sha1_compress_wk, sha256_compress_wk, md5_compress_wk).

def _sha1_wk(st, wk):
    a, b, c, d, e = st
    for t in range(80):
        if t < 20:
            f = d ^ (b & (c ^ d))
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (d & (b ^ c))
        a, b, c, d, e = _rotl(a, 5) + f + e + wk[..., t], a, _rotl(b, 30), c, d
    return [s + x for s, x in zip(st, (a, b, c, d, e))]


def _sha256_wk(st, wk):
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + wk[..., t]
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return [s + x for s, x in zip(st, (a, b, c, d, e, f, g, h))]


_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4


def _md5_wk(st, wk):
    a, b, c, d = st
    for t in range(64):
        if t < 16:
            f = (b & c) | (~b & d)
        elif t < 32:
            f = (d & b) | (~d & c)
        elif t < 48:
            f = b ^ c ^ d
        else:
            f = c ^ (b | ~d)
        a, b, c, d = d, b + _rotl(a + f + wk[..., t], _MD5_S[t]), b, c
    return [s + x for s, x in zip(st, (a, b, c, d))]


def _jax(compress, st, blocks):
    out = compress(tuple(jnp.asarray(s) for s in st),
                   [jnp.asarray(blocks[:, i]) for i in range(16)])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("alg", ["sha1", "sha256", "md5"])
def test_schedules_give_the_jax_compression(alg):
    """A compression from the host's schedule (round constants folded in)
    equals the JAX package's compression of the block."""
    rng = np.random.default_rng({"sha1": 1, "sha256": 2, "md5": 3}[alg])
    width, derive, kernel, ref = {
        "sha1": (5, vp.sha1_schedule, _sha1_wk, jsha1.sha1_compress),
        "sha256": (8, vp.sha256_schedule, _sha256_wk, jsha256.sha256_compress),
        "md5": (4, vp.md5_rounds, _md5_wk, jmd5.md5_compress),
    }[alg]
    st = [_u32(rng, N) for _ in range(width)]
    blocks = _u32(rng, N, 16)
    wk = derive(blocks)
    assert wk.dtype == np.uint32 and wk.shape == (N, 80 if alg == "sha1" else 64)
    got = kernel(st, wk)
    for g, r in zip(got, _jax(ref, st, blocks)):
        np.testing.assert_array_equal(g, r)


# PMKID: csrc/verify.cu's verify_pmkid_kernel, a thread per column (and
# group of nets, when a small batch splits them): the PMK's pad states
# once, then per net the inner compression from the net's W + K schedule
# and the outer hash.

SHA1_IV = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0],
                   dtype=np.uint32)
PMKID_B = 24


def _pmkid_kernel(pmk, sched, target, per=None):
    """uint32 pmk[8, B], sched[N, 80], target[N, 4] -> uint8[N, B], in the
    kernel's loop order, ``per`` nets a thread (all N by default)."""
    b, nets = pmk.shape[1], sched.shape[0]
    per = per or nets
    key = np.concatenate([pmk, np.zeros((8, b), np.uint32)])          # [16, B]
    pads = [vp.sha1_schedule((key ^ np.uint32(p)).T) for p in (0x36363636, 0x5C5C5C5C)]
    iv = [np.full(b, w, np.uint32) for w in SHA1_IV]
    tail = np.zeros((11, b), np.uint32)
    tail[0], tail[10] = 0x80000000, 84 * 8
    out = np.zeros((nets, b), np.uint8)
    for n0 in range(0, nets, per):                                    # grid.y
        ist, ost = (_sha1_wk(iv, pad) for pad in pads)                # once a thread
        for n in range(n0, min(nets, n0 + per)):
            st = _sha1_wk(ist, sched[n])
            mac = _sha1_wk(ost, vp.sha1_schedule(np.concatenate([np.stack(st), tail]).T))
            out[n] = np.all(np.stack(mac[:4]) == target[n][:, None], axis=0)
    return out


@functools.lru_cache(maxsize=None)
def _pmkid_case(n):
    """``n`` PMKID nets, each PSK planted at two columns of a seeded PMK
    matrix, stacked and bucket-padded as a crack step stacks them.  ->
    (uint32 pmk[8, B], port block[N, 16], target[N, 4], the schedule,
    the planted hits)."""
    lines = tfx.verify_lines([(100, 0, "", None)] * n, ESSID, f"prep-pmkid-{n}")
    nets = [tm.prep_net(hl.parse(ln), device="cpu") for ln, _ in lines]
    pmk = np.random.default_rng(40 + n).integers(0, 2**32, (8, PMKID_B), dtype=np.uint64)
    pmk = pmk.astype(np.uint32)
    cols = [(i % PMKID_B, PMKID_B - 1 - i % PMKID_B) for i in range(n)]
    planted = tfx.plant_pmks(pmk, ESSID, [psk for _, psk in lines[:PMKID_B // 2]],
                             cols[:PMKID_B // 2])
    blk, tgt = (_pad_nets([getattr(x, f) for x in nets]) for f in ("pmkid_block", "target"))
    (sched,) = vp.derive("pmkid", (), (blk, tgt))
    return pmk, blk, tgt, sched, {(i, c) for c, i in planted.items()}


def _u32np(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 3, 32])
def test_pmkid_schedule_gives_jax_pmkid(n):
    """The kernel's loop over the derived schedules, emulated in numpy,
    gives JAX's ``_pmkid_impl`` bits over the bucket-padded net axis,
    with the planted hits."""
    pmk, blk, tgt, sched, want = _pmkid_case(n)
    assert sched.shape == (blk.shape[0], 80) == ({1: 1, 3: 4, 32: 32}[n], 80)
    got = _pmkid_kernel(pmk, _u32np(sched), _u32np(tgt))
    ref = jax.jit(jax.vmap(jm._pmkid_impl, in_axes=(None, 0, 0)))(
        jnp.asarray(pmk), jnp.asarray(_u32np(blk)), jnp.asarray(_u32np(tgt)))
    np.testing.assert_array_equal(got, np.asarray(ref).astype(np.uint8))
    assert {(int(i), int(c)) for i, c in zip(*got[:n].nonzero())} == want


@pytest.mark.parametrize("n", [1, 3, 32])
def test_pmkid_loop_order_matches_plain(n):
    """Pads once a column, then the nets: the emulated kernel equals the
    plain version (``ops/verify.pmkid_plain``), bucket rows included."""
    pmk, blk, tgt, sched, _ = _pmkid_case(n)
    got = _pmkid_kernel(pmk, _u32np(sched), _u32np(tgt))
    ref = vf.pmkid_plain(to_torch(pmk, "cpu"), blk, tgt)
    np.testing.assert_array_equal(got, ref.numpy().astype(np.uint8))


@pytest.mark.parametrize("n,per", [(3, 1), (3, 3), (32, 1), (32, 7)])
def test_pmkid_split_nets_matches_plain(n, per):
    """A small batch's split: nets in groups of ``per`` over the grid,
    the pads once a (column, group); every row the plain version's."""
    pmk, blk, tgt, sched, _ = _pmkid_case(n)
    got = _pmkid_kernel(pmk, _u32np(sched), _u32np(tgt), per)
    ref = vf.pmkid_plain(to_torch(pmk, "cpu"), blk, tgt)
    np.testing.assert_array_equal(got, ref.numpy().astype(np.uint8))


@pytest.mark.parametrize("b,n,sms,per", [
    (131072, 32, 132, 32), (131069, 32, 132, 32), (131072, 1, 132, 1),
    (65536, 32, 132, 16), (16384, 32, 132, 7), (2048, 32, 132, 1), (2048, 1, 132, 1),
    (1, 4, 132, 1), (67584, 8, 132, 8), (67456, 8, 132, 4)])
def test_pmkid_nets_per_thread(b, n, sms, per):
    """All of a part's nets a thread once the columns alone give every
    SM ``PMKID_BLOCKS_PER_SM`` blocks (a batch of 131072 words on an
    H100's 132); below that the nets split until the groups make it up."""
    assert verify_cuda.pmkid_nets_per_thread(b, n, sms) == per
    blocks = -(-b // verify_cuda.PMKID_BLOCK)
    groups = -(-n // per)
    assert groups == 1 or blocks * groups >= verify_cuda.PMKID_BLOCKS_PER_SM * sms or per == 1


def test_pmkid_prep_is_the_blocks_schedule():
    """``derive`` for a PMKID part: one build, the SHA-1 schedule (W + K) of
    each net's message block as int32[N, 80] at a 16-byte boundary."""
    _, blk, tgt, _, _ = _pmkid_case(3)
    before = vp.BUILDS
    (sched,) = vp.derive("pmkid", (), (blk, tgt))
    assert vp.BUILDS == before + 1
    assert sched.dtype == torch.int32 and sched.shape == (4, 80) and sched.data_ptr() % 16 == 0
    np.testing.assert_array_equal(_u32np(sched), vp.sha1_schedule(_u32np(blk)))


def _jax_nets(name_or_lines):
    lines = name_or_lines
    if isinstance(name_or_lines, str):
        lines = tfx.verify_lines(tfx.verify_case_specs(name_or_lines), ESSID,
                                 f"prep-{name_or_lines}")
    return lines, [jm.prep_net(jhl.parse(ln)) for ln, _ in lines]


def _runs_ok(block0, order):
    """``order`` visits every variant once, flags exactly the first of each
    run of equal blocks 0, and no block 0 comes back after its run."""
    visit = order & (vp.NEW_BLOCK0 - 1)
    flags = (order & vp.NEW_BLOCK0) != 0
    assert sorted(visit.tolist()) == list(range(len(block0)))
    rows = [block0[v].tobytes() for v in visit]
    assert flags.tolist() == [j == 0 or rows[j] != rows[j - 1] for j in range(len(rows))]
    assert int(flags.sum()) == len(set(rows))
    return int(flags.sum())


@pytest.mark.parametrize("name", ["kv1_ap0", "kv1_ap32", "kv2_ap0", "kv2_ap32",
                                  "kv3_ap0", "kv3_ap32"])
def test_variant_order_groups_equal_prf_blocks(name):
    """At AP nonce offset 0 an LE correction changes keyver 1/2's PRF
    block 0 (its byte 63 is the AP nonce's byte 28); at 32, and always
    for keyver 3, every variant shares it."""
    lines, jnets = _jax_nets(name)
    keyver, _, ap_off = tfx.VERIFY_CASES[name]
    for (line, _), net in zip(lines, jnets):
        assert oracle.nonce_pairs(hl.parse(line))[2] == ap_off
        prf = np.asarray(net.prf_blocks, dtype=np.uint32)
        runs = _runs_ok(prf[:, 0], vp.variant_order(prf[:, 0]))
        le = [i for i, (_, e) in enumerate(net.variants) if e == "LE"]
        if keyver != 3 and ap_off == 0:
            assert runs == 1 + len(le) == 11   # the exact nonce + 10 LE values
        else:
            assert runs == 1


@pytest.mark.parametrize("mp", ["LE", "BE", "APLESS"])
def test_variant_order_of_one_endian_and_apless_nets(mp):
    """An LE-only net at offset 0 has as many blocks 0 as variants; a
    BE-only one shares one; an MP_APLESS net has one variant."""
    flag = {"LE": hl.MP_LE, "BE": hl.MP_BE, "APLESS": hl.MP_APLESS}[mp]
    for seed in range(64):
        line = tfx.make_eapol_line(b"one-endian", ESSID, keyver=2, message_pair=flag,
                                   seed=f"prep-{mp}-{seed}")
        if oracle.nonce_pairs(hl.parse(line))[2] == 0:
            break
    (net,) = _jax_nets([(line, b"one-endian")])[1]
    prf = np.asarray(net.prf_blocks, dtype=np.uint32)
    order = vp.variant_order(prf[:, 0])
    runs = _runs_ok(prf[:, 0], order)
    assert (len(order), runs) == {"LE": (11, 11), "BE": (11, 1), "APLESS": (1, 1)}[mp]


@pytest.mark.parametrize("name", ["kv1_ap0", "kv2_ap0", "kv2_ap32"])
def test_eapol_prep_compresses_like_jax(name):
    """Each visited variant's two PRF schedules and the EAPOL schedules,
    run from seeded states, give JAX's compressions of the blocks they
    stand for."""
    _, jnets = _jax_nets(name)
    keyver = tfx.VERIFY_CASES[name][0]
    prf = np.stack([np.asarray(n.prf_blocks, dtype=np.uint32) for n in jnets])
    eap = np.stack([np.asarray(n.eapol_blocks, dtype=np.uint32) for n in jnets])
    order, prf_sched, eap_sched = vp.eapol_prep(prf, eap, keyver)
    assert (order.shape, prf_sched.shape, eap_sched.shape) == (
        (3, 21), (3, 21, 2, 80), (3, 3, 64 if keyver == 1 else 80))
    visit = order & (vp.NEW_BLOCK0 - 1)
    rng = np.random.default_rng(5)
    for n in range(3):
        st = [_u32(rng, 21) for _ in range(5)]
        for blk in range(2):
            np.testing.assert_array_equal(
                np.stack(_sha1_wk(st, prf_sched[n, :, blk])),
                np.stack(_jax(jsha1.sha1_compress, st, prf[n, visit[n], blk])))
        st = [_u32(rng, 3) for _ in range(5 if keyver == 2 else 4)]
        kernel, ref = (_sha1_wk, jsha1.sha1_compress) if keyver == 2 else \
            (_md5_wk, jmd5.md5_compress)
        np.testing.assert_array_equal(np.stack(kernel(st, eap_sched[n])),
                                      np.stack(_jax(ref, st, eap[n])))


@pytest.mark.parametrize("name", ["kv3", "kv3_f15", "kv3_f16"])
def test_cmac_prep_words_and_schedules(name):
    """Keyver 3: one block-0 schedule a net and each variant's block 1's;
    the full blocks, the last block and the target as big-endian column
    words.  A net whose variants differ in block 0 is refused."""
    _, jnets = _jax_nets(name)
    prf = np.stack([np.asarray(n.prf_blocks, dtype=np.uint32) for n in jnets])
    full, last, tgt = (np.stack([np.asarray(getattr(n, f), dtype=np.uint32) for n in jnets])
                       for f in ("cmac_full", "cmac_last", "cmac_target"))
    sched, words = vp.cmac_prep(prf, full, last, tgt)
    f = full.shape[1]
    assert sched.shape == (3, 22, 64) and words.shape == (3, f + 2, 4)
    np.testing.assert_array_equal(sched[:, 0], vp.sha256_schedule(prf[:, 0, 0]))
    np.testing.assert_array_equal(sched[:, 1:], vp.sha256_schedule(prf[:, :, 1]))
    for n in range(3):
        for k, blk in enumerate(list(full[n]) + [last[n], tgt[n]]):
            want = [int.from_bytes(bytes(blk[4 * c: 4 * c + 4].astype(np.uint8)), "big")
                    for c in range(4)]
            assert words[n, k].tolist() == want
    prf[1, 5, 0, 3] ^= 1
    with pytest.raises(ValueError, match="block 0"):
        vp.cmac_prep(prf, full, last, tgt)


def test_kernel_ttable_is_fips197():
    """``kTe0`` of csrc/verify.cu is FIPS-197's T0 from the JAX package's
    S-box: (2S, S, S, 3S) from row 0 down."""
    s = np.asarray(jaes.SBOX, dtype=np.uint32)
    s2 = ((s << 1) ^ np.where(s & 0x80, 0x1B, 0)) & 0xFF
    want = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s)
    np.testing.assert_array_equal(vp.kernel_ttable(), want.astype(np.uint32))


def _tables():
    t0 = vp.kernel_ttable()
    return [_rotr(t0, 8 * k) if k else t0 for k in range(4)]


def _byte(x, k):
    return (x >> np.uint32(8 * k)) & np.uint32(0xFF)


def _sub_rot_word(t, w):
    return ((t[2][_byte(w, 2)] & np.uint32(0xFF000000)) | (t[0][_byte(w, 1)] & np.uint32(0xFF0000))
            | (t[0][_byte(w, 0)] & np.uint32(0xFF00)) | (t[2][_byte(w, 3)] & np.uint32(0xFF)))


def _aes_ttable(key, block):
    """AES-128 as csrc/verify.cu's aes128_expand + aes128_encrypt compute
    it, on big-endian column words [4, n]."""
    t = _tables()
    rk = list(key)
    rcon = [1, 2, 4, 8, 16, 32, 64, 128, 27, 54]
    for r in range(10):
        rk.append(rk[4 * r] ^ _sub_rot_word(t, rk[4 * r + 3]) ^ np.uint32(rcon[r] << 24))
        for c in range(1, 4):
            rk.append(rk[4 * r + c] ^ rk[4 * r + 3 + c])
    s = [block[c] ^ rk[c] for c in range(4)]
    for r in range(1, 10):
        s = [t[0][_byte(s[c], 3)] ^ t[2][_byte(s[(c + 2) % 4], 1)]
             ^ t[1][_byte(s[(c + 1) % 4], 2)] ^ t[3][_byte(s[(c + 3) % 4], 0)] ^ rk[4 * r + c]
             for c in range(4)]
    return [((t[2][_byte(s[c], 3)] & np.uint32(0xFF000000))
             | (t[0][_byte(s[(c + 1) % 4], 2)] & np.uint32(0xFF0000))
             | (t[0][_byte(s[(c + 2) % 4], 1)] & np.uint32(0xFF00))
             | (t[2][_byte(s[(c + 3) % 4], 0)] & np.uint32(0xFF))) ^ rk[40 + c]
            for c in range(4)]


def test_ttable_aes_matches_jax():
    """AES-128 through the kernel's T-table rounds (the embedded table,
    its rotations, S-box bytes out of T0 and T2 for the last round and the
    key schedule) equals the JAX package's ``aes128_encrypt_block``."""
    rng = np.random.default_rng(9)
    key, block = (rng.integers(0, 256, (16, N)).astype(np.uint32) for _ in range(2))
    ref = jaes.aes128_encrypt_block(jaes.aes128_expand_key([jnp.asarray(k) for k in key]),
                                    [jnp.asarray(b) for b in block])
    ref = np.stack([np.asarray(x) for x in ref])       # [16, N] byte values
    got = _aes_ttable(vp.be_words(key.T).T, vp.be_words(block.T).T)
    np.testing.assert_array_equal(np.stack(got), vp.be_words(ref.T).T)


def test_census_counts_a_shared_prf_block_once():
    """keyver 1/2: ``block0`` distinct blocks 0 take the plain version's
    repeats out, one compression's per-variant instructions each; keyver
    3 shares one a net.  With one variant there is nothing to share."""
    x1 = sum(opcount._block0_per_row("eapol").values())
    x3 = sum(opcount._block0_per_row("cmac").values())
    assert 300 < x1 < 400 and 800 < x3 < 1000   # about 4 a SHA-1 round, 14 a SHA-256 round
    plain = opcount.verify_census("eapol", (2,), 2, 21, 3, 5)
    shared = opcount.verify_census("eapol", (2,), 2, 21, 3, 5, block0=12)
    assert plain["per_column"] - shared["per_column"] == 30 * x1
    assert plain["per_part"] == shared["per_part"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(opcount, "_block0_per_row", lambda kind: {})
        unshared = opcount.verify_census("cmac", (False,), 2, 21, 7, 5)
    assert unshared["per_column"] - opcount.verify_census(
        "cmac", (False,), 2, 21, 7, 5)["per_column"] == 2 * 20 * x3
    one = [opcount.verify_census("eapol", (1,), 1, 1, 3, 5, block0=b) for b in (1, None)]
    assert one[0] == one[1]


def test_crack_step_derives_once_per_part(monkeypatch):
    """A step for the card derives each part's constants when it is built
    (PMKID, keyver 1/2 and 3), in the kind's order after the fields;
    verifying does not derive, and a CPU step, whose plain versions do not
    read them, derives nothing."""
    from dwpa_tpu_torch.parallel import step as st

    specs = [s for case in ("pmkid", "kv1", "kv3") for s in tfx.verify_case_specs(case)]
    lines = tfx.verify_lines(specs, ESSID, "prep-step")
    nets = [tm.prep_net(hl.parse(ln), device="cpu") for ln, _ in lines]
    salts = tm.essid_salt_blocks(ESSID)
    before = vp.BUILDS
    cpu_step = build_crack_step(nets, *salts, torch.device("cpu"))
    assert vp.BUILDS == before
    assert [len(consts) for _, consts in cpu_step.parts] == [
        1 + len(_KINDS[kind][1]) for kind in ("pmkid", "eapol", "cmac")]
    monkeypatch.setattr(st, "_kernel_reads", lambda consts: True)  # as a CUDA part
    step = build_crack_step(nets, *salts, torch.device("cpu"))
    assert vp.BUILDS == before + 3
    # the parts in the nets' order, each the mask, the fields, the derived
    derived = [tuple(tuple(c.shape) for c in consts[1 + len(_KINDS[kind][1]):])
               for kind, (_, consts) in zip(("pmkid", "eapol", "cmac"), step.parts)]
    assert derived == [((4, 80),), ((4, 21), (4, 21, 2, 80), (4, 3, 64)),
                       ((4, 22, 64), (4, 9, 4))]
    step.verify(torch.zeros((8, 5), dtype=torch.int32))
    assert vp.BUILDS == before + 3


def _kv_operands(name):
    lines = tfx.verify_lines(tfx.verify_case_specs(name), ESSID, f"prep-ops-{name}")
    nets = [tm.prep_net(hl.parse(ln), device="cpu") for ln, _ in lines]
    pmk = to_torch(np.zeros((8, 4), np.uint32), "cpu")
    return pmk, tfx.stacked_consts(nets)[2]


@pytest.mark.parametrize("case", ["arity", "order_shape", "sched_width", "misaligned",
                                  "dtype"])
def test_eapol_prep_check_refuses(case):
    pmk, (prf, eap, tgt, order, sched, esched) = _kv_operands("kv1")
    assert verify_cuda.check_eapol(pmk, prf, eap, tgt, 1, (order, sched, esched)) == (3, 21, 3)
    prep = {"arity": (order, sched),
            "order_shape": (order[:, :20].contiguous(), sched, esched),
            "sched_width": (order, sched, torch.zeros((3, 3, 80), dtype=torch.int32)),
            "misaligned": (order, sched, torch.zeros(3 * 3 * 64 + 1, dtype=torch.int32)[1:]
                           .view(3, 3, 64)),
            "dtype": (order.long(), sched, esched)}[case]
    with pytest.raises(ValueError):
        verify_cuda.check_eapol(pmk, prf, eap, tgt, 1, prep)


@pytest.mark.parametrize("case", ["missing", "arity", "sched_rows", "sched_width",
                                  "misaligned", "dtype"])
def test_pmkid_prep_check_refuses(case):
    pmk, (blk, tgt, sched) = _kv_operands("pmkid")
    assert verify_cuda.check_pmkid(pmk, blk, tgt, (sched,)) == 3
    prep = {"missing": (),
            "arity": (sched, sched),
            "sched_rows": (sched[:2].contiguous(),),
            "sched_width": (sched[:, :64].contiguous(),),
            "misaligned": (torch.zeros(3 * 80 + 1, dtype=torch.int32)[1:].view(3, 80),),
            "dtype": (sched.long(),)}[case]
    with pytest.raises(ValueError):
        verify_cuda.check_pmkid(pmk, blk, tgt, prep)


@pytest.mark.parametrize("case", ["arity", "sched_rows", "words_rows", "misaligned"])
def test_cmac_prep_check_refuses(case):
    pmk, (prf, full, last, tgt, sched, words) = _kv_operands("kv3")
    f = full.shape[1]
    assert verify_cuda.check_cmac(pmk, prf, full, last, tgt, (sched, words)) == (3, 21, f)
    prep = {"arity": (sched,),
            "sched_rows": (sched[:, :21].contiguous(), words),
            "words_rows": (sched, words[:, :f + 1].contiguous()),
            "misaligned": (sched, torch.zeros(3 * (f + 2) * 4 + 2, dtype=torch.int32)[2:]
                           .view(3, f + 2, 4))}[case]
    with pytest.raises(ValueError):
        verify_cuda.check_cmac(pmk, prf, full, last, tgt, prep)


def test_wrapper_derives_what_the_step_passes():
    """The step passes what ``derive`` builds from the part's constants;
    a wrapper never derives: it refuses CPU tensors before anything else,
    and without ``prep`` its checks refuse the call."""
    pmk, consts = _kv_operands("kv2_ap0")
    prf, eap, tgt, *prep = consts
    again = vp.derive("eapol", (2,), (prf, eap, tgt))
    assert all(torch.equal(a, b) for a, b in zip(again, prep))
    pmk3, (prf3, full, last, tgt3, *_) = _kv_operands("kv3")
    before = vp.BUILDS
    for given in ((), (tuple(prep),)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            verify_cuda.eapol_match_cuda(pmk, prf, eap, tgt, 2, *given)
    with pytest.raises(ValueError, match="expected derived constants"):
        verify_cuda.check_eapol(pmk, prf, eap, tgt, 2, ())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        verify_cuda.cmac_match_cuda(pmk3, prf3, full, last, tgt3, False)
    with pytest.raises(ValueError, match="expected derived constants"):
        verify_cuda.check_cmac(pmk3, prf3, full, last, tgt3, ())
    assert vp.BUILDS == before
    pmk1, (blk, tgt1, sched) = _kv_operands("pmkid")
    assert torch.equal(vp.derive("pmkid", (), (blk, tgt1))[0], sched)
    before = vp.BUILDS
    for given in ((), ((sched,),)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            verify_cuda.pmkid_match_cuda(pmk1, blk, tgt1, *given)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            verify_cuda.pmkid_match_cuda(pmk1, blk[0], tgt1[0], *given)
    with pytest.raises(ValueError, match="expected derived constants"):
        verify_cuda.check_pmkid(pmk1, blk, tgt1, ())
    assert vp.BUILDS == before

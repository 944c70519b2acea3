"""The SM probe path of the port on the CPU: the hoisted SHA-1/HMAC forms,
the op census, the probe's plain version, its wrapper and entry point,
and the SASS reader.

Each port function is held to its ``dwpa_tpu`` twin on seeded numpy
inputs; every comparison is exact.  The probe kernel itself runs only on
the card (test_torch_gpu.py).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_refs import jax_probe

from dwpa_tpu.ops import hmac as jhm
from dwpa_tpu.ops import opcount as jopcount
from dwpa_tpu.ops import sha1 as jsha1
from dwpa_tpu_torch.ops import hmac as hm
from dwpa_tpu_torch.ops import opcount, sha1, sm_probe
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.ops.sass import loop_opcodes, loop_span

B = 32


def _words(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, B), dtype=np.uint64).astype(np.uint32)


def _t(arr):
    return [to_torch(a, "cpu") for a in arr]


def _same(port, jax_ref, unhoisted):
    ref = np.stack([np.asarray(w) for w in jax_ref])
    for words in (port, unhoisted):
        np.testing.assert_array_equal(np.stack([to_numpy(w) for w in words]), ref)


def test_sha1_compress_20_matches_jax_and_unhoisted():
    state, m5 = _words(31, 5), _words(32, 5)
    pad = [0x80000000] + [0] * 9 + [84 * 8]
    got = sha1.sha1_compress_20(sha1.sha1_20_prologue(tuple(_t(state))), _t(m5))
    ref = jsha1.sha1_compress_20(jsha1.sha1_20_prologue(tuple(jnp.asarray(s) for s in state)),
                                 [jnp.asarray(w) for w in m5])
    _same(got, ref, sha1.sha1_compress(tuple(_t(state)), _t(m5) + pad))


def test_hmac_sha1_20_hoisted_matches_jax_and_unhoisted():
    ist, ost, m5 = _words(41, 5), _words(42, 5), _words(43, 5)
    pro = hm.hmac_sha1_20_prologue(tuple(_t(ist)), tuple(_t(ost)))
    got = hm.hmac_sha1_20_hoisted(pro, _t(m5))
    jpro = jhm.hmac_sha1_20_prologue(tuple(jnp.asarray(s) for s in ist),
                                     tuple(jnp.asarray(s) for s in ost))
    ref = jhm.hmac_sha1_20_hoisted(jpro, [jnp.asarray(w) for w in m5])
    _same(got, ref, hm.hmac_sha1_20(tuple(_t(ist)), tuple(_t(ost)), _t(m5)))


_CENSUS = {
    "generic": (opcount.sha1_compress_census, jopcount.sha1_compress_census, 1409),
    "plain": (lambda: opcount.pbkdf2_iteration_census(hoisted=False),
              lambda: jopcount.pbkdf2_iteration_census(hoisted=False), 2747),
    "hoisted": (lambda: opcount.pbkdf2_iteration_census(hoisted=True),
                lambda: jopcount.pbkdf2_iteration_census(hoisted=True), 2699),
}


@pytest.mark.parametrize("form", sorted(_CENSUS))
def test_census_matches_jax(form):
    port_fn, jax_fn, alu = _CENSUS[form]
    got, ref = port_fn(), jax_fn()
    assert got["alu_ops"] == ref["alu_ops"] == alu
    ref_alu = {p: n for p, n in ref["by_prim"].items() if p in jopcount.ALU_PRIMS}
    assert got["by_prim"] == ref_alu
    # one sign-fill mask per logical right shift of the int32 words
    assert got["sign_masks"] == got["by_prim"]["shift_right_logical"]


def test_element_ops_per_pmk():
    it = opcount.pbkdf2_iteration_census(hoisted=True)
    assert opcount.element_ops_per_pmk(it) == 22_104_810


@pytest.mark.parametrize("mix", sorted(sm_probe.MIXES))
def test_probe_plain_matches_pallas_interpret(mix):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, (5, 16, 128), dtype=np.uint64).astype(np.uint32)
    got = to_numpy(sm_probe.probe_plain(to_torch(x.reshape(5, -1), "cpu"), mix, 2))
    np.testing.assert_array_equal(got.reshape(16, 128), jax_probe(x, mix, 2))


@pytest.mark.parametrize("bad", ["cpu", "strided", "mix", "shape"])
def test_probe_wrapper_refuses(bad):
    x = torch.zeros((5, 256), dtype=torch.int32)
    mix, match = "sha1_round", "CUDA"
    if bad == "strided":
        x, match = x[:, ::2], "contiguous"
    elif bad == "mix":
        mix, match = "mul", "unknown mix"
    elif bad == "shape":
        x, match = x[:4], "int32"
    before = sm_probe.LAUNCHES
    with pytest.raises(ValueError, match=match):
        sm_probe.probe_cuda(x, mix, 1)
    assert sm_probe.LAUNCHES == before


def test_probe_main_exits_nonzero_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "dwpa_tpu_torch.ops.sm_probe"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


# A cut-down ``cuobjdump -sass`` listing: a forward branch, one loop (four
# instructions, the last a backward branch), the trailing self-branch and
# NOP padding every kernel ends with, and a second function.
_SASS = """
\tcode for sm_90a
\t\tFunction : sm_probe_xor
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;      /* 0x0000000400007c0c */
        /*0030*/               @P0 BRA `(.L_x_2) ;                         /* 0x0000000000000947 */
        /*0040*/                   LDG.E R2, desc[UR6][R4.64] ;            /* 0x0000000604027981 */
.L_x_0:
        /*0050*/                   LOP3.LUT R2, R3, R2, RZ, 0x3c, !PT ;    /* 0x0000000203027212 */
        /*0060*/                   IADD3 R5, R5, 0x1, RZ ;                 /* 0x0000000105057810 */
        /*0070*/                   ISETP.GE.AND P1, PT, R5, R6, PT ;       /* 0x000000060500720c */
        /*0080*/              @!P1 BRA `(.L_x_0) ;                         /* 0xfffffffc00f09947 */
        /*0090*/                   STG.E desc[UR6][R8.64], R2 ;            /* 0x0000000208007986 */
.L_x_2:
        /*00a0*/                   EXIT ;                                  /* 0x000000000000794d */
.L_x_1:
        /*00b0*/                   BRA `(.L_x_1);                          /* 0xfffffffc00fc7947 */
        /*00c0*/                   NOP;                                    /* 0x0000000000007918 */
        /*00d0*/                   NOP;                                    /* 0x0000000000007918 */
\t\t..........

\t\tFunction : sm_probe_add
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
.L_x_3:
        /*0010*/                   BRA `(.L_x_3);                          /* 0xfffffffc00fc7947 */
"""


def test_sass_loop_span_on_canned_listing():
    assert loop_span(_SASS, "sm_probe_xor") == (4, 8)
    assert loop_span(_SASS, "sm_probe_add") == (1, 1)
    assert loop_opcodes(_SASS, "sm_probe_xor") == {
        "LOP3.LUT": 1, "IADD3": 1, "ISETP.GE.AND": 1, "BRA": 1}
    with pytest.raises(ValueError):
        loop_span(_SASS, "sm_probe")  # names two functions
    with pytest.raises(ValueError):
        loop_span(_SASS, "sm_probe_rotl")

"""The SM probe path of the port on the CPU: the hoisted SHA-1/HMAC forms,
the op census, the probe's plain version, its wrapper and entry point,
and the SASS reader.

Each port function is held to its ``dwpa_tpu`` twin on seeded numpy
inputs; every comparison is exact.  The probe kernel itself runs only on
the card (test_torch_gpu.py).
"""

import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_refs import jax_probe

from dwpa_tpu.ops import hmac as jhm
from dwpa_tpu.ops import opcount as jopcount
from dwpa_tpu.ops import sha1 as jsha1
from dwpa_tpu_torch.ops import hmac as hm
from dwpa_tpu_torch.ops import common, opcount, sha1, sm_probe
from dwpa_tpu_torch.ops.common import to_numpy, to_torch
from dwpa_tpu_torch.ops.sass import dynamic_count, loop_opcodes, loop_span, pipe_split

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


# Expressions over four words of 4 elements -> the card's instructions
# the verify census counts for them, by element (3-input logic and adds,
# funnel-shift rotates, a rotate that only one sum reads folded into it;
# work on one element counted once).
_FUSION = {
    "rotate": (lambda a, b, c, d: common.rotl32(a, 5), {"rotate": 4}),
    "rotr": (lambda a, b, c, d: common.rotr32(a, 7), {"rotate": 4}),
    "logical_shift": (lambda a, b, c, d: common.shr32(a, 3), {"shift": 4}),
    "ch": (lambda a, b, c, d: (b & c) | (~b & d), {"logic": 4}),
    "xor4": (lambda a, b, c, d: a ^ b ^ c ^ d, {"logic": 8}),
    "add5": (lambda a, b, c, d: common.wadd(a, b, c, d, 0x5A827999), {"add": 8}),
    "rotate_add": (lambda a, b, c, d: b + common.rotl32(a, 5), {"add": 4}),
    "sum_of_rotates": (lambda a, b, c, d: common.wadd(common.rotl32(a, 5), b, c, d,
                                                      common.rotl32(c, 30)), {"add": 12}),
    "shared_rotate": (lambda a, b, c, d: (lambda r: (r + b) ^ (r + c))(common.rotl32(a, 5)),
                      {"rotate": 4, "add": 8, "logic": 4}),
    "shared": (lambda a, b, c, d: (lambda t: (t ^ c) + (t & d))(a ^ b),
               {"logic": 12, "add": 4}),
    "broadcast": (lambda a, b, c, d: (b[:1] ^ c[:1]) + a, {"logic": 1, "add": 4}),
}


@pytest.mark.parametrize("expr", sorted(_FUSION))
def test_verify_census_fuses_instructions(expr):
    fn, want = _FUSION[expr]
    words = [torch.zeros((4,), dtype=torch.int32) for _ in range(4)]
    with opcount._Graph() as graph:
        fn(*words)
    assert +opcount._instructions(graph) == want


def test_verify_census_folds_a_nets_constants():
    """The constants among a sum's terms (marked, or made from marked
    tensors only) are one term; a sum of constants only keeps its terms;
    a rotate of a constant is not folded into the sum that reads it."""
    a, b, c, d = (torch.zeros((4,), dtype=torch.int32) for _ in range(4))
    want = {"sum": {"add": 4}, "const_sum": {"add": 4},
            "const_rotate": {"add": 4, "rotate": 4}, "derived": {"add": 4, "logic": 4}}
    for case, n in want.items():
        with opcount._Graph() as graph:
            graph.constant(c, d)
            {"sum": lambda: common.wadd(a, b, c, d, 0x5A827999),
             "const_sum": lambda: c + d,
             "const_rotate": lambda: a + common.rotl32(c, 5),
             "derived": lambda: common.wadd(a, c ^ d, d, 7)}[case]()
        assert +opcount._instructions(graph) == n, case


def test_verify_census_pmkid_is_four_sha1_compressions():
    """Two pad states (140 rotates each: SHA-1's 224 less the 80 rotl 5
    and the schedule words w[77..79], each folded into the one round sum
    that reads it, and round 79's rotl 30, folded into the feed-forward),
    the inner block (a constant message: its schedule is the net's, 77
    rotl 30 a net) and the outer (138 a net); of each of those two, the
    rotates of rounds 0-1 that read only the column's pad state are the
    column's (2 rotl 30, and round 0's rotl 5, whose shape, the column's,
    is not its sum's, the net's: one rotate, not a fold).  4 compares a
    net."""
    c = opcount.verify_census("pmkid", (), 2, 1, 0, 1000)
    one = opcount.verify_census("pmkid", (), 1, 1, 0, 1000)
    per_net = c["per_column"] - one["per_column"]
    assert one["by_class"]["rotate"] == 2 * 140 + (3 + 77) + (3 + 138)
    assert c["by_class"]["rotate"] == 2 * 140 + 2 * 3 + 2 * (77 + 138)
    assert c["by_class"]["eq"] == 2 * 4
    assert one["per_column"] - per_net > 0           # the shared pad states
    assert c["ops"] == c["per_column"] * 1000 + c["per_part"]


@pytest.mark.parametrize("part", [("eapol", (1,)), ("eapol", (2,)), ("cmac", (False,)),
                                  ("cmac", (True,))])
def test_verify_census_grows_with_the_shapes(part):
    """Counted at 1 and 2 columns, the census holds at any width, and its
    per-column work is linear in the variants; the AES part is the
    T-table model's, per variant."""
    kind, static = part
    census = [opcount.verify_census(kind, static, 1, v, 1, 5) for v in (1, 2, 3)]
    direct = opcount._verify_counts(kind, static, 1, 2, 1, 5)
    assert census[1]["ops"] == sum(direct[c] for c in census[1]["by_class"]) + \
        sum(direct[c] for c in direct if c not in census[1]["by_class"])
    steps = [census[i + 1]["per_column"] - census[i]["per_column"] for i in range(2)]
    assert steps[0] == steps[1] > 0
    if kind == "cmac":
        aes = opcount.cmac_model(2, static[0])
        assert aes == {"aes_alu": 110 + 3 * 252 + 7 * (1 if static[0] else 2) + 4,
                       "aes_loads": 40 + 3 * 160}
        for v, c in zip((1, 2, 3), census):
            assert {k: c["by_class"][k] for k in aes} == {k: v * n for k, n in aes.items()}


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


def test_sass_pipe_split_on_canned_listing():
    """LOP3, SHF, LEA and IADD3 count on the ALU pipe, IMAD and VIADD on
    the FMA pipe; the uniform datapath's UIADD3, compares and branches are
    neither."""
    assert pipe_split(loop_opcodes(_SASS, "sm_probe_xor")) == {"alu": 2, "fma": 0, "other": 2}
    assert pipe_split(Counter({
        "LOP3.LUT": 7, "SHF.L.W.U32.HI": 5, "LEA.HI": 3, "IADD3": 2, "IMAD": 11,
        "IMAD.IADD": 4, "IMAD.HI.U32": 1, "IMAD.MOV.U32": 1, "VIADD": 6, "UIADD3": 1,
        "PLOP3.LUT": 1, "UISETP.GE.AND": 1, "BRA": 1})) == {"alu": 17, "fma": 23, "other": 4}
    assert pipe_split(Counter()) == {"alu": 0, "fma": 0, "other": 0}


def test_sass_dynamic_count_on_canned_listing():
    """K3's own issue counts what one thread issues: each instruction once
    per trip of every loop around it; the kernel's closing self-branch is
    no loop.  A wrong number of trip counts names the loops."""
    assert dynamic_count(_SASS, "sm_probe_xor", [3]) == 8 + 4 * 3
    assert dynamic_count(_SASS, "sm_probe_xor", [0]) == 8
    assert dynamic_count(_SASS, "sm_probe_add", []) == 2
    with pytest.raises(ValueError, match=r"has 1 loops \[\(5, 8\)\], 2 trip counts"):
        dynamic_count(_SASS, "sm_probe_xor", [3, 2])
    with pytest.raises(ValueError, match=r"has 0 loops \[\], 1 trip counts"):
        dynamic_count(_SASS, "sm_probe_add", [1])

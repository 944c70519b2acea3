"""The crack step's verify (K3's plain versions, routing, wrapper checks)
against the JAX package.

``ops/verify.py`` holds the plain torch versions of the three match
functions; on the CPU they are held, exactly, to the JAX package's
``_pmkid_impl``, ``eapol_match`` and ``eapol_cmac_match`` (run eagerly
on the CPU, mapped over a leading net axis of 3 by ``jax.vmap`` and
compiled as the JAX ``verify_step`` maps and compiles them), with hits
planted in non-zero nonce-correction variants of both endians
(``dwpa_tpu_torch.testing``'s planted nets).  ``models/m22000`` routes a CPU PMK matrix to them, a CUDA
one to the kernels of ``ops/verify_cuda.py`` and any other device to an
error; the kernels' input checks run here without a card.  The kernels
themselves are held to these plain versions on the card in
test_torch_gpu.py and in ``chip_smoke.py`` phase 15.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import SLICE_ESSID as ESSID

from dwpa_tpu.models import hashline as jhl
from dwpa_tpu.models import m22000 as jm
from dwpa_tpu_torch import testing as tfx
from dwpa_tpu_torch.models import hashline as hl
from dwpa_tpu_torch.models import m22000 as tm
from dwpa_tpu_torch.ops import verify as vf
from dwpa_tpu_torch.ops import verify_cuda
from dwpa_tpu_torch.ops.common import to_torch
from dwpa_tpu_torch.parallel.step import _KINDS

B = 24


@functools.lru_cache(maxsize=None)
def planted_case(name):
    """A :data:`testing.VERIFY_CASES` case: three nets, each PSK's real PMK
    planted at columns 3 + 7 i and B - 1 - i of random PMK words.  ->
    (JAX nets, port nets, uint32 pmk[8, B], expected hits)."""
    specs = tfx.verify_case_specs(name)
    lines = tfx.verify_lines(specs, ESSID, f"verify-{name}")
    jnets = [jm.prep_net(jhl.parse(ln)) for ln, _ in lines]
    tnets = [tm.prep_net(hl.parse(ln), device="cpu") for ln, _ in lines]
    pmk = np.random.default_rng(len(name)).integers(0, 2**32, (8, B), dtype=np.uint64)
    pmk = pmk.astype(np.uint32)
    planted = tfx.plant_pmks(pmk, ESSID, [psk for _, psk in lines],
                             [(3 + 7 * i, B - 1 - i) for i in range(3)])
    return jnets, tnets, pmk, tfx.planted_hits(tnets, specs, planted)


def _jax_match(kind, static):
    """The JAX match function of a verify part, mapped over the net axis
    and compiled as the JAX ``verify_step`` compiles it."""
    if kind == "pmkid":
        fn = jm._pmkid_impl
    elif kind == "cmac":
        fn = lambda pmk, *cs: jm.eapol_cmac_match(pmk, *cs, last_complete=static[0])  # noqa: E731
    else:
        fn = lambda pmk, *cs: jm.eapol_match(pmk, *cs, keyver=static[0])  # noqa: E731
    return jax.jit(jax.vmap(fn, in_axes=(None,) + (0,) * len(_KINDS[kind][1])))


@pytest.mark.parametrize("name", sorted(tfx.VERIFY_CASES))
def test_plain_matches_jax_over_a_net_axis(name):
    jnets, tnets, pmk, want = planted_case(name)
    kind, static, consts = tfx.stacked_consts(tnets)
    tpmk = to_torch(pmk, "cpu")
    if kind == "cmac":
        key_data = tfx.VERIFY_CASES[name][1] or b""
        assert static == ((99 + len(key_data)) % 16 == 0,) == (jnets[0].cmac_last_complete,)
        assert consts[1].shape[1] >= 3   # full CMAC blocks before the last
    elif kind == "eapol":
        assert consts[1].shape[1] == 3   # E = 3 EAPOL blocks
    jc = [jnp.asarray(np.stack([getattr(n, f) for n in jnets])) for f in _KINDS[kind][1]]
    ref = np.asarray(_jax_match(kind, static)(jnp.asarray(pmk), *jc))
    ref = ref[:, None] if kind == "pmkid" else ref   # one variant
    got = tfx.plain_part(kind, static, tpmk, consts)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert {tuple(int(x) for x in ix) for ix in got.nonzero()} == want
    if kind != "pmkid":   # the corrected nets hit in non-zero NC variants
        assert all(v > 0 for i, v, _ in want if tfx.VERIFY_NC[i][0])
    # one net through the router, with no net axis
    for i, net in enumerate(tnets):
        assert torch.equal(tm.net_match(tpmk, net), got[i])


@pytest.fixture
def calls():
    """The plain verify's and the kernels' counts before the test."""
    return vf.CALLS, sum(verify_cuda.LAUNCHES.values())


def _operands(name):
    """A case's PMK matrix (CPU) and its nets' stacked constants (the
    ``_KINDS`` fields, without K3's derived constants)."""
    _, tnets, pmk, _ = planted_case(name)
    kind, _, consts = tfx.stacked_consts(tnets)
    return [to_torch(pmk, "cpu")] + consts[:len(_KINDS[kind][1])]


@pytest.mark.parametrize("kind", ["pmkid", "kv2", "kv3"])
def test_cpu_pmk_takes_the_plain_version(kind, calls):
    pmk, *consts = _operands(kind)
    if kind == "pmkid":
        tm._pmkid_impl(pmk, *consts)
    elif kind == "kv3":
        tm.eapol_cmac_match(pmk, *consts, last_complete=False)
    else:
        tm.eapol_match(pmk, *consts, keyver=2)
    assert vf.CALLS == calls[0] + 1
    assert sum(verify_cuda.LAUNCHES.values()) == calls[1]


@pytest.mark.parametrize("kind", ["pmkid", "kv1", "kv3"])
def test_other_devices_raise(kind, calls):
    pmk = torch.empty((8, B), dtype=torch.int32, device="meta")
    consts = [c.to("meta") for c in _operands(kind)[1:]]
    with pytest.raises(ValueError, match="no verify for device meta"):
        if kind == "pmkid":
            tm._pmkid_impl(pmk, *consts)
        elif kind == "kv3":
            tm.eapol_cmac_match(pmk, *consts, last_complete=False)
        else:
            tm.eapol_match(pmk, *consts, keyver=1)
    assert (vf.CALLS, sum(verify_cuda.LAUNCHES.values())) == calls


def test_kernel_wrappers_refuse_cpu_tensors(calls):
    pmk, prf, eap, tgt = _operands("kv2")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        verify_cuda.eapol_match_cuda(pmk, prf, eap, tgt, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        verify_cuda.pmkid_match_cuda(pmk, prf[0, 0, 0], tgt[0])
    assert (vf.CALLS, sum(verify_cuda.LAUNCHES.values())) == calls


def _bad(case, ops):
    """``ops`` (pmk, prf, full, last, target) with one fault ``case``."""
    pmk, prf, full, last, tgt = ops
    if case == "pmk_dtype":
        pmk = pmk.long()
    elif case == "pmk_rows":
        pmk = pmk[:7]
    elif case == "pmk_strided":
        pmk = pmk[:, ::2]
    elif case == "dtype":
        last = last.to(torch.int16)
    elif case == "target_width":
        tgt = tgt[:, :15]
    elif case == "net_count":
        full = full[:2]
    elif case == "strided":
        prf = prf.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "two_net_axes":
        prf = prf[None]
    elif case == "device":
        tgt = tgt.to("meta")
    return pmk, prf, full, last, tgt


@pytest.mark.parametrize("case", ["pmk_dtype", "pmk_rows", "pmk_strided", "dtype",
                                  "target_width", "net_count", "strided", "two_net_axes",
                                  "device"])
def test_cmac_input_check_refuses(case):
    with pytest.raises(ValueError):
        verify_cuda.check_cmac(*_bad(case, _operands("kv3")))


def test_input_checks_accept_the_step_shapes():
    pmk, prf, full, last, tgt = _operands("kv3")
    assert verify_cuda.check_cmac(pmk, prf, full, last, tgt) == (3, 21, full.shape[1])
    empty = torch.zeros((3, 0, 16), dtype=torch.int32)   # F = 0
    assert verify_cuda.check_cmac(pmk, prf, empty, last, tgt) == (3, 21, 0)
    _, prf, eap, t4 = _operands("kv1")
    assert verify_cuda.check_eapol(pmk, prf, eap, t4, 1) == (3, 21, 3)
    with pytest.raises(ValueError, match="keyver"):
        verify_cuda.check_eapol(pmk, prf, eap, t4, 3)
    with pytest.raises(ValueError):
        verify_cuda.check_eapol(pmk, prf, eap[:, :, :8], t4, 2)
    _, blk, t4 = _operands("pmkid")
    assert verify_cuda.check_pmkid(pmk, blk, t4) == 3
    with pytest.raises(ValueError):
        verify_cuda.check_pmkid(pmk, blk, t4[:, :3])
    with pytest.raises(ValueError):
        verify_cuda.check_pmkid(pmk, blk[:, ::2], t4)

"""JAX-package references for the port's CPU tests (numpy in, numpy
out)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from dwpa_tpu.ops import vpu_probe
from dwpa_tpu.ops.pbkdf2 import pbkdf2_sha1_pmk as jax_pbkdf2
from dwpa_tpu.ops.pbkdf2_pallas import pbkdf2_sha1_pmk_pallas
from dwpa_tpu.ops.sha1 import sha1_compress_rolled


def jax_xla_pmk(packed, s1, s2, iterations):
    """The JAX package's XLA PBKDF2 on numpy operands -> uint32[8, n]."""
    def cols(salt):
        return [jnp.asarray(salt)[..., i] for i in range(16)]

    return np.stack(jax_pbkdf2([jnp.asarray(packed[:, i]) for i in range(16)],
                               cols(s1), cols(s2), iterations=iterations))


def jax_pallas_pmk(packed, s1, s2):
    """The Pallas kernel in interpret mode at 2 iterations -> uint32[8, n]."""
    return np.asarray(pbkdf2_sha1_pmk_pallas(
        jnp.asarray(packed), jnp.asarray(s1), jnp.asarray(s2), iterations=2, tile=8,
        interpret=True, prologue_compress=sha1_compress_rolled))


def jax_probe(x, mix, iters):
    """The Pallas probe body ``vpu_probe._probe_kernel`` in interpret mode on
    uint32[5, 16, 128] -> uint32[16, 128] (tile 8, grid 2)."""
    body, _ = vpu_probe.MIXES[mix]
    return np.asarray(pl.pallas_call(
        functools.partial(vpu_probe._probe_kernel, iters, body),
        grid=(2,),
        in_specs=[pl.BlockSpec((5, 8, 128), lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.uint32),
        interpret=True)(jnp.asarray(x)))

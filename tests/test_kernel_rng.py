"""The kernel's counter-based generator against jax.random.

The kernel evaluates threefry2x32 with uint32 add/rotate/xor and maps the
bits to uniforms and normals the way jax.random does, so its draws ARE the
scan's draws. These tests pin that identity: the cipher against the
published known-answer vectors, the key derivations (fold_in, split) and
the bit/uniform/normal mappings against jax.random, and the same code run
inside a Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from monte_carlo_retirement_tpu.engine.pallas_kernel import (
    bits_to_normal,
    bits_to_unit,
    fold_in,
    random_bits,
    threefry2x32,
)
from monte_carlo_retirement_tpu.ops.shocks import JUMP_FOLD_OFFSET


def _words(key):
    k = np.asarray(jax.random.key_data(key), np.uint32)
    return jnp.uint32(k[0]), jnp.uint32(k[1])


# Threefry-2x32 (20 rounds) known-answer vectors from the Random123 suite:
# (key0, key1, ctr0, ctr1) -> (out0, out1).
@pytest.mark.parametrize(
    "vector",
    [
        ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
         (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
         (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
         (0xC4923A9C, 0x483DF7A0)),
    ],
)
def test_threefry_known_answer_vectors(vector):
    (k0, k1, x0, x1), want = vector
    got = threefry2x32(
        jnp.uint32(k0), jnp.uint32(k1), jnp.uint32(x0), jnp.uint32(x1)
    )
    assert (int(got[0]), int(got[1])) == want


@pytest.mark.parametrize("seed", [0, 7, 2026, 2**31 + 5])
def test_fold_in_and_bits_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    k0, k1 = _words(key)
    for data in (0, 1, 600, JUMP_FOLD_OFFSET + 13):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        got = fold_in(k0, k1, jnp.int32(data))
        np.testing.assert_array_equal(
            np.asarray([int(got[0]), int(got[1])], np.uint32), want
        )
    counters = jnp.arange(3 * 100, dtype=jnp.uint32)
    want_bits = np.asarray(jax.random.bits(key, (100, 3), jnp.uint32)).ravel()
    np.testing.assert_array_equal(
        np.asarray(random_bits(k0, k1, counters)), want_bits
    )


def test_split_keys_match_jax_random():
    """The crash stream splits its month key in two (ops/shocks.py): the
    kernel's (0, 0) / (0, 1) counters are jax.random.split's children."""
    key = jax.random.fold_in(jax.random.PRNGKey(11), JUMP_FOLD_OFFSET + 4)
    k0, k1 = _words(key)
    want = np.asarray(jax.random.key_data(jax.random.split(key)))
    for child, ctr in enumerate((0, 1)):
        got = threefry2x32(k0, k1, jnp.uint32(0), jnp.uint32(ctr))
        np.testing.assert_array_equal(
            np.asarray([int(got[0]), int(got[1])], np.uint32), want[child]
        )


def _kernel_draws(key, n_rows):
    """Normals (n_rows, 3) and uniforms (n_rows,) drawn INSIDE a Pallas
    kernel (interpret mode) with the kernel's own generator."""
    k = jnp.asarray(jax.random.key_data(key), jnp.uint32)

    def kernel(key_ref, z_ref, u_ref):
        k0, k1 = key_ref[0], key_ref[1]
        row = jax.lax.broadcasted_iota(jnp.uint32, (n_rows,), 0)
        for j in range(3):
            z_ref[j, :] = bits_to_normal(random_bits(k0, k1, row * 3 + j))
        u_ref[...] = bits_to_unit(random_bits(k0, k1, row))

    z, u = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((3, n_rows), jnp.float32),
            jax.ShapeDtypeStruct((n_rows,), jnp.float32),
        ],
        backend="triton",
        interpret=True,
    )(k)
    return np.asarray(z).T, np.asarray(u)


@pytest.mark.parametrize("seed", [3, 2024])
def test_in_kernel_normals_and_uniforms_equal_jax_random(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    z, u = _kernel_draws(key, 256)
    np.testing.assert_array_equal(
        z, np.asarray(jax.random.normal(key, (256, 3), jnp.float32))
    )
    np.testing.assert_array_equal(
        u, np.asarray(jax.random.uniform(key, (256,), jnp.float32))
    )
    assert np.isfinite(z).all() and (0.0 <= u).all() and (u < 1.0).all()


def test_normal_mapping_covers_both_ends_of_the_bit_range():
    """The extreme bit patterns map like jax.random.normal: the lowest
    clamps to nextafter(-1, 0) (finite), the highest stays below 1."""
    bits = jnp.asarray([0, 1, 0x7FFFFFFF, 0xFFFFFFFF], jnp.uint32)
    z = np.asarray(bits_to_normal(bits))
    assert np.isfinite(z).all()
    assert z[0] < -5.0 and z[-1] > 5.0
    want = np.asarray(
        jnp.sqrt(2.0).astype(jnp.float32) * jax.lax.erf_inv(jnp.maximum(
            np.nextafter(np.float32(-1), np.float32(0)),
            np.asarray(bits_to_unit(bits)) * np.float32(2.0)
            + np.nextafter(np.float32(-1), np.float32(0)),
        ))
    )
    np.testing.assert_array_equal(z, want)
    assert np.asarray(bits_to_unit(bits))[-1] < 1.0

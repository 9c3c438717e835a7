"""CI pin of the kernel's normal sampler.

The kernel maps 23 random mantissa bits to a uniform u in (-1, 1) and
through sqrt(2) * erf_inv(u) — the mapping of jax.random.normal, with
erf_inv evaluated by XLA's single-precision polynomial (the same
approximation the Pallas Triton lowering emits). The draws themselves are
pinned bit for bit against jax.random in tests/test_kernel_rng.py and on
the card by chip_smoke.py phase 3; this test keeps the mapping's accuracy
and shape honest in float32 against scipy's erfinv on a dense strided
subgrid plus the extreme representable inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

scipy = pytest.importorskip("scipy", reason="scipy provides the erfinv truth")
import scipy.special  # noqa: E402

from monte_carlo_retirement_tpu.engine.pallas_kernel import (  # noqa: E402
    bits_to_normal,
    bits_to_unit,
)

SQRT2 = np.sqrt(2.0)
LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _sampler_f32(r: np.ndarray) -> tuple:
    """The kernel's exact mapping (pallas_kernel.bits_to_normal) for 23-bit
    integers r: returns (z, u) — callers need the uniform for the truth."""
    bits = jnp.asarray(r.astype(np.uint32) << np.uint32(9))
    z = np.asarray(bits_to_normal(bits))
    u = np.maximum(LO, np.asarray(bits_to_unit(bits)) * np.float32(2.0) + LO)
    return z, u


def _grid() -> np.ndarray:
    # Prime stride over the 23-bit domain (~270k points) + both extreme tails.
    r = np.arange(0, 1 << 23, 31, dtype=np.int64)
    edges = np.array([0, 1, 2, (1 << 23) - 3, (1 << 23) - 2, (1 << 23) - 1])
    return np.unique(np.concatenate([r, edges]))


def test_polynomial_matches_erfinv_to_spec():
    z, x = _sampler_f32(_grid())
    true = SQRT2 * scipy.special.erfinv(x.astype(np.float64))
    rel = np.abs(z.astype(np.float64) - true) / np.maximum(np.abs(true), 1e-12)
    # XLA's single-precision erf_inv: ~6e-6 worst case near |u| -> 1.
    assert float(rel.max()) < 1.0e-5, f"max rel err {rel.max():.3e}"


def test_quantile_is_finite_monotone_and_odd():
    r = _grid()
    z, x = _sampler_f32(r)
    assert np.isfinite(z).all()  # never +-inf even at the extreme inputs
    assert (np.diff(z) >= 0).all(), "quantile must be nondecreasing"
    # Tails reach the 23-bit design range (~5.3 sigma) and are symmetric.
    assert 5.2 < -z[0] < 5.5 and 5.0 < z[-1] < 5.5
    # The bit mapping is odd up to one uniform step (r' = 2^23-1-r gives
    # u' = -u + 2^-23) and the quantile itself is exactly odd.
    _, x_neg = _sampler_f32((1 << 23) - 1 - r)
    np.testing.assert_allclose(x_neg, -x, rtol=0, atol=2.0 ** -22)
    z_odd = np.asarray(
        SQRT2.astype(np.float32) * jax.lax.erf_inv(jnp.asarray(-x))
    )
    np.testing.assert_array_equal(z_odd, -z)


def test_quantile_moments_are_standard_normal():
    # The strided uniform grid is a quadrature over x ~ U(-1,1); through the
    # quantile map the moments must be standard normal.
    z, _ = _sampler_f32(_grid())
    z = z.astype(np.float64)
    assert abs(z.mean()) < 1e-4
    assert abs(z.var() - 1.0) < 1e-3
    kurt = (z**4).mean() / z.var() ** 2
    assert abs(kurt - 3.0) < 0.05

"""Antithetic-variates sampling (config.antithetic — extension, no reference
analog; the reference draws iid paths only, backend/simulation.py:452-474).

Contracts pinned here:
  * Pairing identities — scan path 2i+1 simulates under the exact negation of
    path 2i's shocks; Pallas block 2k+1 replays block 2k's PRNG stream with
    every normal negated.
  * Half-batch embedding — the even members of an antithetic batch are
    bit-identical to an iid batch of half the size (scan: rows, Pallas:
    blocks), so turning the flag on never changes the underlying sample space.
  * Unbiasedness + variance reduction — the estimator mean is preserved while
    its seed-to-seed variance drops (the feature's whole point).
  * Mode is compile-time structure: scenario batches must not mix it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
from monte_carlo_retirement_tpu.engine.pallas_kernel import (
    BLOCK_PATHS,
    pallas_simulate,
    statics_from_config,
)
from monte_carlo_retirement_tpu.engine.runner import Engine
from monte_carlo_retirement_tpu.engine.scenario_batch import (
    grid_statics,
    run_scenario_batch,
)
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import monthly_shocks, stream_keys
from tests.conftest import make_config

STOCHASTIC = dict(
    initial_balance=400_000.0,
    monthly_contribution=2_000.0,
    monthly_expenses=3_000.0,
    inv1_returns_mean=0.08,
    inv1_returns_volatility=0.16,
    inflation_rate_mean=0.03,
    inflation_rate_volatility=0.012,
    equity_inflation_correlation=0.3,
)


def test_monthly_shocks_antithetic_pairing():
    """Odd rows are the exact negation of even rows (all three factors, even
    with rho-mixing — negation commutes with the linear construction), and
    even rows embed the iid half-batch bit for bit."""
    search, _ = stream_keys(11)
    anti = monthly_shocks(
        search, jnp.int32(5), 64, jnp.float64(0.4), jnp.float64, antithetic=True
    )
    iid_half = monthly_shocks(
        search, jnp.int32(5), 32, jnp.float64(0.4), jnp.float64
    )
    for a, h in zip(anti, iid_half):
        a = np.asarray(a)
        np.testing.assert_array_equal(a[1::2], -a[0::2])
        np.testing.assert_array_equal(a[0::2], np.asarray(h))
    # Odd batch: the trailing unpaired path is the +z member of the next pair.
    odd = monthly_shocks(
        search, jnp.int32(5), 9, jnp.float64(0.4), jnp.float64, antithetic=True
    )
    for a, o in zip(anti, odd):
        np.testing.assert_array_equal(np.asarray(o), np.asarray(a)[:9])


def test_scan_kernel_even_paths_match_iid_half_run():
    """simulate_paths(antithetic)[::2] == simulate_paths(iid, n/2) exactly:
    the flag only re-indexes the draw table, the month math is untouched."""
    cfg = make_config(retirement_years=5, seed=7, **STOCHASTIC)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(7)
    kwargs = dict(
        t_scan=120, retirement_years=5, traj_len=11, dtype=jnp.float64
    )
    anti = simulate_paths(
        params, jnp.int32(24), key, n_paths=64, antithetic=True, **kwargs
    )
    iid = simulate_paths(params, jnp.int32(24), key, n_paths=32, **kwargs)
    for a, h in zip(jax.tree_util.tree_leaves(anti), jax.tree_util.tree_leaves(iid)):
        np.testing.assert_array_equal(np.asarray(a)[0::2], np.asarray(h))
    # The odd members are genuinely different paths (negated shocks).
    assert not np.array_equal(
        np.asarray(anti.final_balance)[1::2], np.asarray(iid.final_balance)
    )


def test_pallas_even_blocks_match_iid_run():
    """Pallas pairing is the scan's path-level rule: path 2i+1 replays path
    2i's draws negated, and even path 2i reads draw row i — so the even
    paths of an antithetic run reproduce a half-size iid run bit for bit
    (interpret mode; the kernel keys draws by global path on the card
    too)."""
    cfg = make_config(retirement_years=2, seed=303, **STOCHASTIC)
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    kwargs = dict(
        retirement_years=2, n_streams=params.n_streams, interpret=True
    )
    anti_statics = statics_from_config(
        make_config(retirement_years=2, seed=303, antithetic=True, **STOCHASTIC)
    )
    assert anti_statics.antithetic
    n = 2 * BLOCK_PATHS + 6
    succ_a, final_a = pallas_simulate(
        params, 6, 99, n_paths=2 * n, statics=anti_statics, **kwargs,
    )
    succ_i, final_i = pallas_simulate(
        params, 6, 99, n_paths=n, statics=statics_from_config(cfg), **kwargs,
    )
    final_a = np.asarray(final_a)[:2 * n]
    final_i = np.asarray(final_i)[:n]
    # antithetic even paths == iid paths 0..n-1
    np.testing.assert_array_equal(final_a[0::2], final_i)
    np.testing.assert_array_equal(
        np.asarray(succ_a)[:2 * n][0::2], np.asarray(succ_i)[:n]
    )
    # odd paths are the negated-shock twins, not copies
    assert not np.array_equal(final_a[1::2], final_a[0::2])


def test_antithetic_is_unbiased_and_reduces_variance():
    """Across independent seeds, the antithetic estimator of mean final
    balance has the same expectation as iid sampling but materially lower
    variance. Deterministic (fixed seed set), so thresholds are pins, not
    flaky statistics."""
    cfg = make_config(retirement_years=5, **STOCHASTIC)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    kwargs = dict(
        n_paths=256, t_scan=120, retirement_years=5, traj_len=0,
        dtype=jnp.float64,
    )

    def mean_final(seed, antithetic):
        _, key = stream_keys(seed)
        outs = simulate_paths(
            params, jnp.int32(24), key, antithetic=antithetic, **kwargs
        )
        return float(jnp.mean(outs.final_balance))

    seeds = range(100, 124)
    iid = np.asarray([mean_final(s, False) for s in seeds])
    anti = np.asarray([mean_final(s, True) for s in seeds])
    # Unbiased: the two grand means agree within their own spread.
    pooled_sem = np.sqrt((iid.var() + anti.var()) / len(iid))
    assert abs(iid.mean() - anti.mean()) < 4.0 * pooled_sem
    # Variance reduction: the measured ratio is ~10x for this scenario;
    # assert a conservative 2x so the pin survives scenario drift.
    assert anti.var() < 0.5 * iid.var(), (
        f"antithetic variance {anti.var():.4g} not below half of iid "
        f"{iid.var():.4g}"
    )


def test_engine_end_to_end_with_antithetic():
    """The flag flows config -> Engine -> both backends' statics/jits; the
    full-statistics run and the probe path both produce sane results."""
    cfg = make_config(retirement_years=5, antithetic=True, **STOCHASTIC)
    eng = Engine(cfg)
    assert eng.statics.antithetic
    res = eng.run(24, 400)
    assert 0.0 <= res.success_probability <= 100.0
    assert np.isfinite(res.final_balance_percentiles).all()
    probs = eng.probe([0, 12, 24], 200, stream="search")
    assert all(0.0 <= p <= 100.0 for p in probs)
    # Same scenario without the flag: different estimate stream (the odd
    # paths changed), same sample space for the even half.
    res_iid = Engine(make_config(retirement_years=5, **STOCHASTIC)).run(24, 400)
    assert abs(res.success_probability - res_iid.success_probability) < 15.0


def test_scenario_batch_rejects_mixed_antithetic():
    cfg_a = make_config(antithetic=True, **STOCHASTIC)
    cfg_b = make_config(**STOCHASTIC)
    with pytest.raises(ValueError, match="antithetic"):
        run_scenario_batch([cfg_a, cfg_b], [0, 0], 64, seed=1)
    # The Pallas grid guard (shared compile-time Statics) catches it too.
    with pytest.raises(ValueError, match="[Ss]tatics"):
        grid_statics([cfg_a, cfg_b])
    # Uniform batches pass.
    assert grid_statics([cfg_a, cfg_a]).antithetic

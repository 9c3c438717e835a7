"""Allocation glide path (config.allocation_inv1_final_pct — extension, no
reference analog; the reference's allocation is constant,
backend/simulation.py:274-359 rebalances to one fixed target).

Semantics pinned here:
  * The rebalance/contribution target moves LINEARLY in time from
    allocation_inv1_pct at T=0 to allocation_inv1_final_pct at retirement
    (month W), then holds through retirement. The T=0 split stays at the
    start allocation.
  * Closed-form zero-vol replay: the scan kernel matches an independent
    numpy month loop at 1e-9.
  * Both kernels implement the same glide: injected identical shocks produce
    identical outcomes (the standing scan/Pallas contract).
  * Default off: a config without the field has alloc1_final == alloc1 and
    statics.glide False; a non-glide Pallas kernel never reads the endpoint
    leaf, and the grid guard rejects glide rows under non-glide statics.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
from monte_carlo_retirement_tpu.engine.pallas_kernel import (
    _check_grid_statics,
    pallas_simulate,
    statics_from_config,
)
from monte_carlo_retirement_tpu.engine.runner import Engine
from monte_carlo_retirement_tpu.engine.scenario_batch import (
    grid_statics,
    stack_params,
)
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import stream_keys
from tests.conftest import DETERMINISTIC, make_config
from tests.test_pallas_parity import N_PATHS, _drawn_shocks


def _glide_replay(b0, contrib, g1, a0, af, months):
    """Independent numpy replay of the accumulation phase under a linear
    glide with zero taxes: growth, contribution at the month's target,
    exact rebalance to the month's target."""
    b1, b2 = b0 * a0, b0 * (1.0 - a0)
    for m in range(1, months + 1):
        b1 *= g1
        al = a0 + (af - a0) * m / months
        b1 += contrib * al
        b2 += contrib * (1.0 - al)
        total = b1 + b2
        b1, b2 = total * al, total * (1.0 - al)
    return b1, b2


def test_zero_vol_glide_matches_numpy_replay():
    """Equity-only -> bonds-only glide over 12 working months, zero vol,
    zero taxes, zero inflation: the final balance equals the replay exactly
    (retirement holds the 0%-growth final target, so wealth freezes)."""
    cfg = make_config(**{
        **DETERMINISTIC,
        "initial_balance": 100_000.0,
        "monthly_contribution": 1_000.0,
        "monthly_expenses": 0.0,
        "retirement_years": 3,
        "allocation_inv1_pct": 1.0,
        "allocation_inv1_final_pct": 0.0,
        "inv1_returns_mean": 0.10,
    })
    eng = Engine(cfg)
    assert eng.statics.glide
    res = eng.run(12, 4)
    g1 = (1.0 + 0.10) ** (1.0 / 12.0)
    b1, b2 = _glide_replay(100_000.0, 1_000.0, g1, 1.0, 0.0, 12)
    assert b1 == pytest.approx(0.0, abs=1e-9)
    np.testing.assert_allclose(res.final_balance, b1 + b2, rtol=1e-9)
    assert res.success_probability == 100.0


def test_zero_vol_midpoint_target_weights():
    """At an intermediate month the portfolio sits exactly on the
    interpolated target: glide 0.8 -> 0.2 over 10 months, stop the horizon
    mid-glide via the trajectory (asset mix inferred from growth)."""
    a0, af, W = 0.8, 0.2, 10
    cfg = make_config(**{
        **DETERMINISTIC,
        "initial_balance": 10_000.0,
        "monthly_contribution": 0.0,
        "monthly_expenses": 0.0,
        "retirement_years": 2,
        "allocation_inv1_pct": a0,
        "allocation_inv1_final_pct": af,
        "inv1_returns_mean": 0.20,
    })
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(1)
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=2, t_scan=60,
        retirement_years=2, traj_len=4, dtype=jnp.float64,
    )
    g1 = (1.2) ** (1.0 / 12.0)
    b1, b2 = 10_000.0 * a0, 10_000.0 * (1.0 - a0)
    for m in range(1, W + 1):
        b1 *= g1
        al = a0 + (af - a0) * m / W
        total = b1 + b2
        b1, b2 = total * al, total * (1.0 - al)
        if m == 5:
            # month 5 target: halfway between a0 and af
            assert al == pytest.approx((a0 + af) / 2.0)
    # Retirement (2y at target af, no expenses): asset 1 keeps growing.
    for _ in range(24):
        b1 *= g1
        total = b1 + b2
        b1, b2 = total * af, total * (1.0 - af)
    np.testing.assert_allclose(
        np.asarray(outs.final_balance), b1 + b2, rtol=1e-9
    )


def test_glide_pallas_matches_scan_with_injected_shocks():
    """Identical shocks through both kernels under a glide + realized-gains
    taxes: identical success flags, near-identical balances (f32
    reassociation only) — the standing cross-kernel contract extended to
    the glide code path."""
    W, R = 25, 5
    cfg = make_config(
        retirement_years=R,
        seed=99,
        initial_balance=300_000.0,
        monthly_contribution=4_000.0,
        monthly_expenses=7_000.0,
        allocation_inv1_pct=0.9,
        allocation_inv1_final_pct=0.35,
        inv1_returns_mean=0.09,
        inv1_returns_volatility=0.14,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.15,
        inv2_use_realized_gains_tax_system=True,
        inv2_realized_gains_tax_rate=0.10,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.015,
        equity_inflation_correlation=0.25,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    assert statics.glide
    _, key = stream_keys(99)
    T = W + 12 * R
    shocks = _drawn_shocks(key, T, N_PATHS)
    succ_p, final_p = pallas_simulate(
        params, W, 0,
        n_paths=N_PATHS, retirement_years=R,
        n_streams=params.n_streams, statics=statics,
        shocks=shocks, with_shocks=True, interpret=True,
    )
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=N_PATHS, t_scan=T,
        retirement_years=R, traj_len=0, dtype=jnp.float32,
    )
    succ_p = np.asarray(succ_p)[:N_PATHS] > 0.5
    succ_s = np.asarray(outs.success)
    assert succ_s.mean() not in (0.0, 1.0)  # mixed outcomes, a real test
    np.testing.assert_array_equal(succ_p, succ_s)
    # Same tolerance shape as test_pallas_parity, plus a $5 absolute floor:
    # near-ruin dust balances (tens of dollars left after 300 months of
    # big-minus-big arithmetic) amplify f32 reassociation into percents.
    final_pa = np.asarray(final_p)[:N_PATHS]
    final_sa = np.asarray(outs.final_balance)
    diff = np.abs(final_pa - final_sa)
    rel = diff / np.maximum(np.abs(final_sa), 1.0)
    bad = (rel > 5e-3) & (diff > 5.0)
    assert not bad.any(), (
        f"final-balance divergence beyond tolerance: max rel {rel.max():.2e}, "
        f"max abs {diff.max():.2f}"
    )


def test_glide_off_is_inert():
    """No configured glide: alloc1_final mirrors alloc1, statics.glide is
    False, and a non-glide Pallas kernel ignores the endpoint leaf entirely
    (same bits for any value in it)."""
    cfg = make_config(retirement_years=2)
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(params.alloc1_final), np.asarray(params.alloc1)
    )
    statics = statics_from_config(cfg)
    assert not statics.glide
    kw = dict(
        n_paths=N_PATHS, retirement_years=2,
        n_streams=params.n_streams, statics=statics, interpret=True,
    )
    base = pallas_simulate(params, 6, 5, **kw)
    poisoned = pallas_simulate(
        params._replace(alloc1_final=jnp.float32(0.123)), 6, 5, **kw
    )
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(poisoned[1]))


def test_grid_guards_reject_mixed_or_mismatched_glide():
    base = dict(retirement_years=5)
    cfg_g = make_config(allocation_inv1_final_pct=0.2, **base)
    cfg_n = make_config(**base)
    with pytest.raises(ValueError, match="[Ss]tatics"):
        grid_statics([cfg_g, cfg_n])
    assert grid_statics([cfg_g, cfg_g]).glide
    # A glide row dispatched under non-glide statics would silently ignore
    # the endpoint — the pre-dispatch guard must refuse it.
    batch = stack_params([cfg_g, cfg_g], dtype=jnp.float32)
    with pytest.raises(ValueError, match="[Ss]tatics"):
        _check_grid_statics(batch, statics_from_config(cfg_n))


def test_glide_endpoint_is_tunable_by_analysis_surfaces():
    """The glide endpoint joins the sensitivity/optimizer parameter registry:
    probing works on a glide base, errors cleanly on a null base (turning
    the feature on is a Statics change, not a perturbation), and the
    optimizer can sweep the endpoint from ANY base (every variant sets it,
    so the grid's compile-time statics stay uniform)."""
    from monte_carlo_retirement_tpu.engine.optimize import optimize_params
    from monte_carlo_retirement_tpu.engine.sensitivity import sensitivity_fd

    base = dict(
        retirement_years=5,
        initial_balance=400_000.0,
        monthly_expenses=2_500.0,
        num_simulations_main=64,
    )
    rows = sensitivity_fd(
        make_config(allocation_inv1_final_pct=0.4, **base),
        working_months=24,
        params=["allocation_inv1_final_pct"],
        num_paths=64,
    )
    assert rows[0].param == "allocation_inv1_final_pct"
    assert np.isfinite(rows[0].d_success)
    with pytest.raises(ValueError, match="unset"):
        sensitivity_fd(
            make_config(**base),
            working_months=24,
            params=["allocation_inv1_final_pct"],
            num_paths=64,
        )
    res = optimize_params(
        make_config(**base),
        working_months=24,
        params=["allocation_inv1_final_pct"],
        points=3,
        rounds=1,
        num_paths=64,
    )
    assert 0.0 <= res.best.values[0] <= 1.0


def test_glide_toward_bonds_reduces_deterministic_growth():
    """Sanity ordering: with positive equity drift and zero vol, gliding out
    of equities ends with less wealth than holding the start allocation."""
    common = {
        **DETERMINISTIC,
        "initial_balance": 200_000.0,
        "monthly_contribution": 0.0,
        "monthly_expenses": 0.0,
        "retirement_years": 2,
        "allocation_inv1_pct": 0.9,
        "inv1_returns_mean": 0.12,
    }
    hold = Engine(make_config(**common)).run(24, 2)
    glide = Engine(
        make_config(allocation_inv1_final_pct=0.1, **common)
    ).run(24, 2)
    assert glide.final_balance[0] < hold.final_balance[0]
    # W = 0: no accumulation months; retirement rebalances to the endpoint
    # from month one (the T=0 split stays at the start allocation).
    w0 = Engine(make_config(allocation_inv1_final_pct=0.1, **common)).run(0, 2)
    assert w0.success_probability == 100.0

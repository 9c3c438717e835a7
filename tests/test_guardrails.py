"""Dynamic spending guardrails (config.spending_guardrails — extension, no
reference analog; the reference's retirement spending is a fixed real
amount, backend/simulation.py:644-647).

Contracts pinned here:
  * Closed-form zero-vol replay: the year-start multiplier updates (cut
    above the band, raise below, floor/cap clamps, year 0 untouched) match
    an independent numpy month loop at 1e-9, including the recorded
    withdrawal-rate trajectory.
  * Both kernels implement the same rule: injected identical shocks produce
    identical outcomes (the standing scan/Pallas contract).
  * Default off: sentinel parameter leaves keep the multiplier at 1.0 bit
    for bit (the scan kernel computes the no-op algebra; a non-guardrails
    Pallas kernel never reads the leaves at all), and the grid guard
    refuses live-rule rows under a rule-free executable.
  * Config validation: bands must be ordered.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_retirement_tpu.config import Config
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
from tests.conftest import DETERMINISTIC, base_config_dict, make_config
from tests.test_pallas_parity import N_PATHS, _drawn_shocks

RULE = dict(
    upper_wr_pct=6.0,
    lower_wr_pct=3.0,
    adjustment_pct=10.0,
    floor_pct=50.0,
    cap_pct=200.0,
)


def _replay(start, monthly_exp, g, years, rule):
    """Independent numpy replay: single asset, zero taxes, zero inflation.
    Returns (final_balance, per-year spending multipliers)."""
    bal, s, mults = start, 1.0, []
    up, lo = rule["upper_wr_pct"] / 100, rule["lower_wr_pct"] / 100
    adj = rule["adjustment_pct"] / 100
    floor, cap = rule["floor_pct"] / 100, rule["cap_pct"] / 100
    for ret_idx in range(years * 12):
        if ret_idx % 12 == 0:
            if ret_idx > 0:
                wr = 12.0 * monthly_exp * s / max(bal, 1e-6)
                if wr > up:
                    s = s * (1.0 - adj)
                elif wr < lo:
                    s = s * (1.0 + adj)
                s = min(max(s, floor), cap)
            mults.append(s)
        bal *= g
        bal -= monthly_exp * s
    return bal, mults


@pytest.mark.parametrize(
    "start,exp,mean,moves",
    [
        (100_000.0, 1_000.0, 0.0, True),   # WR 12% > band: cuts to the floor
        (1_000_000.0, 1_000.0, 0.08, True),  # WR 1.2% < band: raises to cap
        (300_000.0, 1_200.0, 0.048, False),  # WR 4.8% in-band: never moves
    ],
)
def test_zero_vol_guardrails_match_numpy_replay(start, exp, mean, moves):
    cfg = make_config(**{
        **DETERMINISTIC,
        "initial_balance": start,
        "monthly_contribution": 0.0,
        "monthly_expenses": exp,
        "retirement_years": 10,
        "allocation_inv1_pct": 1.0,
        "inv1_returns_mean": mean,
        "spending_guardrails": dict(RULE),
    })
    eng = Engine(cfg)
    assert eng.statics.guardrails
    res = eng.run(0, 2)
    g = (1.0 + mean) ** (1.0 / 12.0)
    final, mults = _replay(start, exp, g, 10, RULE)
    np.testing.assert_allclose(
        res.final_balance, max(0.0, final), rtol=1e-9, atol=1e-6
    )
    # Year 0 always spends the plan; band-crossing cases actually move.
    assert mults[0] == 1.0 and (mults[-1] != 1.0) == moves
    # Recorded WR trajectory = actual gross per year / start balance.
    wr_med = res.wr_percentiles[2]
    expect_wr = [12.0 * exp * s / start * 100.0 for s in mults]
    np.testing.assert_allclose(wr_med, expect_wr, rtol=1e-6)


def test_guardrails_pallas_matches_scan_with_injected_shocks():
    W, R = 13, 6
    cfg = make_config(
        retirement_years=R,
        seed=404,
        initial_balance=250_000.0,
        monthly_contribution=3_000.0,
        monthly_expenses=2_400.0,
        inv1_returns_mean=0.08,
        inv1_returns_volatility=0.15,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.12,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        spending_guardrails=dict(RULE),
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    assert statics.guardrails
    _, key = stream_keys(404)
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
    succ_s = np.asarray(outs.success)
    np.testing.assert_array_equal(np.asarray(succ_p)[:N_PATHS] > 0.5, succ_s)
    final_s = np.asarray(outs.final_balance)
    diff = np.abs(np.asarray(final_p)[:N_PATHS] - final_s)
    rel = diff / np.maximum(np.abs(final_s), 1.0)
    bad = (rel > 5e-3) & (diff > 5.0)
    assert not bad.any(), (
        f"max rel {rel.max():.2e}, max abs {diff.max():.2f}"
    )


def test_guardrails_off_is_inert():
    cfg = make_config(retirement_years=2)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    # Sentinel leaves: rule-off keeps the multiplier at 1.0 exactly.
    assert float(params.gr_upper) == np.inf
    assert float(params.gr_adjust) == 0.0
    statics = statics_from_config(cfg)
    assert not statics.guardrails
    # A non-guardrails Pallas kernel never reads the leaves.
    p32 = SimParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(
        n_paths=N_PATHS, retirement_years=2,
        n_streams=p32.n_streams, statics=statics, interpret=True,
    )
    base = pallas_simulate(p32, 6, 5, **kw)
    poisoned = pallas_simulate(
        p32._replace(
            gr_upper=jnp.float32(0.01), gr_lower=jnp.float32(0.005),
            gr_adjust=jnp.float32(0.5),
        ), 6, 5, **kw,
    )
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(poisoned[1]))


def test_grid_guards_reject_mismatched_guardrails():
    cfg_g = make_config(spending_guardrails=dict(RULE))
    cfg_n = make_config()
    with pytest.raises(ValueError, match="[Ss]tatics"):
        grid_statics([cfg_g, cfg_n])
    assert grid_statics([cfg_g, cfg_g]).guardrails
    batch = stack_params([cfg_g, cfg_g], dtype=jnp.float32)
    with pytest.raises(ValueError, match="[Ss]tatics"):
        _check_grid_statics(batch, statics_from_config(cfg_n))


def test_guardrail_config_validation():
    with pytest.raises(Exception, match="below upper"):
        Config(**base_config_dict(
            spending_guardrails={"upper_wr_pct": 4.0, "lower_wr_pct": 5.0},
        ))
    cfg = make_config(
        spending_guardrails={"upper_wr_pct": 6.0, "lower_wr_pct": 2.0}
    )
    assert cfg.spending_guardrails.adjustment_pct == 10.0  # defaults apply


def test_guardrail_bands_are_tunable_by_analysis_surfaces():
    """Dotted parameter paths: the guardrail bands join the FD sensitivity
    and optimizer registries (rule must exist on the base; AD refuses them
    with a clear message — they enter the kernel through comparisons)."""
    from monte_carlo_retirement_tpu.engine.optimize import optimize_params
    from monte_carlo_retirement_tpu.engine.sensitivity import (
        sensitivity_ad,
        sensitivity_fd,
    )

    base = dict(
        retirement_years=8,
        initial_balance=260_000.0,
        monthly_expenses=2_300.0,
        inv1_returns_volatility=0.16,
        num_simulations_main=64,
    )
    cfg = make_config(spending_guardrails=dict(RULE), **base)
    rows = sensitivity_fd(
        cfg, working_months=0,
        params=["spending_guardrails.upper_wr_pct"], num_paths=64,
    )
    assert rows[0].param == "spending_guardrails.upper_wr_pct"
    assert np.isfinite(rows[0].d_success)
    with pytest.raises(ValueError, match="unset"):
        sensitivity_fd(
            make_config(**base), working_months=0,
            params=["spending_guardrails.upper_wr_pct"], num_paths=64,
        )
    with pytest.raises(ValueError, match="FD-only"):
        sensitivity_ad(
            cfg, working_months=0,
            params=["spending_guardrails.upper_wr_pct"], num_paths=64,
        )
    # Band sweeps intersect default bounds with the sibling band, so even a
    # bound-less sweep stays valid (regression: default bounds used to
    # generate lower >= upper configs and abort with a raw pydantic error).
    res = optimize_params(
        cfg, working_months=0,
        params=["spending_guardrails.upper_wr_pct"],
        bounds=[(4.0, 12.0)],
        points=3, rounds=1, num_paths=64,
    )
    assert 4.0 <= res.best.values[0] <= 12.0
    res = optimize_params(
        cfg, working_months=0,
        params=["spending_guardrails.lower_wr_pct"],
        points=3, rounds=1, num_paths=64,
    )
    assert 0.0 <= res.best.values[0] < RULE["upper_wr_pct"]
    # Cross-field constraint degrades to a one-sided probe, not a failure:
    # lower_wr_pct one step below upper_wr_pct.
    tight = make_config(
        spending_guardrails={**RULE, "lower_wr_pct": RULE["upper_wr_pct"]
                             - 1e-4},
        **base,
    )
    rows = sensitivity_fd(
        tight, working_months=0,
        params=["spending_guardrails.lower_wr_pct"], num_paths=64,
    )
    assert rows[0].step_plus == 0.0 and rows[0].step_minus > 0.0


def test_guardrails_raise_success_in_overspend_scenarios():
    """Sanity ordering: when the plan overspends a volatile portfolio,
    cutting spending at the guardrail must not lower success probability
    (and raises it for this scenario)."""
    common = dict(
        initial_balance=500_000.0,
        monthly_contribution=0.0,
        monthly_expenses=2_600.0,
        retirement_years=25,
        inv1_returns_mean=0.07,
        inv1_returns_volatility=0.16,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        seed=11,
    )
    plain = Engine(make_config(**common)).run(0, 600)
    guarded = Engine(
        make_config(spending_guardrails=dict(RULE), **common)
    ).run(0, 600)
    assert guarded.success_probability > plain.success_probability + 5.0

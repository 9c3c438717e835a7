"""Market-crash jumps (config.market_crashes — extension, no reference
analog; the reference's returns are pure lognormal,
backend/simulation.py:452-474).

Contracts pinned here:
  * The compensator is exact: p=1 with zero size dispersion makes the jump a
    deterministic factor that the compensation cancels to machine round-off,
    and the one-month sampled mean of exp(J - c1) is 1 within MC error.
  * Frequency 0 is an exact no-op: a jumps-on executable with the p=0
    sentinel row reproduces the crash-free run bit for bit (the jump stream
    is a disjoint fold_in space, so the base shocks never move).
  * Both kernels implement the same rule: injected identical draws (base
    normals + jump uniform/normal planes) produce identical outcomes.
  * Default off: a non-jumps Pallas kernel never reads the jump leaves
    (poisoned-leaf), and the grid guards refuse live-crash rows under a
    crash-free executable.
  * The oracle implements the same arithmetic (randomized f64 differential).
  * Crash draws honor antithetic pairing (z negated, u reflected; even
    paths bit-match an iid half run).
  * Crash parameters are tunable through the FD sensitivity / optimizer
    surfaces; AD refuses them (dotted, step-function indicator).
"""

import jax
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
from monte_carlo_retirement_tpu.ops.shocks import (
    monthly_jump_draws,
    stream_keys,
)
from tests.conftest import DETERMINISTIC, base_config_dict, make_config
from tests.oracle import simulate_path_oracle
from tests.test_pallas_parity import N_PATHS, _drawn_shocks

CRASHES = dict(
    frequency_per_year=1.0,
    mean_drop_pct=25.0,
    size_volatility=0.3,
    inv2_beta=0.5,
)


def _jump_draws_np(key, months, n_paths, dtype=jnp.float64):
    """The exact (u, z) jump draws the scan kernel consumes, host-side."""
    out = np.empty((months, n_paths, 2))
    for m in range(1, months + 1):
        u, z = monthly_jump_draws(key, m, n_paths, dtype)
        out[m - 1, :, 0] = np.asarray(u)
        out[m - 1, :, 1] = np.asarray(z)
    return out


def test_crash_config_validation():
    with pytest.raises(Exception, match="frequency_per_year"):
        Config(**base_config_dict(
            market_crashes={"frequency_per_year": 13.0, "mean_drop_pct": 20.0}
        ))
    with pytest.raises(Exception, match="mean_drop_pct"):
        Config(**base_config_dict(
            market_crashes={"frequency_per_year": 1.0, "mean_drop_pct": 100.0}
        ))
    with pytest.raises(Exception, match="inv2_beta"):
        Config(**base_config_dict(
            market_crashes={
                "frequency_per_year": 1.0, "mean_drop_pct": 20.0,
                "inv2_beta": 1.5,
            }
        ))
    cfg = make_config(
        market_crashes={"frequency_per_year": 0.5, "mean_drop_pct": 20.0}
    )
    assert cfg.market_crashes.size_volatility == 0.0  # defaults apply
    assert cfg.market_crashes.inv2_beta == 0.0


def test_certain_deterministic_crash_is_fully_compensated():
    """frequency=12, size_volatility=0: every month jumps by exactly the
    median factor and the compensator cancels it — balances match the
    crash-free run to round-off (the closed form of the compensation)."""
    base = dict(
        DETERMINISTIC,
        initial_balance=200_000.0,
        monthly_expenses=1_000.0,
        retirement_years=5,
        allocation_inv1_pct=1.0,
        inv1_returns_mean=0.06,
    )
    plain = Engine(make_config(**base)).run(24, 2)
    crashed = Engine(make_config(
        market_crashes={
            "frequency_per_year": 12.0, "mean_drop_pct": 35.0,
            "size_volatility": 0.0, "inv2_beta": 1.0,
        },
        **base,
    )).run(24, 2)
    np.testing.assert_allclose(
        crashed.final_balance, plain.final_balance, rtol=1e-9
    )
    np.testing.assert_allclose(
        crashed.sample_trajectories, plain.sample_trajectories, rtol=1e-9
    )


def test_zero_frequency_is_bitwise_noop():
    """p=0 sentinel rows never jump and the compensator is exactly log(1)=0,
    so a jumps-on run reproduces the crash-free run BIT for bit (the base
    shock stream is untouched by construction)."""
    base = dict(retirement_years=4, seed=77, inv1_returns_volatility=0.18)
    plain = make_config(**base)
    zerof = make_config(
        market_crashes={"frequency_per_year": 0.0, "mean_drop_pct": 50.0,
                        "size_volatility": 1.0, "inv2_beta": 1.0},
        **base,
    )
    params_p = SimParams.from_config(plain, dtype=jnp.float64)
    params_z = SimParams.from_config(zerof, dtype=jnp.float64)
    assert float(params_z.jump_comp1) == 0.0
    assert float(params_z.jump_comp2) == 0.0
    _, key = stream_keys(77)
    kw = dict(n_paths=64, t_scan=60, retirement_years=4, traj_len=0,
              dtype=jnp.float64)
    off = simulate_paths(params_p, jnp.int32(12), key, jumps=False, **kw)
    on = simulate_paths(params_z, jnp.int32(12), key, jumps=True, **kw)
    np.testing.assert_array_equal(
        np.asarray(off.final_balance), np.asarray(on.final_balance)
    )
    np.testing.assert_array_equal(
        np.asarray(off.success), np.asarray(on.success)
    )


def test_compensator_is_exact_in_expectation():
    """Sampled E[exp(J - c1)] and E[exp(beta J - c2)] are 1 within MC error
    — the drift correction keeps the configured mean honest."""
    cfg = make_config(market_crashes=dict(
        frequency_per_year=6.0, mean_drop_pct=30.0, size_volatility=0.4,
        inv2_beta=0.5,
    ))
    p = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(7)
    n = 1 << 20
    u, z = monthly_jump_draws(key, 1, n, jnp.float64)
    u, z = np.asarray(u), np.asarray(z)
    jl = np.where(u < float(p.jump_p),
                  float(p.jump_mu) + float(p.jump_sigma) * z, 0.0)
    m1 = np.exp(jl - float(p.jump_comp1)).mean()
    m2 = np.exp(float(p.jump_beta) * jl - float(p.jump_comp2)).mean()
    assert m1 == pytest.approx(1.0, abs=3e-3)
    assert m2 == pytest.approx(1.0, abs=3e-3)
    # And the jump makes the monthly log return left-skewed — the point of
    # the extension (the compensated mean stays put; the tail fattens).
    r = 0.08 / 12 + 0.15 / np.sqrt(12) * np.random.default_rng(0).standard_normal(n)
    x = r + jl - float(p.jump_comp1)
    skew = ((x - x.mean()) ** 3).mean() / x.std() ** 3
    assert skew < -0.5


def test_crashes_pallas_matches_scan_with_injected_draws():
    W, R = 13, 6
    cfg = make_config(
        retirement_years=R,
        seed=505,
        initial_balance=250_000.0,
        monthly_contribution=3_000.0,
        monthly_expenses=2_400.0,
        inv1_returns_mean=0.08,
        inv1_returns_volatility=0.15,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.12,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        market_crashes=dict(CRASHES),
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    assert statics.jumps
    _, key = stream_keys(505)
    T = W + 12 * R
    base = _drawn_shocks(key, T, N_PATHS)  # (T, 3, n)
    jd = _jump_draws_np(key, T, N_PATHS, jnp.float32)  # (T, n, 2)
    planes = jnp.transpose(jnp.asarray(jd, jnp.float32), (0, 2, 1))
    shocks = jnp.concatenate([base, planes], axis=1)  # (T, 5, n)
    succ_p, final_p = pallas_simulate(
        params, W, 0,
        n_paths=N_PATHS, retirement_years=R,
        n_streams=params.n_streams, statics=statics,
        shocks=shocks, with_shocks=True, interpret=True,
    )
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=N_PATHS, t_scan=T,
        retirement_years=R, traj_len=0, dtype=jnp.float32, jumps=True,
    )
    succ_s = np.asarray(outs.success)
    np.testing.assert_array_equal(
        np.asarray(succ_p)[:N_PATHS] > 0.5, succ_s
    )
    final_s = np.asarray(outs.final_balance)
    diff = np.abs(np.asarray(final_p)[:N_PATHS] - final_s)
    rel = diff / np.maximum(np.abs(final_s), 1.0)
    bad = (rel > 5e-3) & (diff > 5.0)
    assert not bad.any(), f"max rel {rel.max():.2e}, max abs {diff.max():.2f}"


def test_crashes_off_pallas_leaves_unread():
    cfg = make_config(retirement_years=2)
    statics = statics_from_config(cfg)
    assert not statics.jumps
    p32 = SimParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(
        n_paths=N_PATHS, retirement_years=2,
        n_streams=p32.n_streams, statics=statics, interpret=True,
    )
    base = pallas_simulate(p32, 6, 5, **kw)
    poisoned = pallas_simulate(
        p32._replace(
            jump_p=jnp.float32(1.0), jump_mu=jnp.float32(-2.0),
            jump_sigma=jnp.float32(1.0), jump_beta=jnp.float32(1.0),
            jump_comp1=jnp.float32(0.5), jump_comp2=jnp.float32(0.5),
        ), 6, 5, **kw,
    )
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(poisoned[1]))


def test_grid_guards_reject_mismatched_crashes():
    cfg_c = make_config(market_crashes=dict(CRASHES))
    cfg_n = make_config()
    with pytest.raises(ValueError, match="[Ss]tatics"):
        grid_statics([cfg_c, cfg_n])
    assert grid_statics([cfg_c, cfg_c]).jumps
    batch = stack_params([cfg_c, cfg_c], dtype=jnp.float32)
    with pytest.raises(ValueError, match="[Ss]tatics"):
        _check_grid_statics(batch, statics_from_config(cfg_n))


@pytest.mark.parametrize("case", range(4))
def test_engine_matches_oracle_with_random_crashes(case):
    rng = np.random.default_rng(9100 + case)
    cfg = make_config(
        initial_balance=float(rng.uniform(50_000, 400_000)),
        monthly_contribution=float(rng.uniform(0, 4000)),
        monthly_expenses=float(rng.uniform(800, 4000)),
        retirement_years=int(rng.integers(2, 6)),
        allocation_inv1_pct=float(rng.uniform(0, 1)),
        inv1_returns_mean=float(rng.uniform(0.0, 0.12)),
        inv1_returns_volatility=float(rng.uniform(0.05, 0.2)),
        inv1_use_realized_gains_tax_system=bool(rng.random() < 0.5),
        inv1_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
        inv1_annual_tax_on_gains_rate=float(rng.uniform(0, 0.3)),
        inflation_rate_mean=float(rng.uniform(0.0, 0.06)),
        inflation_rate_volatility=float(rng.uniform(0, 0.03)),
        equity_inflation_correlation=float(rng.uniform(-1, 1)),
        market_crashes={
            "frequency_per_year": float(rng.uniform(0.1, 6.0)),
            "mean_drop_pct": float(rng.uniform(5.0, 60.0)),
            "size_volatility": float(rng.uniform(0.0, 0.8)),
            "inv2_beta": float(rng.uniform(0.0, 1.0)),
        },
        seed=int(rng.integers(0, 2**31)),
    )
    W = int(rng.integers(0, 30))
    R = cfg.retirement_years
    T = W + 12 * R
    n = 16
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(cfg.seed)
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=n, t_scan=T,
        retirement_years=R, traj_len=0, dtype=jnp.float64, jumps=True,
    )
    shocks = np.stack(
        [
            np.asarray(jax.random.normal(
                jax.random.fold_in(key, m), (n, 3), dtype=jnp.float64))
            for m in range(1, T + 1)
        ]
    )
    jd = _jump_draws_np(key, T, n)
    succ = np.asarray(outs.success)
    final = np.asarray(outs.final_balance)
    for p in range(n):
        expected = simulate_path_oracle(
            cfg, W, shocks[:, p, :], jump_shocks=jd[:, p, :]
        )
        assert bool(succ[p]) == expected["success"], f"case {case} path {p}"
        assert final[p] == pytest.approx(
            expected["final_balance"], rel=1e-8, abs=1e-6
        ), f"case {case} path {p}"


def test_crash_draws_honor_antithetic_pairing():
    _, key = stream_keys(3)
    u_a, z_a = monthly_jump_draws(key, 5, 8, jnp.float64, antithetic=True)
    u_i, z_i = monthly_jump_draws(key, 5, 4, jnp.float64)
    u_a, z_a = np.asarray(u_a), np.asarray(z_a)
    # Even paths bit-match the iid half run; odd paths mirror their pair.
    np.testing.assert_array_equal(u_a[0::2], np.asarray(u_i))
    np.testing.assert_array_equal(z_a[0::2], np.asarray(z_i))
    np.testing.assert_array_equal(u_a[1::2], 1.0 - u_a[0::2])
    np.testing.assert_array_equal(z_a[1::2], -z_a[0::2])

    # End-to-end: the even half of an antithetic crash run bit-matches an
    # iid run of half the count.
    cfg = make_config(retirement_years=3, market_crashes=dict(CRASHES),
                      antithetic=True, seed=12)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(12)
    kw = dict(t_scan=48, retirement_years=3, traj_len=0, dtype=jnp.float64,
              jumps=True)
    anti = simulate_paths(params, jnp.int32(12), key, n_paths=16,
                          antithetic=True, **kw)
    iid = simulate_paths(params, jnp.int32(12), key, n_paths=8, **kw)
    # Round-off tolerance, not bitwise: the draws are bit-identical (above),
    # but XLA contracts the jump's mu + sigma*z into an FMA in one of the
    # two differently-shaped programs and not the other (measured 1-2 ulp
    # on the monthly factors). The base-shock pairing stays bitwise
    # (test_antithetic).
    np.testing.assert_allclose(
        np.asarray(anti.final_balance)[0::2],
        np.asarray(iid.final_balance), rtol=1e-12,
    )


def test_crashes_lower_success_at_fixed_mean():
    """Sanity ordering: compensated crashes keep the mean but fatten the
    left tail, so a withdrawal portfolio's success probability drops."""
    common = dict(
        initial_balance=500_000.0,
        monthly_contribution=0.0,
        monthly_expenses=2_400.0,
        retirement_years=25,
        inv1_returns_mean=0.07,
        inv1_returns_volatility=0.14,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        seed=21,
    )
    plain = Engine(make_config(**common)).run(0, 600)
    crashed = Engine(make_config(
        market_crashes={"frequency_per_year": 0.6, "mean_drop_pct": 30.0,
                        "size_volatility": 0.3, "inv2_beta": 0.3},
        **common,
    )).run(0, 600)
    assert crashed.success_probability < plain.success_probability - 3.0


def test_crash_params_tunable_by_analysis_surfaces():
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
    cfg = make_config(market_crashes=dict(CRASHES), **base)
    rows = sensitivity_fd(
        cfg, working_months=0,
        params=["market_crashes.frequency_per_year",
                "market_crashes.mean_drop_pct"],
        num_paths=64,
    )
    assert {r.param for r in rows} == {
        "market_crashes.frequency_per_year", "market_crashes.mean_drop_pct"
    }
    assert all(np.isfinite(r.d_success) for r in rows)
    with pytest.raises(ValueError, match="unset"):
        sensitivity_fd(
            make_config(**base), working_months=0,
            params=["market_crashes.frequency_per_year"], num_paths=64,
        )
    with pytest.raises(ValueError, match="FD-only"):
        sensitivity_ad(
            cfg, working_months=0,
            params=["market_crashes.frequency_per_year"], num_paths=64,
        )
    res = optimize_params(
        cfg, working_months=0,
        params=["market_crashes.frequency_per_year"],
        bounds=[(0.0, 2.0)],
        points=3, rounds=1, num_paths=64,
    )
    assert 0.0 <= res.best.values[0] <= 2.0


def test_ad_through_jump_kernel_for_smooth_params():
    """AD for NON-crash parameters must still work when crashes are
    compiled in (the jump terms are constants w.r.t. theta)."""
    from monte_carlo_retirement_tpu.engine.sensitivity import sensitivity_ad

    cfg = make_config(
        retirement_years=4, market_crashes=dict(CRASHES),
        num_simulations_main=32,
    )
    out = sensitivity_ad(
        cfg, working_months=6, params=["initial_balance"], num_paths=32
    )
    g = out["d_mean_final"]["initial_balance"]
    assert np.isfinite(g) and g > 0.0

"""Stochastic lifespan (config.longevity — extension, no reference analog;
the reference funds a fixed ``retirement_years`` horizon,
backend/simulation.py:632-640).

Contracts pinned here (the same checklist every opt-in extension carries —
see tests/test_crashes.py / test_guardrails.py):
  * The Gompertz inverse-survival is exact: gompertz_remaining_months
    inverts the conditional survival function in both numeric branches,
    caps at max_age, and returns +inf on sentinel rows (b12 == 0).
  * Closed-form zero-vol lifetimes: with the per-path uniforms recomputed
    host-side, the bequest equals initial − expenses × lived months exactly;
    a path whose money would have run out after death SUCCEEDS ("the money
    outlasted the owner"), one whose owner outlives the money fails with
    the usual YearsToRuin.
  * WR observations exist only for fully-lived years (NaN after death,
    like the reference's post-ruin years).
  * Rule-off is bit-identical: sentinel params under a mortality-on
    executable reproduce the mortality-off run bit for bit (both kernels);
    a mortality-off Pallas executable never reads the mort leaves
    (poisoned-leaf).
  * Both kernels implement the same rule (injected 6-plane draws).
  * Grid guards refuse live-longevity rows under a mortality-off executable.
  * The oracle implements the same arithmetic (randomized f64 differential).
  * The longevity uniform honors antithetic pairing (u -> 1-u, lifespans
    anti-correlate) and is CRN-stable across working-month candidates.
  * Parameters are tunable through the FD sensitivity / optimizer surfaces;
    AD refuses them (dotted path; the lifespan enters via comparisons).
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
    gompertz_remaining_months,
    monthly_jump_draws,
    mortality_uniform,
    stream_keys,
)
from tests.conftest import DETERMINISTIC, base_config_dict, make_config
from tests.oracle import simulate_path_oracle
from tests.test_crashes import CRASHES, _jump_draws_np
from tests.test_pallas_parity import N_PATHS, _drawn_shocks

LONGEVITY = dict(mode_age=86.0, dispersion_years=10.0, max_age=110.0)


def _remaining_months_np(u, cfg, working_months):
    """Host-side replica of the kernel's lifetime math (same two-branch
    form and operation order as ops.shocks.gompertz_remaining_months)."""
    lg = cfg.longevity
    g0 = (lg.mode_age - cfg.current_age) / lg.dispersion_years
    b12 = 12.0 * lg.dispersion_years
    g_ret = g0 - working_months / b12
    log_u = np.log(np.float64(u))
    with np.errstate(over="ignore"):
        t = np.where(
            g_ret > 0,
            g_ret + np.log(np.exp(-g_ret) - log_u),
            np.log1p(-log_u * np.exp(g_ret)),
        )
    t = b12 * t
    cap = max(0.0, (lg.max_age - cfg.current_age) * 12.0 - working_months)
    return np.minimum(t, cap)


def test_longevity_config_validation():
    with pytest.raises(Exception, match="mode_age"):
        Config(**base_config_dict(longevity={"mode_age": 130.0}))
    with pytest.raises(Exception, match="dispersion_years"):
        Config(**base_config_dict(
            longevity={"mode_age": 86.0, "dispersion_years": 0.5}
        ))
    with pytest.raises(Exception, match="max_age.*exceed"):
        Config(**base_config_dict(
            longevity={"mode_age": 90.0, "max_age": 85.0}
        ))
    cfg = make_config(longevity={"mode_age": 86.0})
    assert cfg.longevity.dispersion_years == 10.0  # defaults apply
    assert cfg.longevity.max_age == 120.0


def test_gompertz_inverse_survival_is_exact():
    """The drawn lifetime inverts the conditional Gompertz survival: with
    hazard h(x) = (1/b) e^{(x - mode)/b}, survival of t more years given
    alive at retirement age x is S(t) = exp(-e^{(x-mode)/b} (e^{t/b} - 1));
    the kernel maps u = S(t) back to t (in months). Both numeric branches
    (g_ret > 0: young retiree, huge e^{g_ret}; g_ret < 0) must invert."""
    for mode, age, b, W in [
        (86.0, 40.0, 10.0, 120),   # g_ret > 0 (retires at 50)
        (70.0, 60.0, 8.0, 240),    # g_ret < 0 (retires at 80)
        (120.0, 25.0, 9.0, 0),     # extreme g_ret = 95/9 (e^g overflows f64? no: e^10.5 fine)
    ]:
        b12 = 12.0 * b
        g0 = (mode - age) / b
        cap = 1e9  # not binding here
        for u in (0.999, 0.9, 0.5, 0.1, 1e-3):
            d = float(gompertz_remaining_months(
                jnp.float64(u), g0, b12, cap, W, jnp.float64
            ))
            x_ret = age + W / 12.0
            survival = np.exp(
                -np.exp((x_ret - mode) / b) * np.expm1((d / 12.0) / b)
            )
            assert survival == pytest.approx(u, rel=1e-9), (mode, age, b, W, u)
        # Monotone: longer life for smaller u.
        ds = [
            float(gompertz_remaining_months(
                jnp.float64(u), g0, b12, cap, W, jnp.float64))
            for u in (0.9, 0.5, 0.1)
        ]
        assert ds[0] < ds[1] < ds[2]

    # The max-age cap binds (measured from T=0, minus working months).
    d = float(gompertz_remaining_months(
        jnp.float64(1e-12), 4.6, 120.0, 600.0, 240, jnp.float64
    ))
    assert d == 360.0
    # Retiring past max_age: zero retirement months.
    d = float(gompertz_remaining_months(
        jnp.float64(0.5), 4.6, 120.0, 200.0, 240, jnp.float64
    ))
    assert d == 0.0
    # Sentinel rows (no rule) never expire.
    d = float(gompertz_remaining_months(
        jnp.float64(0.5), 0.0, 0.0, 3.0e7, 240, jnp.float64
    ))
    assert d == np.inf


def _zero_vol_run(initial_balance, n=64, R=10, W=0, alloc=1.0, seed=99):
    cfg = make_config(
        **DETERMINISTIC,
        initial_balance=initial_balance,
        monthly_expenses=2_000.0,
        current_age=60.0,
        retirement_years=R,
        allocation_inv1_pct=alloc,
        longevity=dict(LONGEVITY),
        seed=seed,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(seed)
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=n, t_scan=W + 12 * R,
        retirement_years=R, traj_len=1 + W // 12 + R, dtype=jnp.float64,
        mortality=True,
    )
    u = np.asarray(mortality_uniform(key, n, jnp.float64))
    d = _remaining_months_np(u, cfg, W)
    return cfg, outs, d


def test_zero_vol_bequest_is_exact():
    """Zero growth/inflation/taxes, ample money: the estate at the horizon
    is initial − expenses × lived months, with lived months = ceil(d)
    (months ret_idx < d) capped at the horizon. Spending stops with the
    owner; the estate persists. Lifespans recomputed host-side from the
    kernel's own uniforms."""
    R = 10
    cfg, outs, d = _zero_vol_run(500_000.0, R=R)
    months_paid = np.minimum(12 * R, np.ceil(d))
    expected = 500_000.0 - 2_000.0 * months_paid
    np.testing.assert_allclose(
        np.asarray(outs.final_balance), expected, rtol=1e-12
    )
    # Everyone succeeds: the money always outlasts a <= horizon lifetime.
    assert np.asarray(outs.success).all()
    assert np.isnan(np.asarray(outs.years_to_ruin)).all()
    # The scenario is engineered to include real deaths inside the horizon
    # AND survivors past it (otherwise the assertions above are vacuous).
    assert (d < 12 * R - 1).any() and (d > 12 * R).any()


def test_money_outlasting_owner_is_success():
    """$50k funds exactly 25 months of spending. A path whose owner dies
    by month 25 succeeds with the unspent bequest; one who lives to need a
    26th month fails at the usual first-unfunded-month YearsToRuin."""
    cfg, outs, d = _zero_vol_run(50_000.0, n=256, alloc=1.0)
    success = np.asarray(outs.success)
    final = np.asarray(outs.final_balance)
    ytr = np.asarray(outs.years_to_ruin)
    # 25 payments empty the account (ret_idx 0..24). Owner alive at
    # ret_idx 25 (d > 25) hits ruin check A in that month.
    expect_success = d <= 25.0
    np.testing.assert_array_equal(success, expect_success)
    months_paid = np.minimum(np.ceil(d), 25.0)
    np.testing.assert_allclose(
        final, np.where(expect_success, 50_000.0 - 2_000.0 * months_paid, 0.0),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        ytr[~expect_success], 26.0 / 12.0, rtol=1e-12
    )
    assert np.isnan(ytr[expect_success]).all()
    assert expect_success.any() and (~expect_success).any()


def test_wr_observations_only_for_fully_lived_years():
    """The recorded withdrawal-rate series carries a value exactly for the
    years the owner fully lived (retirement-$ spending / balance at
    retirement), NaN afterwards — the reference's post-ruin NaN pattern
    (backend/simulation.py:851)."""
    R = 10
    cfg = make_config(
        **DETERMINISTIC,
        initial_balance=500_000.0,
        monthly_expenses=2_000.0,
        current_age=60.0,
        retirement_years=R,
        allocation_inv1_pct=0.6,
        longevity=dict(LONGEVITY),
        seed=7,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(7)
    n = 64
    outs = simulate_paths(
        params, jnp.int32(0), key, n_paths=n, t_scan=12 * R,
        retirement_years=R, traj_len=1 + R, dtype=jnp.float64,
        mortality=True,
    )
    u = np.asarray(mortality_uniform(key, n, jnp.float64))
    d = _remaining_months_np(u, cfg, 0)
    wr = np.asarray(outs.withdrawal_rates)  # (n, R)
    years = np.arange(R)
    fully_lived = (years[None, :] * 12 + 11) < d[:, None]
    np.testing.assert_array_equal(~np.isnan(wr), fully_lived)
    np.testing.assert_allclose(
        wr[fully_lived],
        2_000.0 * 12.0 / 500_000.0 * 100.0,
        rtol=1e-12,
    )
    # And the trajectory keeps recording the (frozen, zero-vol) estate.
    traj = np.asarray(outs.trajectory)
    months_paid = np.minimum(12 * R, np.ceil(d))
    np.testing.assert_allclose(
        traj[:, -1], 500_000.0 - 2_000.0 * months_paid, rtol=1e-12
    )


def test_longevity_sentinel_is_bitwise_noop_scan():
    """A longevity-None config run through a mortality-on scan executable
    (sentinel b12 = 0 -> d = +inf) reproduces the mortality-off run BIT for
    bit: the uniform lives in a disjoint fold_in space, so the base shock
    stream never moves."""
    base = dict(retirement_years=4, seed=31, inv1_returns_volatility=0.17)
    cfg = make_config(**base)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    assert float(params.mort_b12) == 0.0
    _, key = stream_keys(31)
    kw = dict(n_paths=64, t_scan=60, retirement_years=4, traj_len=6,
              dtype=jnp.float64)
    off = simulate_paths(params, jnp.int32(12), key, mortality=False, **kw)
    on = simulate_paths(params, jnp.int32(12), key, mortality=True, **kw)
    for field in ("final_balance", "success", "years_to_ruin",
                  "trajectory", "withdrawal_rates"):
        np.testing.assert_array_equal(
            np.asarray(getattr(off, field)), np.asarray(getattr(on, field)),
            err_msg=field,
        )


def test_longevity_sentinel_is_bitwise_noop_pallas():
    """Same pin for the Pallas kernel: a mortality-on executable draws its
    extra uniform from its own disjoint fold_in stream, so sentinel rows
    reproduce the mortality-off executable bit for bit."""
    cfg = make_config(retirement_years=3, seed=88)
    p32 = SimParams.from_config(cfg, dtype=jnp.float32)
    st_off = statics_from_config(cfg)
    assert not st_off.mortality
    kw = dict(
        n_paths=N_PATHS, retirement_years=3,
        n_streams=p32.n_streams, interpret=True,
    )
    off = pallas_simulate(p32, 10, 4, statics=st_off, **kw)
    on = pallas_simulate(
        p32, 10, 4, statics=st_off._replace(mortality=True), **kw
    )
    np.testing.assert_array_equal(np.asarray(off[0]), np.asarray(on[0]))
    np.testing.assert_array_equal(np.asarray(off[1]), np.asarray(on[1]))


def test_longevity_off_pallas_leaves_unread():
    cfg = make_config(retirement_years=2)
    statics = statics_from_config(cfg)
    assert not statics.mortality
    p32 = SimParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(
        n_paths=N_PATHS, retirement_years=2,
        n_streams=p32.n_streams, statics=statics, interpret=True,
    )
    base = pallas_simulate(p32, 6, 5, **kw)
    poisoned = pallas_simulate(
        p32._replace(
            mort_g0=jnp.float32(2.0), mort_b12=jnp.float32(120.0),
            mort_cap=jnp.float32(1.0),
        ), 6, 5, **kw,
    )
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(poisoned[1]))


def test_longevity_pallas_matches_scan_with_injected_draws():
    """Cross-kernel parity on identical draws: 6 injected planes (3 base
    normals + 2 crash draws + the longevity uniform in plane 5 of month 0)
    — crashes are enabled too so the full plane layout is exercised."""
    W, R = 13, 6
    cfg = make_config(
        retirement_years=R,
        seed=606,
        initial_balance=300_000.0,
        monthly_contribution=2_500.0,
        monthly_expenses=2_200.0,
        current_age=58.0,
        inv1_returns_mean=0.07,
        inv1_returns_volatility=0.15,
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.12,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        market_crashes=dict(CRASHES),
        # Tight lifespans so deaths actually occur inside 6 years.
        longevity=dict(mode_age=60.0, dispersion_years=4.0, max_age=90.0),
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    assert statics.mortality and statics.jumps
    _, key = stream_keys(606)
    T = W + 12 * R
    base = _drawn_shocks(key, T, N_PATHS)  # (T, 3, n)
    jd = _jump_draws_np(key, T, N_PATHS, jnp.float32)  # (T, n, 2)
    jplanes = jnp.transpose(jnp.asarray(jd, jnp.float32), (0, 2, 1))
    u_mort = np.asarray(mortality_uniform(key, N_PATHS, jnp.float32))
    mplane = np.zeros((T, 1, N_PATHS), np.float32)
    mplane[0, 0] = u_mort
    shocks = jnp.concatenate(
        [base, jplanes, jnp.asarray(mplane)], axis=1
    )  # (T, 6, n)
    succ_p, final_p = pallas_simulate(
        params, W, 0,
        n_paths=N_PATHS, retirement_years=R,
        n_streams=params.n_streams, statics=statics,
        shocks=shocks, with_shocks=True, interpret=True,
    )
    outs = simulate_paths(
        params, jnp.int32(W), key, n_paths=N_PATHS, t_scan=T,
        retirement_years=R, traj_len=0, dtype=jnp.float32, jumps=True,
        mortality=True,
    )
    succ_s = np.asarray(outs.success)
    # The rule must bind for the comparison to mean anything.
    assert 0.05 < succ_s.mean() < 1.0
    np.testing.assert_array_equal(
        np.asarray(succ_p)[:N_PATHS] > 0.5, succ_s
    )
    final_s = np.asarray(outs.final_balance)
    diff = np.abs(np.asarray(final_p)[:N_PATHS] - final_s)
    rel = diff / np.maximum(np.abs(final_s), 1.0)
    bad = (rel > 5e-3) & (diff > 5.0)
    assert not bad.any(), f"max rel {rel.max():.2e}, max abs {diff.max():.2f}"


def test_grid_guards_reject_mismatched_longevity():
    cfg_l = make_config(longevity=dict(LONGEVITY))
    cfg_n = make_config()
    with pytest.raises(ValueError, match="[Ss]tatics"):
        grid_statics([cfg_l, cfg_n])
    assert grid_statics([cfg_l, cfg_l]).mortality
    batch = stack_params([cfg_l, cfg_l], dtype=jnp.float32)
    with pytest.raises(ValueError, match="[Ss]tatics"):
        _check_grid_statics(batch, statics_from_config(cfg_n))


def test_longevity_uniform_antithetic_and_crn():
    _, key = stream_keys(5)
    u_a = np.asarray(mortality_uniform(key, 8, jnp.float64, antithetic=True))
    u_i = np.asarray(mortality_uniform(key, 4, jnp.float64))
    # Even paths bit-match the iid half run; odd paths mirror their pair.
    np.testing.assert_array_equal(u_a[0::2], u_i)
    np.testing.assert_array_equal(u_a[1::2], 1.0 - u_a[0::2])

    # CRN: the uniform does not depend on the working-month candidate — a
    # later retirement re-conditions the SAME percentile on the later age
    # (d shrinks monotonically as W grows, at fixed u).
    cfg = make_config(longevity=dict(LONGEVITY), current_age=50.0)
    u = np.asarray(mortality_uniform(key, 16, jnp.float64))
    d0 = _remaining_months_np(u, cfg, 0)
    d120 = _remaining_months_np(u, cfg, 120)
    assert (d120 < d0).all()

    # End-to-end: the even half of an antithetic mortality run bit-matches
    # an iid run of half the count (pairing composes across the base and
    # longevity streams).
    cfg = make_config(
        retirement_years=3, longevity=dict(LONGEVITY), antithetic=True,
        current_age=80.0, seed=13,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, key = stream_keys(13)
    kw = dict(t_scan=42, retirement_years=3, traj_len=0, dtype=jnp.float64,
              mortality=True)
    anti = simulate_paths(params, jnp.int32(6), key, n_paths=16,
                          antithetic=True, **kw)
    iid = simulate_paths(params, jnp.int32(6), key, n_paths=8, **kw)
    np.testing.assert_array_equal(
        np.asarray(anti.final_balance)[0::2], np.asarray(iid.final_balance)
    )


@pytest.mark.parametrize("case", range(4))
def test_engine_matches_oracle_with_random_longevity(case):
    rng = np.random.default_rng(9700 + case)
    current_age = float(rng.uniform(45, 70))
    cfg = make_config(
        initial_balance=float(rng.uniform(50_000, 400_000)),
        monthly_contribution=float(rng.uniform(0, 3000)),
        monthly_expenses=float(rng.uniform(800, 4000)),
        current_age=current_age,
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
        # Tight lifespans relative to the (short) horizon so deaths occur.
        longevity={
            "mode_age": float(current_age + rng.uniform(-5.0, 8.0)),
            "dispersion_years": float(rng.uniform(2.0, 12.0)),
            "max_age": float(current_age + rng.uniform(10.0, 40.0)),
        },
        other_income_streams=(
            [] if rng.random() < 0.5 else [{
                "name": "pension",
                "monthly_amount_today": float(rng.uniform(100, 2000)),
                "start_at_age": float(rng.uniform(45, 70)),
                "duration_years": None,
                "inflation_indexed": bool(rng.random() < 0.5),
                "tax_rate": float(rng.uniform(0, 0.3)),
            }]
        ),
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
        retirement_years=R, traj_len=0, dtype=jnp.float64, mortality=True,
    )
    shocks = np.stack(
        [
            np.asarray(jax.random.normal(
                jax.random.fold_in(key, m), (n, 3), dtype=jnp.float64))
            for m in range(1, T + 1)
        ]
    )
    u = np.asarray(mortality_uniform(key, n, jnp.float64))
    succ = np.asarray(outs.success)
    final = np.asarray(outs.final_balance)
    deaths = (_remaining_months_np(u, cfg, W) < 12 * R).sum()
    for p in range(n):
        expected = simulate_path_oracle(
            cfg, W, shocks[:, p, :], mort_u=float(u[p])
        )
        assert bool(succ[p]) == expected["success"], f"case {case} path {p}"
        assert final[p] == pytest.approx(
            expected["final_balance"], rel=1e-8, abs=1e-6
        ), f"case {case} path {p}"
    assert deaths > 0  # the rule must have fired somewhere in the batch


def test_longevity_raises_success_probability():
    """Sanity ordering: ruin can only strike while the owner is alive, so
    adding mortality to a marginally-funded plan raises success (paths that
    would have failed late now end as bequests)."""
    common = dict(
        initial_balance=500_000.0,
        monthly_contribution=0.0,
        monthly_expenses=2_900.0,
        current_age=60.0,
        retirement_years=35,
        inv1_returns_mean=0.06,
        inv1_returns_volatility=0.15,
        inflation_rate_mean=0.03,
        inflation_rate_volatility=0.012,
        seed=23,
    )
    plain = Engine(make_config(**common)).run(0, 600)
    mortal = Engine(make_config(longevity=dict(LONGEVITY), **common)).run(0, 600)
    assert mortal.success_probability > plain.success_probability + 3.0


def test_longevity_params_tunable_by_analysis_surfaces():
    from monte_carlo_retirement_tpu.engine.optimize import optimize_params
    from monte_carlo_retirement_tpu.engine.sensitivity import (
        SENSITIVITY_PARAMS,
        sensitivity_ad,
        sensitivity_fd,
    )

    for name in ("longevity.mode_age", "longevity.dispersion_years",
                 "longevity.max_age"):
        assert name in SENSITIVITY_PARAMS  # /api/analysis/meta rows

    base = dict(
        retirement_years=8,
        initial_balance=220_000.0,
        monthly_expenses=2_400.0,
        current_age=62.0,
        inv1_returns_volatility=0.16,
        num_simulations_main=64,
    )
    cfg = make_config(
        longevity=dict(mode_age=68.0, dispersion_years=6.0, max_age=100.0),
        **base,
    )
    rows = sensitivity_fd(
        cfg, working_months=0,
        params=["longevity.mode_age", "longevity.dispersion_years"],
        num_paths=64,
    )
    assert {r.param for r in rows} == {
        "longevity.mode_age", "longevity.dispersion_years"
    }
    assert all(np.isfinite(r.d_success) for r in rows)
    with pytest.raises(ValueError, match="unset"):
        sensitivity_fd(
            make_config(**base), working_months=0,
            params=["longevity.mode_age"], num_paths=64,
        )
    with pytest.raises(ValueError, match="FD-only"):
        sensitivity_ad(
            cfg, working_months=0, params=["longevity.mode_age"],
            num_paths=64,
        )
    # Optimizer: default bounds intersect the sibling (mode < max).
    res = optimize_params(
        cfg, working_months=0, params=["longevity.mode_age"],
        bounds=[(60.0, 90.0)], points=3, rounds=1, num_paths=64,
    )
    assert 60.0 <= res.best.values[0] <= 90.0


def test_longevity_search_and_scenario_batch():
    """The working-months search runs on a longevity config (CRN keeps the
    curve usable), and a scenario batch of longevity variants matches the
    single-engine runs bit for bit (grid-wide CRN)."""
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        run_scenario_batch,
    )
    from monte_carlo_retirement_tpu.engine.simulator import (
        RetirementMonteCarloSimulator,
    )

    cfg = make_config(
        initial_balance=250_000.0,
        monthly_contribution=1_500.0,
        monthly_expenses=2_500.0,
        current_age=55.0,
        retirement_years=12,
        longevity=dict(LONGEVITY),
        num_simulations_search=64,
        num_simulations_main=64,
        target_probability=85.0,
        seed=6,
    )
    sim = RetirementMonteCarloSimulator(cfg)
    months, prob, curve = sim.find_minimum_working_months(verbose=False)
    assert months >= 0 and prob >= 85.0 and len(curve) > 1

    variants = [
        cfg,
        cfg.model_copy(update={"monthly_expenses": 2_800.0}, deep=True),
    ]
    stats = run_scenario_batch(variants, [60, 60], 64, seed=6)
    for i, v in enumerate(variants):
        # float32 to match the batch (RNG draw values depend on dtype).
        single = Engine(v, main_seed_override=6, dtype=jnp.float32).run(60, 64)
        assert stats.success_probability[i] == pytest.approx(
            single.success_probability, abs=1e-9
        )

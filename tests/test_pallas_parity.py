"""Pallas kernel logic parity vs the XLA scan kernel (interpret mode, CPU).

The kernel re-implements the scan's month loop with each path's state held
in registers. Injecting the exact same shock draws into both must reproduce
identical path outcomes (success flags) and near-identical balances (float32
reassociation only); the kernel's own in-kernel draws are the scan's stream,
so the same holds without injection.
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
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import stream_keys
from tests.conftest import make_config


# Paths per injected-shock comparison: enough for the mismatch bounds below
# to mean something, several kernel blocks.
N_PATHS = 4096


def _drawn_shocks(key, months, n_paths):
    """The scan's base draws as kernel shock planes: (months, 3, n_paths)."""
    z = jnp.stack(
        [
            jax.random.normal(
                jax.random.fold_in(key, m), (n_paths, 3), dtype=jnp.float32
            )
            for m in range(1, months + 1)
        ]
    )
    return jnp.transpose(z, (0, 2, 1))


@pytest.mark.parametrize(
    "working_months,overrides",
    [
        # Survivable two-stream scenario with realized-gains taxes.
        (
            235,
            dict(
                initial_balance=240_000.0,
                monthly_contribution=5_000.0,
                contribution_growth_rate_annual=0.04,
                monthly_expenses=10_000.0,
                inv1_returns_mean=0.12,
                inv1_returns_volatility=0.02,
                inv1_use_realized_gains_tax_system=True,
                inv1_realized_gains_tax_rate=0.10,
                inv2_premium_over_inflation_mean=0.05,
                inv2_premium_over_inflation_volatility=0.02,
                inv2_use_realized_gains_tax_system=True,
                inv2_realized_gains_tax_rate=0.10,
                inflation_rate_mean=0.062,
                inflation_rate_volatility=0.0235,
                other_income_streams=[
                    {
                        "name": "Pension",
                        "monthly_amount_today": 4000.0,
                        "start_at_age": 65.0,
                        "duration_years": None,
                        "inflation_indexed": True,
                        "tax_rate": 0.275,
                    },
                    {
                        "name": "Annuity",
                        "monthly_amount_today": 500.0,
                        "start_at_age": 60.0,
                        "duration_years": 10,
                        "inflation_indexed": False,
                        "tax_rate": 0.2,
                    },
                ],
            ),
        ),
        # Mixed outcome: annual mark-to-market taxes, partial working year.
        (
            13,
            dict(
                initial_balance=150_000.0,
                monthly_contribution=1_000.0,
                monthly_expenses=1_200.0,
                inv1_annual_tax_on_gains_rate=0.25,
                inv1_use_realized_gains_tax_system=False,
                inv2_use_realized_gains_tax_system=False,
                inv2_annual_tax_on_gains_rate=0.10,
            ),
        ),
    ],
)
def test_pallas_matches_scan_with_injected_shocks(working_months, overrides):
    cfg = make_config(retirement_years=5, seed=2026, **overrides)
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    _, key = stream_keys(2026)
    R = 5
    T = working_months + 12 * R

    shocks = _drawn_shocks(key, T, N_PATHS)
    succ_p, final_p = pallas_simulate(
        params,
        working_months,
        0,
        n_paths=N_PATHS,
        retirement_years=R,
        n_streams=params.n_streams,
        statics=statics_from_config(cfg),
        shocks=shocks,
        with_shocks=True,
        interpret=True,
    )
    outs = simulate_paths(
        params,
        jnp.int32(working_months),
        key,
        n_paths=N_PATHS,
        t_scan=T,
        retirement_years=R,
        traj_len=0,
        dtype=jnp.float32,
    )

    succ_s = np.asarray(outs.success)
    succ_p = np.asarray(succ_p) > 0.5
    mismatch = float((succ_p != succ_s).mean())
    assert mismatch < 3e-3, f"success mismatch {mismatch*100:.3f}%"

    final_s = np.asarray(outs.final_balance)
    final_p = np.asarray(final_p)
    rel = np.abs(final_p - final_s) / np.maximum(np.abs(final_s), 1.0)
    assert float(rel.max()) < 5e-3, f"final-balance rel err {rel.max():.2e}"


@pytest.mark.parametrize("working_months", [0, 13, 24])
def test_pallas_full_mode_matches_scan(working_months):
    """Full-statistics Pallas mode reproduces every tracked output of the
    scan kernel under injected shocks."""
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_simulate_full,
    )
    from monte_carlo_retirement_tpu.timing import expected_trajectory_length

    cfg = make_config(
        retirement_years=4,
        seed=17,
        initial_balance=120_000.0,
        monthly_contribution=1_500.0,
        monthly_expenses=2_200.0,
        inv1_annual_tax_on_gains_rate=0.2,
        inv1_use_realized_gains_tax_system=False,
        inv2_use_realized_gains_tax_system=True,
        inv2_realized_gains_tax_rate=0.15,
        other_income_streams=[
            {
                "name": "P",
                "monthly_amount_today": 900.0,
                "start_at_age": 41.0,
                "duration_years": 2,
                "inflation_indexed": False,
                "tax_rate": 0.1,
            }
        ],
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    _, key = stream_keys(17)
    R = 4
    T = working_months + 12 * R
    N = N_PATHS
    L = expected_trajectory_length(working_months, R)
    shocks = _drawn_shocks(key, T, N)

    full = pallas_simulate_full(
        params, working_months, 0,
        n_paths=N, retirement_years=R, n_streams=1,
        statics=statics_from_config(cfg), traj_len=L,
        shocks=shocks, with_shocks=True, interpret=True,
    )
    outs = simulate_paths(
        params, jnp.int32(working_months), key,
        n_paths=N, t_scan=T, retirement_years=R, traj_len=L,
        dtype=jnp.float32,
    )

    assert (
        (np.asarray(full["success"]) > 0.5) == np.asarray(outs.success)
    ).mean() > 0.999
    for name, scan_val in [
        ("final_balance", outs.final_balance),
        ("start_balance", outs.start_balance),
        ("first_year_gross", outs.first_year_gross),
        ("first_year_real_gross", outs.first_year_real_gross),
        ("inflation_at_retirement", outs.inflation_at_retirement),
    ]:
        a = np.asarray(full[name])
        b = np.asarray(scan_val)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        assert float(np.quantile(rel, 0.999)) < 5e-3, f"{name}: {rel.max():.2e}"

    ytr_p = np.asarray(full["years_to_ruin"])
    ytr_s = np.asarray(outs.years_to_ruin)
    same_nan = np.isnan(ytr_p) == np.isnan(ytr_s)
    assert same_nan.mean() > 0.999
    both = same_nan & ~np.isnan(ytr_s)
    np.testing.assert_allclose(ytr_p[both], ytr_s[both], atol=1e-5)

    traj_p = np.asarray(full["trajectory"])[:, :L]
    traj_s = np.asarray(outs.trajectory)
    rel = np.abs(traj_p - traj_s) / np.maximum(np.abs(traj_s), 1.0)
    assert float(np.quantile(rel, 0.999)) < 5e-3

    wr_p = np.asarray(full["withdrawal_rates"])
    wr_s = np.asarray(outs.withdrawal_rates)
    assert (np.isnan(wr_p) == np.isnan(wr_s)).mean() > 0.999
    ok = ~np.isnan(wr_s) & ~np.isnan(wr_p)
    np.testing.assert_allclose(wr_p[ok], wr_s[ok], rtol=5e-3, atol=1e-4)


def test_pallas_fuzz_differential_statics_combos():
    """Randomized Pallas-vs-scan differential sweeping the kernel's static
    specialization axes: tax system per asset, annual-bill existence,
    stream indexing/capping, partial working years. Same injected shocks
    into both kernels; outcomes must agree per path."""
    rng = np.random.default_rng(99)
    for case in range(4):
        n_streams = int(rng.integers(0, 3))
        streams = []
        for s in range(n_streams):
            streams.append(
                {
                    "name": f"s{s}",
                    "monthly_amount_today": float(rng.uniform(300, 2500)),
                    "start_at_age": float(rng.uniform(40, 52)),
                    "duration_years": (
                        None if rng.random() < 0.5 else int(rng.integers(1, 6))
                    ),
                    "inflation_indexed": bool(rng.random() < 0.5),
                    "tax_rate": float(rng.uniform(0, 0.4)),
                }
            )
        use1 = bool(rng.random() < 0.5)
        use2 = bool(rng.random() < 0.5)
        W = int(rng.integers(0, 30))
        R = int(rng.integers(1, 5))
        cfg = make_config(
            retirement_years=R,
            seed=int(rng.integers(0, 10_000)),
            initial_balance=float(rng.uniform(20_000, 250_000)),
            monthly_contribution=float(rng.uniform(0, 4_000)),
            monthly_expenses=float(rng.uniform(800, 4_000)),
            # Glide is a statics axis too: half the cases exercise it.
            allocation_inv1_final_pct=(
                None if rng.random() < 0.5 else float(rng.uniform(0, 1))
            ),
            current_age=45.0,
            inv1_returns_volatility=float(rng.uniform(0.05, 0.25)),
            inv1_use_realized_gains_tax_system=use1,
            inv1_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
            inv1_annual_tax_on_gains_rate=float(rng.uniform(0, 0.3)),
            inv2_use_realized_gains_tax_system=use2,
            inv2_realized_gains_tax_rate=float(rng.uniform(0, 0.3)),
            inv2_annual_tax_on_gains_rate=float(rng.uniform(0, 0.3)),
            inflation_rate_volatility=float(rng.uniform(0, 0.03)),
            equity_inflation_correlation=float(rng.uniform(-0.9, 0.9)),
            other_income_streams=streams,
        )
        params = SimParams.from_config(cfg, dtype=jnp.float32)
        _, key = stream_keys(cfg.seed)
        T = W + 12 * R
        shocks = _drawn_shocks(key, T, N_PATHS)
        succ_p, final_p = pallas_simulate(
            params,
            W,
            0,
            n_paths=N_PATHS,
            retirement_years=R,
            n_streams=params.n_streams,
            statics=statics_from_config(cfg),
            shocks=shocks,
            with_shocks=True,
            interpret=True,
        )
        outs = simulate_paths(
            params,
            jnp.int32(W),
            key,
            n_paths=N_PATHS,
            t_scan=T,
            retirement_years=R,
            traj_len=0,
            dtype=jnp.float32,
        )
        succ_s = np.asarray(outs.success)
        succ_pb = np.asarray(succ_p) > 0.5
        mismatch = float((succ_pb != succ_s).mean())
        assert mismatch < 3e-3, f"case {case}: success mismatch {mismatch:.4f}"
        final_s = np.asarray(outs.final_balance)
        diff = np.abs(np.asarray(final_p) - final_s)
        rel = diff / np.maximum(np.abs(final_s), 1.0)
        # Dust-aware, and deliberately WEAKER than the old q999-of-rel check
        # on sub-$5 residual balances: knife-edge scenarios (annual tax
        # bills near capacity) leave a few paths with <$5 finals where f32
        # reassociation reads as percents — scan f32 vs f64 diverges by far
        # more there, so relative error on dust carries no signal. Both the
        # old and this check allow 0.1% of paths above the relative bound;
        # a path only counts as divergent when it is BOTH relatively and
        # absolutely off.
        bad = (rel > 5e-3) & (diff > 5.0)
        assert float(bad.mean()) <= 1e-3, (
            f"case {case}: {bad.sum()} paths diverge "
            f"(max rel {rel.max():.2e}, max abs {diff.max():.2f})"
        )


def test_pallas_sharded_matches_single_device_exactly():
    """The shard_map'd Pallas entry points key their draws by GLOBAL path, so
    an 8-device run must reproduce the single-device run that uses the same
    global block count bit-for-bit (interpret mode, CPU mesh)."""
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        BLOCK_PATHS as BP,
        pallas_probe,
        pallas_probe_sharded,
        pallas_simulate,
        pallas_simulate_sharded,
    )
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 8  # conftest forces 8 virtual CPU devices
    # Two blocks per device: XLA:CPU specialises a one-step interpret grid,
    # which can move float32 results by an ulp; the card runs one program.
    n_paths = 2 * n_dev * BP

    cfg = make_config(
        retirement_years=2,
        seed=7,
        initial_balance=150_000.0,
        monthly_contribution=2_000.0,
        monthly_expenses=2_500.0,
        inv1_returns_volatility=0.15,
    )
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        statics_from_config,
    )

    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    months = jnp.asarray([1, 13], jnp.int32)

    p_single = pallas_probe(
        params, months, 7, n_candidates=2, n_paths=n_paths,
        retirement_years=2, n_streams=0, statics=statics, interpret=True,
    )
    p_sharded = pallas_probe_sharded(
        params, months, 7, mesh=mesh, n_candidates=2, n_paths=n_paths,
        retirement_years=2, n_streams=0, statics=statics, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(p_sharded), np.asarray(p_single), rtol=0, atol=1e-5
    )

    s_single, f_single = pallas_simulate(
        params, 13, 7, n_paths=n_paths, retirement_years=2, n_streams=0,
        statics=statics, interpret=True,
    )
    s_sharded, f_sharded = pallas_simulate_sharded(
        params, 13, 7, mesh=mesh, n_paths=n_paths, retirement_years=2,
        n_streams=0, statics=statics, interpret=True,
    )
    assert len(f_sharded.sharding.device_set) == n_dev
    np.testing.assert_array_equal(np.asarray(s_sharded), np.asarray(s_single))
    np.testing.assert_array_equal(np.asarray(f_sharded), np.asarray(f_single))


def test_pallas_candidate_axis_preserves_crn():
    """A candidate's probability must not depend on which other candidates
    share the batch (common random numbers are structural: the candidate
    grid axis never enters the draws' keys)."""
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        BLOCK_PATHS as BP,
        pallas_probe,
    )
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        statics_from_config,
    )

    cfg = make_config(
        retirement_years=2,
        seed=21,
        initial_balance=90_000.0,
        monthly_expenses=2_400.0,
        inv1_returns_volatility=0.18,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)

    def probe(months):
        return np.asarray(
            pallas_probe(
                params, jnp.asarray(months, jnp.int32), 21,
                n_candidates=len(months), n_paths=BP, retirement_years=2,
                n_streams=0, statics=statics, interpret=True,
            )
        )

    a = probe([6, 18])
    b = probe([6, 30])
    c = probe([12, 18])
    assert a[0] == b[0]      # month 6 unaffected by its batch partner
    assert a[1] == c[1]      # month 18 likewise


def test_pallas_full_sharded_matches_single_device_exactly():
    """Sharded full-statistics mode reproduces the single-device run
    bit-for-bit across every output (interpret mode, CPU mesh)."""
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_simulate_full,
        pallas_simulate_full_sharded,
        statics_from_config,
    )
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh
    from monte_carlo_retirement_tpu.timing import expected_trajectory_length

    mesh = make_mesh()
    n_dev = len(jax.devices())
    n_paths = 2 * n_dev * BLOCK_PATHS  # two blocks per device, see above

    cfg = make_config(
        retirement_years=2,
        seed=9,
        initial_balance=120_000.0,
        monthly_contribution=1_500.0,
        monthly_expenses=2_800.0,
        inv1_returns_volatility=0.17,
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    L = expected_trajectory_length(13, 2)

    single = pallas_simulate_full(
        params, 13, 9, n_paths=n_paths, retirement_years=2, n_streams=0,
        statics=statics, traj_len=L, interpret=True,
    )
    sharded = pallas_simulate_full_sharded(
        params, 13, 9, mesh=mesh, n_paths=n_paths, retirement_years=2,
        n_streams=0, statics=statics, traj_len=L, interpret=True,
    )
    assert len(sharded["final_balance"].sharding.device_set) == n_dev
    for name in single:
        np.testing.assert_array_equal(
            np.asarray(sharded[name]), np.asarray(single[name]), err_msg=name
        )


_CRASHES = dict(
    frequency_per_year=1.0, mean_drop_pct=25.0, size_volatility=0.3,
    inv2_beta=0.5,
)


@pytest.mark.parametrize(
    "working_months,overrides,scan_flags",
    [
        # Plain iid draws, realized-gains taxes.
        (13, dict(monthly_expenses=3_600.0,
                  inv1_use_realized_gains_tax_system=True,
                  inv1_realized_gains_tax_rate=0.15), {}),
        # Antithetic pairs + crash draws + the longevity uniform: every
        # stream of ops/shocks.py, paired at path level.
        (7, dict(antithetic=True, market_crashes=_CRASHES,
                 longevity=dict(mode_age=45.0, dispersion_years=4.0,
                                max_age=90.0)),
         dict(antithetic=True, jumps=True, mortality=True)),
        # Annual bills, guardrails and a glide path with a capped stream.
        (25, dict(monthly_expenses=4_800.0,
                  inv1_annual_tax_on_gains_rate=0.2,
                  allocation_inv1_final_pct=0.3,
                  spending_guardrails=dict(upper_wr_pct=5.0,
                                           lower_wr_pct=3.0,
                                           adjustment_pct=10.0),
                  other_income_streams=[{
                      "name": "P", "monthly_amount_today": 600.0,
                      "start_at_age": 42.0, "duration_years": 2,
                      "inflation_indexed": False, "tax_rate": 0.1}]), {}),
    ],
)
def test_in_kernel_draws_match_scan_per_path(working_months, overrides,
                                             scan_flags):
    """Without injection the kernel draws the scan's own threefry stream
    (keyed by global path, month and draw), so the two kernels simulate the
    same paths: success flags agree and balances differ only by float32
    rounding."""
    cfg = make_config(
        **{**dict(retirement_years=3, seed=31, initial_balance=120_000.0,
                  monthly_contribution=1_000.0, monthly_expenses=1_600.0,
                  inv1_returns_volatility=0.2), **overrides},
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    _, key = stream_keys(31)
    n = 3 * BLOCK_PATHS + 17  # ragged: the last block is padding-heavy
    succ_p, final_p = pallas_simulate(
        params, working_months, key, n_paths=n, retirement_years=3,
        n_streams=params.n_streams, statics=statics_from_config(cfg),
        interpret=True,
    )
    outs = simulate_paths(
        params, jnp.int32(working_months), key, n_paths=n,
        t_scan=working_months + 36, retirement_years=3, traj_len=0,
        dtype=jnp.float32, **scan_flags,
    )
    succ_s = np.asarray(outs.success)
    assert 0.05 < succ_s.mean() < 1.0  # mixed outcomes: the rules bind
    np.testing.assert_array_equal(np.asarray(succ_p)[:n] > 0.5, succ_s)
    final_s = np.asarray(outs.final_balance)
    diff = np.abs(np.asarray(final_p)[:n] - final_s)
    # A path that nearly ran out and recovered carries a cancellation-
    # amplified rounding error, so each difference is measured against the
    # larger of its own balance and the median surviving balance.
    scale = np.maximum(np.abs(final_s), np.median(final_s[succ_s]))
    rel = diff / scale
    assert float(rel.max()) < 1e-4, f"max rel {rel.max():.2e}"


@pytest.mark.gpu
def test_compiled_kernel_matches_scan_on_the_card(gpu):
    """On a GPU: the kernel as compiled for the card (no interpret mode)
    against the f32 scan on the same card, per path, on a ruin-heavy
    scenario with every extension on. chip_smoke.py repeats this at 1M
    paths."""
    cfg = make_config(
        retirement_years=30, seed=5, initial_balance=400_000.0,
        monthly_contribution=2_000.0, monthly_expenses=3_000.0,
        inv1_returns_volatility=0.15, antithetic=True,
        allocation_inv1_final_pct=0.4, market_crashes=_CRASHES,
        longevity=dict(mode_age=88.0, dispersion_years=9.0),
        spending_guardrails=dict(upper_wr_pct=6.0, lower_wr_pct=3.0),
    )
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    _, key = stream_keys(5)
    n, w = 65_536, 120
    succ_p, final_p = pallas_simulate(
        params, w, key, n_paths=n, retirement_years=30,
        n_streams=params.n_streams, statics=statics,
    )
    outs = simulate_paths(
        params, jnp.int32(w), key, n_paths=n, t_scan=w + 360,
        retirement_years=30, traj_len=0, dtype=jnp.float32,
        antithetic=True, jumps=True, mortality=True,
    )
    succ_s = np.asarray(outs.success)
    succ_k = np.asarray(succ_p)[:n] > 0.5
    assert 0.05 < succ_s.mean() < 1.0
    assert (succ_k != succ_s).mean() <= 1e-4
    final_s = np.asarray(outs.final_balance)
    both = succ_k & succ_s
    scale = np.maximum(np.abs(final_s), np.median(final_s[both]))
    rel = (np.abs(np.asarray(final_p)[:n] - final_s) / scale)[both]
    assert (rel > 1e-4).mean() <= 1e-3, f"max rel {rel.max():.2e}"

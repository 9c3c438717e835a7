"""Scenario-grid batching: stacked configs in one compiled dispatch."""

import numpy as np
import pytest

from monte_carlo_retirement_tpu.engine.runner import Engine
from monte_carlo_retirement_tpu.engine.scenario_batch import (
    run_scenario_batch,
    stack_params,
)
from tests.conftest import make_config


def test_scenario_batch_matches_individual_runs():
    """Batched scenarios reproduce single-engine probe results exactly
    (same stream seed => same shocks => identical success rates)."""
    variants = [
        make_config(seed=0, monthly_expenses=2_000.0, retirement_years=8),
        make_config(seed=0, monthly_expenses=4_000.0, retirement_years=8),
        make_config(seed=0, monthly_expenses=8_000.0, retirement_years=8),
    ]
    months = [24, 24, 24]
    batch = run_scenario_batch(variants, months, num_simulations=64, seed=0)
    assert batch.success_probability.shape == (3,)
    # Higher expenses can never raise success under shared shocks.
    assert batch.success_probability[0] >= batch.success_probability[1]
    assert batch.success_probability[1] >= batch.success_probability[2]

    import jax.numpy as jnp

    for cfg, w, expected in zip(variants, months, batch.success_probability):
        # float32 to match the batch (the RNG draw values depend on dtype).
        eng = Engine(cfg, main_seed_override=0, dtype=jnp.float32)
        probs = eng.probe([w], 64, stream="final", horizon_months=w)
        assert probs[0] == pytest.approx(float(expected), abs=1e-6)


def test_scenario_batch_validates_structure():
    a = make_config(retirement_years=5)
    b = make_config(retirement_years=6)
    with pytest.raises(ValueError):
        stack_params([a, b])
    c = make_config(
        retirement_years=5,
        other_income_streams=[
            {
                "name": "P",
                "monthly_amount_today": 100.0,
                "start_at_age": 60.0,
                "duration_years": None,
                "inflation_indexed": True,
                "tax_rate": 0.0,
            }
        ],
    )
    with pytest.raises(ValueError):
        stack_params([a, c])
    with pytest.raises(ValueError):
        run_scenario_batch([a], [1, 2], 16)


def test_stack_params_validates_pruned_stream_counts():
    """A zero-amount 'padding' stream is pruned before stacking, so a batch
    that only matches on RAW stream counts must be rejected with a clear
    message, not die inside jnp.stack with a shape error."""
    real = make_config(
        retirement_years=5,
        other_income_streams=[
            {
                "name": "P",
                "monthly_amount_today": 100.0,
                "start_at_age": 60.0,
                "duration_years": None,
                "inflation_indexed": True,
                "tax_rate": 0.0,
            }
        ],
    )
    padded = make_config(
        retirement_years=5,
        other_income_streams=[
            {
                "name": "pad",
                "monthly_amount_today": 0.0,
                "start_at_age": 60.0,
                "duration_years": None,
                "inflation_indexed": True,
                "tax_rate": 0.0,
            }
        ],
    )
    with pytest.raises(ValueError, match="effective income"):
        stack_params([real, padded])


def test_mixed_stream_structure_rejected_by_pallas_grid():
    """The kernel branches on the STATIC stream flags (indexed/capped), not
    the per-row data, so a batch whose rows disagree on stream structure
    must be rejected before dispatch — a mismatched row would silently
    simulate a frozen-nominal pension as CPI-indexed."""
    import jax.numpy as jnp

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_scenario_grid,
        statics_from_config,
    )

    def cfg_with(indexed):
        return make_config(
            retirement_years=2,
            other_income_streams=[
                {
                    "name": "P",
                    "monthly_amount_today": 500.0,
                    "start_at_age": 60.0,
                    "duration_years": None,
                    "inflation_indexed": indexed,
                    "tax_rate": 0.0,
                }
            ],
        )

    indexed, nominal = cfg_with(True), cfg_with(False)
    batch = stack_params([indexed, nominal], dtype=jnp.float32)
    with pytest.raises(ValueError, match="stream structure"):
        pallas_scenario_grid(
            batch, jnp.asarray([12, 12], jnp.int32), 0,
            n_scenarios=2, n_paths=4096, retirement_years=2, n_streams=1,
            statics=statics_from_config(indexed), interpret=True,
        )


def test_grid_entry_points_validate_months_row_count():
    """pallas_probe / pallas_scenario_grid grids index a months row per grid
    step; a short months vector must be rejected, not silently clamp or read
    out of bounds."""
    import jax.numpy as jnp

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_probe,
        pallas_scenario_grid,
        statics_from_config,
    )
    from monte_carlo_retirement_tpu.models.retirement import SimParams

    cfg = make_config(retirement_years=2)
    params = SimParams.from_config(cfg, dtype=jnp.float32)
    statics = statics_from_config(cfg)
    with pytest.raises(ValueError, match="candidate rows"):
        pallas_probe(
            params, jnp.asarray([12], jnp.int32), 0,
            n_candidates=4, n_paths=4096, retirement_years=2, n_streams=0,
            statics=statics, interpret=True,
        )
    batch = stack_params([cfg, cfg, cfg, cfg], dtype=jnp.float32)
    with pytest.raises(ValueError, match="months rows"):
        pallas_scenario_grid(
            batch, jnp.asarray([12], jnp.int32), 0,
            n_scenarios=4, n_paths=4096, retirement_years=2, n_streams=0,
            statics=statics, interpret=True,
        )


def test_pallas_scenario_grid_sharded_matches_single_device():
    """8-shard scenario grid reproduces the 1-device grid bit-for-bit
    (draws keyed by global path; interpret mode on the CPU mesh)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        BLOCK_PATHS,
        pallas_scenario_grid,
        pallas_scenario_grid_sharded,
        statics_from_config,
    )
    from monte_carlo_retirement_tpu.engine.scenario_batch import stack_params
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh
    from tests.conftest import make_config

    n_dev = len(jax.devices())
    mesh = make_mesh()
    cfgs = [
        make_config(monthly_expenses=e, retirement_years=2, seed=3)
        for e in (1_000.0, 3_000.0, 9_000.0)
    ]
    batch = stack_params(cfgs, dtype=jnp.float32)
    statics = statics_from_config(cfgs[0])
    months = jnp.asarray([0, 0, 0], jnp.int32)
    n_paths = 2 * n_dev * BLOCK_PATHS

    single = pallas_scenario_grid(
        batch, months, 5, n_scenarios=3, n_paths=n_paths,
        retirement_years=2, n_streams=0, statics=statics, interpret=True,
    )
    sharded = pallas_scenario_grid_sharded(
        batch, months, 5, mesh=mesh, n_scenarios=3, n_paths=n_paths,
        retirement_years=2, n_streams=0, statics=statics, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), rtol=0, atol=1e-5
    )
    # sanity: higher expenses, lower success
    p = np.asarray(single)
    assert p[0] >= p[1] >= p[2]


def test_mixed_tax_systems_rejected_by_pallas_grid_only():
    """The Pallas grid bakes tax systems into the executable, so a mixed
    batch must be rejected loudly there; the XLA scan path keeps them as
    per-row traced data and must keep accepting mixed batches."""
    import numpy as np
    import pytest

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_scenario_grid,
        statics_from_config,
    )
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        grid_statics,
        run_scenario_batch,
        stack_params,
    )
    from tests.conftest import make_config

    realized = make_config(
        inv1_use_realized_gains_tax_system=True,
        inv1_realized_gains_tax_rate=0.1,
        retirement_years=2,
    )
    annual = make_config(
        inv1_use_realized_gains_tax_system=False,
        inv1_annual_tax_on_gains_rate=0.25,
        retirement_years=2,
    )
    with pytest.raises(ValueError, match="Statics"):
        grid_statics([realized, annual])

    # The XLA scan path handles mixed batches correctly (per-row traced
    # flags) — it must NOT be blocked.
    res = run_scenario_batch([realized, annual], [12, 12], 64, seed=4)
    assert res.success_probability.shape == (2,)

    # The Pallas grid entry refuses concrete mixed batches before dispatch.
    import jax.numpy as jnp

    batch = stack_params([realized, annual], dtype=jnp.float32)
    with pytest.raises(ValueError, match="Statics"):
        pallas_scenario_grid(
            batch, jnp.asarray([12, 12], jnp.int32), 4,
            n_scenarios=2, n_paths=4096, retirement_years=2, n_streams=0,
            statics=statics_from_config(realized), interpret=True,
        )


def test_fused_grid_chunk_matches_raw_plus_stats():
    """The serving path's fused chunk program (grid kernel + reductions in
    one jit) must produce exactly what the two-dispatch form (raw kernel,
    then _grid_stats) produces — same tracer, same reductions."""
    import jax.numpy as jnp

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_scenario_grid_raw,
        statics_from_config,
    )
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        _grid_chunk_jit,
        _grid_stats_jit,
    )

    cfgs = [
        make_config(monthly_expenses=e, retirement_years=2, seed=11)
        for e in (1_500.0, 5_000.0)
    ]
    batch = stack_params(cfgs, dtype=jnp.float32)
    statics = statics_from_config(cfgs[0])
    months = np.asarray([6, 6], np.int32)
    kwargs = dict(
        n_scenarios=2, n_paths=4096, retirement_years=2, n_streams=0,
        statics=statics, interpret=True,
    )
    succ, fin = pallas_scenario_grid_raw(batch, months, 9, **kwargs)
    expected = _grid_stats_jit(succ, fin, n_paths=4096)
    fused = _grid_chunk_jit(batch, months, 9, **kwargs)
    # success/median/sigma/percentiles are exact (value-space selection and
    # exactly-representable counts); the mean may differ by reduction order
    # across the two compiled programs.
    for i, (a, b) in enumerate(zip(fused, expected)):
        if i == 2:  # mean_final_balance
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-6
            )
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grid_pipeline_window_invariance(monkeypatch):
    """run_scenario_grid's in-flight window only changes WHEN results are
    collected, never their values, order, or the progress-event protocol."""
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        run_scenario_grid,
    )

    cfgs = [
        make_config(monthly_expenses=e, retirement_years=3, seed=5)
        for e in (1_000.0, 2_000.0, 3_000.0, 4_000.0, 5_000.0)
    ]
    months = [12, 12, 18, 18, 24]

    def run_with(window):
        monkeypatch.setenv("MCRT_GRID_WINDOW", str(window))
        events = []
        out = run_scenario_grid(
            cfgs, months, 32, seed=2, chunk_size=2, backend="scan",
            progress_callback=events.append,
        )
        return out, events

    out0, ev0 = run_with(0)
    out3, ev3 = run_with(3)
    for a, b in zip(out0, out3):
        np.testing.assert_array_equal(a, b)
    assert [e["done"] for e in ev0] == [2, 4, 5]
    assert [e["done"] for e in ev3] == [2, 4, 5]
    assert all(e["type"] == "grid_chunk" for e in ev0 + ev3)


def test_grid_cell_budget_shrinks_chunks_exactly(monkeypatch):
    """MCRT_GRID_CELL_BUDGET (the grid's device-OOM guard) caps k x n
    cells per dispatch by shrinking the chunk size; grid-wide CRN makes
    the split EXACTLY equal to the one-dispatch run, and the progress
    protocol reports the smaller chunks."""
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        run_scenario_grid,
    )

    cfgs = [
        make_config(monthly_expenses=e, retirement_years=3, seed=5)
        for e in (1_000.0, 2_500.0, 4_000.0, 5_500.0)
    ]
    months = [12, 12, 18, 24]
    n = 32

    def run_with(budget):
        if budget is not None:
            monkeypatch.setenv("MCRT_GRID_CELL_BUDGET", str(budget))
        else:
            monkeypatch.delenv("MCRT_GRID_CELL_BUDGET", raising=False)
        events = []
        out = run_scenario_grid(
            cfgs, months, n, seed=2, chunk_size=4, backend="scan",
            progress_callback=events.append,
        )
        return out, events

    whole, ev_whole = run_with(None)
    assert [e["done"] for e in ev_whole] == [4]
    # Budget of 2 x n cells -> chunks of 2 scenarios.
    split, ev_split = run_with(2 * n)
    assert [e["done"] for e in ev_split] == [2, 4]
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a, b)
    # A budget below one row's cells still dispatches single rows.
    tiny, ev_tiny = run_with(1)
    assert [e["done"] for e in ev_tiny] == [1, 2, 3, 4]
    for a, b in zip(whole, tiny):
        np.testing.assert_array_equal(a, b)

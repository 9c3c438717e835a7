"""Scenario-grid serving: engine stats, /api/grid and its SSE variant.

The scenario grid's serving surface: these pin the
decision-grade per-scenario statistics to numpy, the chunked runner to the
single-dispatch result, and the endpoint/SSE contracts.
"""

import asyncio
import json

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import base_config_dict, make_config
from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
from monte_carlo_retirement_tpu.engine.scenario_batch import (
    GRID_FINAL_PERCENTILES,
    run_scenario_batch,
    run_scenario_grid,
)
from monte_carlo_retirement_tpu.hosts.grid import (
    GridRequest,
    GridResponse,
    prepare_grid,
    run_grid_request,
)
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import stream_keys


def test_batch_stats_match_numpy():
    """Per-scenario sigma and final-balance percentiles from the device
    reduction equal the numpy computation on the same per-path outputs."""
    cfgs = [
        make_config(seed=3, retirement_years=4),
        make_config(seed=3, retirement_years=4, monthly_expenses=3_500.0),
    ]
    months = [12, 24]
    n = 96
    res = run_scenario_batch(cfgs, months, num_simulations=n, seed=3)

    for i, (cfg, w) in enumerate(zip(cfgs, months)):
        params = SimParams.from_config(cfg, dtype=jnp.float32)
        _, key = stream_keys(3)
        outs = simulate_paths(
            params, jnp.int32(w), key, n_paths=n,
            t_scan=max(months) + 48, retirement_years=4, traj_len=0,
            dtype=jnp.float32,
        )
        succ = np.asarray(outs.success)
        fin = np.asarray(outs.final_balance)
        p = succ.mean() * 100.0
        assert res.success_probability[i] == pytest.approx(p, abs=1e-4)
        want_sigma = np.sqrt(p / 100 * (1 - p / 100) / n) * 100.0
        assert res.success_sigma[i] == pytest.approx(want_sigma, rel=1e-5)
        want_pcts = np.percentile(
            fin, [q * 100 for q in GRID_FINAL_PERCENTILES]
        )
        np.testing.assert_allclose(
            res.final_balance_percentiles[i], want_pcts, rtol=1e-5
        )
        assert res.median_final_balance[i] == pytest.approx(
            float(np.percentile(fin, 50.0)), rel=1e-5
        )
        assert res.mean_final_balance[i] == pytest.approx(
            float(fin.mean()), rel=1e-5
        )


def test_chunked_grid_equals_single_batch_and_reports_progress():
    """Chunking must not change results (CRN is structural) and must emit
    one grid_chunk event per dispatch."""
    cfgs = [
        make_config(seed=9, retirement_years=3, monthly_expenses=e)
        for e in (1_500.0, 2_000.0, 2_500.0, 3_000.0, 3_500.0)
    ]
    months = [12] * 5
    whole = run_scenario_grid(cfgs, months, 64, seed=9, chunk_size=5)
    events = []
    chunked = run_scenario_grid(
        cfgs, months, 64, seed=9, chunk_size=2,
        progress_callback=events.append,
    )
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert [e["done"] for e in events] == [2, 4, 5]
    assert all(e["type"] == "grid_chunk" and e["total"] == 5 for e in events)
    # Monotone success in expenses (CRN makes this deterministic).
    assert list(whole.success_probability) == sorted(
        whole.success_probability, reverse=True
    )


def test_prepare_grid_validation():
    base = base_config_dict()
    req = GridRequest(
        config=base,
        variants=[{"overrides": {"monthly_expenses": 2_200.0}},
                  {"name": "lean", "overrides": {}}],
        working_months=12,
        num_paths=32,
    )
    configs, months, names, n = prepare_grid(req)
    assert len(configs) == 2 and months == [12, 12] and n == 32
    assert names[0] == "monthly_expenses=2200.0" and names[1] == "lean"

    with pytest.raises(ValueError, match="variant 0"):
        prepare_grid(
            GridRequest(
                config=base,
                variants=[{"overrides": {"monthly_expenses": -5}}],
                working_months=0,
            )
        )
    with pytest.raises(ValueError, match="2 values for 1"):
        prepare_grid(
            GridRequest(
                config=base,
                variants=[{"overrides": {}}],
                working_months=[1, 2],
            )
        )


def test_run_grid_request_mixed_statics_rejected():
    base = base_config_dict()
    req = GridRequest(
        config=base,
        variants=[
            {"overrides": {}},
            {"overrides": {"inv1_use_realized_gains_tax_system": True,
                           "inv1_realized_gains_tax_rate": 0.2}},
        ],
        working_months=0,
        num_paths=16,
    )
    with pytest.raises(ValueError, match="statics"):
        run_grid_request(req)


def _client_fixture():
    from aiohttp.test_utils import TestClient, TestServer

    from monte_carlo_retirement_tpu.hosts.server import create_app

    return TestClient(TestServer(create_app()))


def _run(coro):
    return asyncio.run(coro)


def test_grid_endpoint_end_to_end():
    async def scenario():
        client = _client_fixture()
        await client.start_server()
        try:
            base = base_config_dict(num_simulations_main=48, retirement_years=3)
            body = {
                "config": base,
                "variants": [
                    {"name": "base", "overrides": {}},
                    {"name": "frugal",
                     "overrides": {"monthly_expenses": 1_200.0}},
                ],
                "working_months": 6,
            }
            resp = await client.post("/api/grid", json=body)
            assert resp.status == 200, await resp.text()
            data = await resp.json()
            GridResponse.model_validate(data)
            assert data["total_scenarios"] == 2 and data["num_paths"] == 48
            frugal, base_row = data["rows"][1], data["rows"][0]
            assert frugal["success_probability"] >= base_row["success_probability"]
            assert set(base_row["final_balance_percentiles"]) == {
                "p5", "p25", "p50", "p75", "p95"
            }

            # Malformed variant -> 422
            bad = {**body, "variants": [{"overrides": {"monthly_expenses": -1}}]}
            resp = await client.post("/api/grid", json=bad)
            assert resp.status == 422

            # Mixed statics -> 400
            mixed = {
                **body,
                "variants": [
                    {"overrides": {}},
                    {"overrides": {
                        "inv1_use_realized_gains_tax_system": True,
                        "inv1_realized_gains_tax_rate": 0.2,
                    }},
                ],
            }
            resp = await client.post("/api/grid", json=mixed)
            assert resp.status == 400
        finally:
            await client.close()

    _run(scenario())


def test_grid_stream_events():
    async def scenario():
        client = _client_fixture()
        await client.start_server()
        try:
            base = base_config_dict(num_simulations_main=32, retirement_years=3)
            body = {
                "config": base,
                "variants": [
                    {"overrides": {"monthly_expenses": float(e)}}
                    for e in (1_500, 2_000, 2_500)
                ],
                "working_months": 6,
                "chunk_size": 1,
            }
            resp = await client.post("/api/grid/stream", json=body)
            assert resp.status == 200
            text = (await resp.read()).decode()
            events = [
                json.loads(line.removeprefix("data: "))
                for line in text.splitlines()
                if line.startswith("data: ")
            ]
            types = [e["type"] for e in events]
            assert types[0] == "phase"
            assert types.count("grid_chunk") == 3
            assert types[-1] == "result"
            chunks = [e for e in events if e["type"] == "grid_chunk"]
            assert [c["done"] for c in chunks] == [1, 2, 3]
            result = events[-1]["data"]
            GridResponse.model_validate(result)
            assert result["total_scenarios"] == 3
        finally:
            await client.close()

    _run(scenario())

"""Multi-host SPMD worker: one process of an (H hosts x D devices) job.

This is both the documented multi-host driver example and the executable
half of tests/test_distributed.py. Every process of the job runs this
same program (JAX multi-controller SPMD):

    MCRT_COORDINATOR=host0:PORT MCRT_NUM_PROCESSES=H MCRT_PROCESS_ID=h \
        python scripts/dist_worker.py

This is a CPU multi-process rig: each process fakes D virtual CPU devices
(MCRT_LOCAL_DEVICE_COUNT) and the collectives run over gloo — same
program, same mesh construction, same invariants as a multi-host job. A
GPU host runs ONE process that drives all of its cards: a second JAX
process on a card fails for want of memory, because each process
reserves most of the card's memory when it starts.

Prints one ``RESULT {json}`` line: the replicated reduced summary plus
this process's addressable per-path shards (global offsets attached), so
the parent can reassemble the global vector and pin it bit-for-bit
against a single-process run.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from monte_carlo_retirement_tpu.parallel.distributed import (  # noqa: E402
    force_local_device_count,
    initialize_from_env,
    is_coordinator,
)

force_local_device_count(int(os.environ.get("MCRT_LOCAL_DEVICE_COUNT", "2")))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

if not initialize_from_env():
    print("RESULT " + json.dumps({"error": "MCRT_COORDINATOR not set"}))
    sys.exit(2)

import jax.numpy as jnp  # noqa: E402

from monte_carlo_retirement_tpu.config import Config, load_config_from_json  # noqa: E402
from monte_carlo_retirement_tpu.engine.runner import _run_jit  # noqa: E402
from monte_carlo_retirement_tpu.models.retirement import SimParams  # noqa: E402
from monte_carlo_retirement_tpu.ops.shocks import stream_keys  # noqa: E402
from monte_carlo_retirement_tpu.parallel.mesh import make_mesh, pad_to_devices  # noqa: E402


def main() -> None:
    n_devices = jax.device_count()
    mesh = make_mesh()  # global: spans every process's devices

    raw = load_config_from_json(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "config.json")
    )
    raw["retirement_years"] = 5
    raw["seed"] = 1234
    # A sustainable draw so outcomes are non-degenerate (mixed successes,
    # nonzero percentile tables) — the same overrides bench.py uses.
    raw["initial_balance"] = 120_000.0
    raw["monthly_expenses"] = 5_000.0
    config = Config(**raw)
    params = SimParams.from_config(config, dtype=jnp.float64)
    _, final_key = stream_keys(int(config.seed))

    n_paths = pad_to_devices(64, n_devices)
    outs, summary = _run_jit(
        params,
        jnp.asarray(24, dtype=jnp.int32),
        final_key,
        jnp.arange(5, dtype=jnp.int32),
        n_paths=n_paths,
        t_scan=120,
        retirement_years=5,
        traj_len=11,
        dtype=jnp.float64,
        mesh=mesh,
    )

    # Replicated reductions: identical on every process by construction.
    summary_host = jax.device_get(
        {
            "success_probability": summary.success_probability,
            "median_start_balance": summary.median_start_balance,
            "final_balance_percentiles": summary.final_balance_percentiles,
            "trajectory_percentiles": summary.trajectory_percentiles,
            "wr_percentiles": summary.wr_percentiles,
        }
    )

    # This process's addressable slices of the globally sharded outputs.
    shards = [
        {
            "start": int(s.index[0].start or 0),
            "final_balance": [float(v) for v in jax.device_get(s.data)],
        }
        for s in outs.final_balance.addressable_shards
    ]

    # The SERVING path, multi-host: Engine.run(reduced=True) fetches only
    # replicated reduced tables (percentiles + device-binned histograms),
    # which every process can read — per-path arrays never leave the
    # devices, so nothing non-addressable is touched.
    from monte_carlo_retirement_tpu.engine.runner import Engine

    eng = Engine(config, dtype=jnp.float64, mesh=mesh)
    rr = eng.run(24, n_paths, stream="final", reduced=True)
    reduced = {
        "success_probability": rr.success_probability,
        "swr": rr.swr,
        "final_balance_percentiles": rr.final_balance_percentiles.tolist(),
        "finals_hist_counts": rr.bins.finals_hist_counts.tolist(),
        "ruin_counts": rr.bins.ruin_counts.tolist(),
    }

    # HBM chunking COMPOSED with the cross-process mesh: the per-chip path
    # budget splits an oversized run into mesh-sized chunks whose
    # block_offset bookkeeping must stay globally contiguous across BOTH
    # the process boundary and the chunk boundary (runner.py _run_chunked).
    # Reduced tables from the chunked multi-host run must equal the
    # single-process unchunked run bit for bit; the parent test pins that.
    from monte_carlo_retirement_tpu.engine.pallas_kernel import BLOCK_PATHS

    # two kernel blocks per device and chunk (a one-step interpret grid
    # compiles differently on XLA:CPU)
    block = 2 * BLOCK_PATHS
    # Expenses chosen so the 2-year outcome is genuinely mixed (~66%
    # success) — a degenerate 0/100% scenario would let a broken merge
    # hide behind constant tables.
    cfg_small = Config(
        **{**raw, "retirement_years": 2, "monthly_expenses": 6_600.0}
    )
    eng2 = Engine(cfg_small, dtype=jnp.float32, mesh=mesh)
    w_chunk = 6
    n_big = 2 * n_devices * block  # 2 mesh-sized chunks
    os.environ["MCRT_MAX_DEVICE_PATHS"] = str(block)
    try:
        rr = eng2._run_chunked(
            w_chunk, n_big, "final",
            True,  # reduced: the multi-host serving path
            eng2._pallas_traj_len(w_chunk),
            jnp.arange(5, dtype=jnp.int32),
            interpret=True, sharded=True,
        )
    finally:
        del os.environ["MCRT_MAX_DEVICE_PATHS"]
    chunked = {
        "n_paths": n_big,
        "working_months": w_chunk,
        "success_probability": rr.success_probability,
        "final_balance_percentiles": rr.final_balance_percentiles.tolist(),
        "trajectory_percentiles": rr.trajectory_percentiles.tolist(),
        "wr_observation_counts": rr.wr_observation_counts.tolist(),
        "finals_hist_counts": rr.bins.finals_hist_counts.tolist(),
        "ruin_counts": rr.bins.ruin_counts.tolist(),
    }

    # The minimum-working-months SEARCH — the reference's flagship host
    # algorithm (/root/reference/backend/simulation.py:1138-1343) — driven
    # end-to-end over the cross-process mesh. Each probe batch is one SPMD
    # dispatch whose success reduction is replicated, so every process sees
    # the identical curve and the host-side ladder->verify loop stays in
    # lockstep across processes (a divergent probe result would deadlock the
    # next collective — this exercising IS the test). Overrides mirrored in
    # tests/test_distributed.py::test_cross_process_search_matches_single_process.
    from monte_carlo_retirement_tpu.search.driver import (
        find_minimum_working_months as search_months,
    )

    cfg_search = Config(
        **{
            **raw,
            "retirement_years": 3,
            "monthly_expenses": 8_000.0,
            "num_simulations_search": 64,
            "target_probability": 90.0,
            "starting_working_months_search": 0,
        }
    )
    eng3 = Engine(cfg_search, dtype=jnp.float64, mesh=mesh)
    # Covers the ladder's first two chunks (start + 396 months); the
    # scenario converges inside the first (answer ~30 months), so the
    # driver never probes beyond it.
    sm, sp, scurve = search_months(
        lambda ms: eng3.probe(
            list(ms), 64, stream="search", horizon_months=396
        ),
        starting_working_months=0,
        target_probability_pct=90.0,
        sim_count=64,
        scenario_name="dist-search",
        verbose=False,
    )
    search_res = {"months": sm, "probability": sp, "curve": scurve}

    def _clean(obj):
        if isinstance(obj, list):
            return [_clean(v) for v in obj]
        return None if obj != obj else obj  # NaN -> None (JSON-safe)

    def _listify(v):
        import numpy as np

        arr = np.asarray(v)
        return _clean(arr.tolist())

    print(
        "RESULT "
        + json.dumps(
            {
                "process": jax.process_index(),
                "num_processes": jax.process_count(),
                "coordinator": is_coordinator(),
                "global_devices": n_devices,
                "n_paths": n_paths,
                "summary": {k: _listify(v) for k, v in summary_host.items()},
                "reduced": {k: _clean(v) for k, v in reduced.items()},
                "chunked": {k: _clean(v) for k, v in chunked.items()},
                "search": search_res,
                "shards": shards,
            },
            allow_nan=False,
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

"""Scenario-parallel execution: a batch of configs as one device program.

The reference ran one config per process (SURVEY §2.3 marks scenario-parallel
as absent). Here a scenario grid is a *struct-of-arrays* ``SimParams`` —
every scalar leaf stacked over a leading scenario axis — and the compiled
path kernel is simply vmapped over it. A 256-variant sweep therefore costs
one device dispatch, sharing shocks across scenarios (common random numbers
over the grid, so outcome differences are attributable to the config deltas,
not sampling noise).

Constraint: all configs in one batch must share structural shape —
``retirement_years`` and the number of *effective* income streams (streams
with zero amount or zero duration are pruned before stacking, so padding
with zero-amount streams does NOT align batches; every config must carry
the same count of streams that can actually pay).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..models.retirement import SimParams
from ..ops.quantiles import exact_quantiles
from ..ops.shocks import stream_keys
from .kernel import simulate_paths

log = logging.getLogger("mcrt.grid")

# Decision-grade per-scenario final-balance bands (grid serving payload).
GRID_FINAL_PERCENTILES = (0.05, 0.25, 0.50, 0.75, 0.95)


class ScenarioBatchResult(NamedTuple):
    success_probability: np.ndarray  # (k,) percent
    median_final_balance: np.ndarray  # (k,)
    mean_final_balance: np.ndarray  # (k,)
    success_sigma: np.ndarray  # (k,) one-sigma binomial MC error, percent
    final_balance_percentiles: np.ndarray  # (k, 5) at GRID_FINAL_PERCENTILES

    def concat(self, other: "ScenarioBatchResult") -> "ScenarioBatchResult":
        return ScenarioBatchResult(
            *(np.concatenate([a, b]) for a, b in zip(self, other))
        )


def grid_statics(configs: Sequence[Config]):
    """The shared compile-time Statics of a scenario batch.

    The Pallas grid kernel bakes tax systems and stream structure into the
    executable, so every config in one PALLAS grid dispatch must share them
    (the XLA scan path keeps these as per-row traced data and accepts mixed
    batches). Raises ValueError when the batch mixes them.
    """
    from .pallas_kernel import statics_from_config

    statics = {statics_from_config(c) for c in configs}
    if len(statics) != 1:
        raise ValueError(
            "all configs in a scenario grid must share tax systems and "
            "stream structure (compile-time Statics); split the batch by "
            f"statics. Got {len(statics)} distinct combinations."
        )
    return next(iter(statics))


def stack_params(configs: Sequence[Config], dtype=jnp.float32) -> SimParams:
    """Stack per-config SimParams into one struct-of-arrays pytree.

    Leaves are *numpy* arrays: stacking K configs on device would cost
    ~25 K small transfers; jit consumers transfer the stacked pytree once
    at dispatch.
    """
    if not configs:
        raise ValueError("scenario batch needs at least one config")
    r_years = {c.retirement_years for c in configs}
    if len(r_years) != 1:
        raise ValueError(
            f"all configs must share retirement_years, got {sorted(r_years)}"
        )
    per_config = [SimParams.host_leaves(c, dtype=dtype) for c in configs]
    # Validate on the PRUNED stream count — SimParams.host_leaves drops
    # zero-amount/zero-duration streams, so the raw config counts can match
    # while the stacked array shapes do not.
    n_streams = {p.n_streams for p in per_config}
    if len(n_streams) != 1:
        raise ValueError(
            "all configs must have the same number of effective income "
            "streams after pruning zero-amount/zero-duration ones, got "
            f"counts {sorted(n_streams)}"
        )
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per_config)


def run_scenario_batch(
    configs: Sequence[Config],
    working_months: Sequence[int],
    num_simulations: int,
    seed: int = 0,
    dtype=jnp.float32,
    t_scan: Optional[int] = None,
) -> ScenarioBatchResult:
    """Simulate every (config, working_months) pair in one compiled dispatch.

    ``working_months`` is per-scenario (len == len(configs)). Shocks are
    shared across scenarios (CRN over the grid).
    """
    if len(working_months) != len(configs):
        raise ValueError("working_months must align with configs")
    params = stack_params(configs, dtype=dtype)
    R = configs[0].retirement_years
    w_vec = jnp.asarray(list(working_months), dtype=jnp.int32)
    horizon = int(max(working_months)) + 12 * R
    t = t_scan or horizon
    if t < horizon:
        raise ValueError("t_scan below the longest scenario horizon")
    _, final_key = stream_keys(seed)
    # Sampling mode is compile-time (the shock draw count differs), so one
    # batch cannot mix it — unlike tax rates, which stay per-row traced data.
    anti = {bool(c.antithetic) for c in configs}
    if len(anti) != 1:
        raise ValueError(
            "all configs in a scenario batch must share 'antithetic' "
            "(sampling mode is compile-time structure)"
        )
    # Crash jumps draw from a DISJOINT fold_in stream on the scan path, so a
    # mixed batch is fine here: p=0 sentinel rows are exact no-ops and the
    # base shocks are untouched either way. (The Pallas grid path cannot
    # mix — grid_statics enforces uniformity there.)
    jumps = any(
        getattr(c, "market_crashes", None) is not None for c in configs
    )
    # The longevity uniform also lives in its own disjoint stream, so mixed
    # batches are fine on the scan path: sentinel rows (mort_b12 == 0) never
    # expire and the base shocks are untouched either way.
    mortality = any(
        getattr(c, "longevity", None) is not None for c in configs
    )

    stats = _batch_jit(
        params,
        w_vec,
        final_key,
        n_paths=int(num_simulations),
        t_scan=t,
        retirement_years=R,
        dtype=dtype,
        antithetic=anti.pop(),
        jumps=jumps,
        mortality=mortality,
    )
    # jax.device_get batches the tree into ONE transfer instead of one per
    # leaf.
    return ScenarioBatchResult(*jax.device_get(tuple(stats)))


def _grid_stats(success_f32, final, n_paths: int):
    """Per-scenario decision-grade reductions on (k, n) device arrays:
    success% + binomial sigma, mean, and the GRID_FINAL_PERCENTILES bands
    via the sort-free selection engine. Under a sharded path axis the sums
    inside lower to collectives."""
    succ = success_f32[:, :n_paths]
    fin = final[:, :n_paths]
    p = jnp.mean(succ, axis=1) * 100.0
    frac = p / 100.0
    sigma = jnp.sqrt(jnp.clip(frac * (1.0 - frac), 0.0) / n_paths) * 100.0
    mean_final = jnp.mean(fin, axis=1)
    pcts = exact_quantiles(
        jnp.transpose(fin), jnp.asarray(GRID_FINAL_PERCENTILES, fin.dtype)
    )  # (5, k)
    return (
        p,
        pcts[2],
        mean_final,
        sigma,
        jnp.transpose(pcts),
    )


def _batch_impl(params, w_vec, key, n_paths, t_scan, retirement_years, dtype,
                antithetic=False, jumps=False, mortality=False):
    def one(p, w):
        outs = simulate_paths(
            p,
            w,
            key,
            n_paths=n_paths,
            t_scan=t_scan,
            retirement_years=retirement_years,
            traj_len=0,
            dtype=dtype,
            antithetic=antithetic,
            jumps=jumps,
            mortality=mortality,
        )
        return outs.success.astype(jnp.float32), outs.final_balance

    succ, final = jax.vmap(one, in_axes=(0, 0))(params, w_vec)
    return _grid_stats(succ, final, n_paths)


_batch_jit = jax.jit(
    _batch_impl,
    static_argnames=("n_paths", "t_scan", "retirement_years", "dtype",
                     "antithetic", "jumps", "mortality"),
)

_grid_stats_jit = jax.jit(_grid_stats, static_argnames=("n_paths",))


def _grid_chunk_impl(
    params_batch, months, seed, *, n_scenarios, n_paths, retirement_years,
    n_streams, statics, interpret=False,
):
    """One serving chunk as ONE device program: the (path-block, scenario)
    grid kernel plus every per-scenario reduction, so only the (k,)-sized
    tables leave the device."""
    from .pallas_kernel import _scenario_grid_call

    succ, fin = _scenario_grid_call(
        params_batch, months, seed,
        n_scenarios=n_scenarios, n_paths=n_paths,
        retirement_years=retirement_years, n_streams=n_streams,
        statics=statics, interpret=interpret,
    )
    return _grid_stats(succ, fin, n_paths)


_grid_chunk_jit = jax.jit(
    _grid_chunk_impl,
    static_argnames=(
        "n_scenarios", "n_paths", "retirement_years", "n_streams", "statics",
        "interpret",
    ),
)


def run_scenario_grid(
    configs: Sequence[Config],
    working_months: Sequence[int],
    num_simulations: int,
    seed: int = 0,
    chunk_size: Optional[int] = None,
    backend: Optional[str] = None,
    mesh=None,
    progress_callback: Optional[Callable[[dict], None]] = None,
) -> ScenarioBatchResult:
    """Serve a whole scenario grid: chunked device dispatches + progress.

    The serving entry behind POST /api/grid (e.g. 256 variants x 1M paths
    on one device). Chunks of ``chunk_size`` scenarios dispatch on the
    (path-block, scenario) grid kernel on a GPU — or the vmapped XLA scan
    on the CPU, see engine.runner.auto_backend — and ``progress_callback``
    receives a ``grid_chunk`` event after each (mirroring the reference's
    SSE progress pattern, backend/server.py:322-413). Shocks are shared
    across the WHOLE grid and equal the Engine's 'final' stream for the
    same seed (chunking preserves CRN: draws depend only on (stream,
    month, path)).
    """
    configs = list(configs)
    working_months = [int(m) for m in working_months]
    if len(working_months) != len(configs):
        raise ValueError("working_months must align with configs")
    if not configs:
        raise ValueError("scenario grid needs at least one config")
    if any(m < 0 for m in working_months):
        raise ValueError("working_months must be >= 0")
    statics = grid_statics(configs)  # raises on mixed structure
    R = configs[0].retirement_years
    n = int(num_simulations)
    if chunk_size is None:
        chunk_size = int(os.environ.get("MCRT_GRID_CHUNK", "16"))
    chunk_size = max(1, int(chunk_size))
    # Device-OOM guard, the grid analog of MCRT_MAX_DEVICE_PATHS: one
    # dispatch materialises two (k, n) f32 tables on device, so bound
    # k x n cells per dispatch and shrink oversized chunks. Scenario
    # chunking is exact under grid-wide CRN (draws depend only on
    # (stream, month, path)), so splitting never changes results; the
    # pipeline window below holds up to window+1 dispatches live — size
    # the budget with that in mind. 256M cells ≈ 2 GB of output tables
    # per dispatch, ~6 GB with the window: under a tenth of an H100's
    # 80 GB (a constant, not derived from the device).
    cell_budget = int(
        os.environ.get("MCRT_GRID_CELL_BUDGET", str(256 * 1024 * 1024))
    )
    if n > 0:
        chunk_size = max(1, min(chunk_size, cell_budget // n))

    if backend is None:
        backend = os.environ.get("MCRT_GRID_BACKEND", "auto")
    if backend == "auto":
        from .runner import auto_backend

        backend = auto_backend(jnp.float32, mesh)
    if backend not in ("scan", "pallas", "pallas_sharded"):
        raise ValueError(f"unknown grid backend {backend!r}")

    # One shared horizon so every chunk reuses one executable (scan path).
    horizon = max(working_months) + 12 * R
    _, final_key = stream_keys(seed)
    total = len(configs)
    done = 0
    t0 = time.perf_counter()
    out: Optional[ScenarioBatchResult] = None
    # Device chunks pipeline through a small in-flight window: the host
    # preps and dispatches chunk i+1 while chunk i computes, and collects
    # results in order. Each in-flight Pallas chunk holds two (k, n) f32
    # intermediates (~128 MB at 16 x 1M), so the window stays small — this
    # is NOT an unbounded async queue (full-stats chunks hold GBs of series
    # per dispatch and are serialized instead, see Engine._run_chunked).
    window = max(0, int(os.environ.get("MCRT_GRID_WINDOW", "2")))
    pending: list = []  # (k, device stats tuple), oldest first

    def _collect_one():
        nonlocal out, done
        k, stats = pending.pop(0)
        # One batched fetch per chunk (device_get), not one per table.
        chunk_res = ScenarioBatchResult(*jax.device_get(tuple(stats)))
        out = chunk_res if out is None else out.concat(chunk_res)
        done += k
        if progress_callback is not None:
            progress_callback(
                {
                    "type": "grid_chunk",
                    "done": done,
                    "total": total,
                    "elapsed_s": round(time.perf_counter() - t0, 3),
                }
            )
        log.info(
            "phase=grid backend=%s scenarios=%d/%d paths=%d: %.3f s",
            backend, done, total, n, time.perf_counter() - t0,
        )

    for i in range(0, total, chunk_size):
        chunk_cfgs = configs[i : i + chunk_size]
        chunk_months = working_months[i : i + chunk_size]
        k = len(chunk_cfgs)
        if backend in ("pallas", "pallas_sharded"):
            from .pallas_kernel import (
                _check_grid_statics,
                pallas_scenario_grid_raw_sharded,
            )

            params = stack_params(chunk_cfgs, dtype=jnp.float32)
            _check_grid_statics(params, statics)
            months = np.asarray(chunk_months, dtype=np.int32)
            kwargs = dict(
                n_scenarios=k,
                n_paths=n,
                retirement_years=R,
                n_streams=int(params.stream_amount.shape[-1]),
                statics=statics,
            )
            if backend == "pallas_sharded":
                succ, fin = pallas_scenario_grid_raw_sharded(
                    params, months, final_key, mesh=mesh,
                    **kwargs,
                )
                stats = _grid_stats_jit(succ, fin, n_paths=n)
            else:
                stats = _grid_chunk_jit(
                    params, months, final_key, **kwargs
                )
            pending.append((k, stats))
        else:
            chunk_res = run_scenario_batch(
                chunk_cfgs, chunk_months, n, seed=seed, t_scan=horizon
            )
            pending.append((k, tuple(chunk_res)))
        while len(pending) > window:
            _collect_one()
    while pending:
        _collect_one()
    return out

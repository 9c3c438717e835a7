#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the path-sharded run only

Phases (one card):
  1. device    — JAX must see a GPU; prints the card, JAX and XLA_FLAGS.
  2. compile   — every kernel entry point at real width (1M paths x 600
                 months), with its memory analysis.
  3. parity    — kernel against the XLA scan (engine/kernel.py) on the card:
                 per path on three scenarios, on injected draws, and the
                 exact order statistics against numpy.
  4. main path — Config -> Engine -> working-months search -> final run ->
                 payload for config.json and jorge.json at 100k search /
                 1M final paths.
  5. grid      — a 16-variant scenario grid x 1M paths; one row equals the
                 single-scenario run (common random numbers).

Any failure exits nonzero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 1_000_000  # real width: paths per run
N_SEARCH = 100_000
SEED = 2026
OPTIONAL = ("pydantic", "aiohttp", "pandas", "matplotlib")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0]


def load(name, **overrides):
    from monte_carlo_retirement_tpu.config import Config, load_config_from_json

    raw = load_config_from_json(os.path.join(HERE, name))
    raw.update(overrides)
    return Config(**raw)


def stress(**overrides):
    """config.json with realistic volatility and every extension on, so
    that ruin paths exist."""
    return load(
        "config.json", inv1_returns_volatility=0.15, antithetic=True,
        allocation_inv1_final_pct=0.4,
        spending_guardrails={"upper_wr_pct": 6.0, "lower_wr_pct": 3.0},
        market_crashes={"frequency_per_year": 0.5, "mean_drop_pct": 25.0,
                        "size_volatility": 0.3, "inv2_beta": 0.5},
        longevity={"mode_age": 88.0, "dispersion_years": 9.0},
        **overrides,
    )


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device(jax, want_count):
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX runs on {devices[0].platform!r}")
    if len(devices) < want_count:
        fail(f"need {want_count} GPUs, JAX sees {len(devices)}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices {devices}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    present = {m: importlib.util.find_spec(m) is not None for m in OPTIONAL}
    print(f"optional packages importable (informational): {present}")
    print("PHASE 1 device: ok", flush=True)


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def phase_compile(jax, jnp, np):
    from monte_carlo_retirement_tpu.engine import pallas_kernel as pk
    from monte_carlo_retirement_tpu.engine.scenario_batch import stack_params
    from monte_carlo_retirement_tpu.models.retirement import SimParams
    from monte_carlo_retirement_tpu.ops.shocks import stream_keys

    # The bench scenario: retire at T=0, 600 months, paths that survive.
    cfg = load("config.json", retirement_years=50,
               initial_balance=1_500_000.0, monthly_expenses=4_000.0)
    p = SimParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(retirement_years=50, n_streams=p.n_streams,
              statics=pk.statics_from_config(cfg))
    key = stream_keys(SEED)[1]
    months = jnp.asarray([0, 12, 24, 36] * 4, jnp.int32)
    batch = stack_params([cfg] * 16)
    L = 1 + 600 // 12
    entries = {
        "simulate": lambda k: pk.pallas_simulate(p, 0, k, n_paths=N, **kw),
        "probe": lambda k: pk.pallas_probe(
            p, months, k, n_candidates=16, n_paths=N, **kw),
        "full": lambda k: pk.pallas_simulate_full(
            p, 0, k, n_paths=N, traj_len=L, **kw),
        "grid_raw": lambda k: pk._pallas_scenario_grid_raw_jit(
            batch, months, k, n_scenarios=16, n_paths=N, **kw),
    }
    outs = {}
    for name, fn in entries.items():
        (compiled, dt) = timed(lambda: jax.jit(fn).lower(key).compile())
        out = jax.block_until_ready(compiled(key))
        # years_to_ruin and withdrawal_rates are NaN by design (survivors,
        # years without an observation); everything else must be finite.
        leaves = jax.tree_util.tree_leaves(
            {k: v for k, v in out.items()
             if k not in ("years_to_ruin", "withdrawal_rates")}
            if isinstance(out, dict) else out
        )
        if not all(bool(np.isfinite(np.asarray(x)).all()) for x in leaves):
            fail(f"{name}: non-finite output")
        print(f"compile {name}: {dt:.2f} s; {compiled.memory_analysis()}")
        outs[name] = out
    probs = np.asarray(outs["probe"])
    if not ((probs >= 0) & (probs <= 100)).all():
        fail(f"probe probabilities out of range: {probs}")
    print("PHASE 2 compile: ok", flush=True)
    return outs["full"]


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------

# Both kernels run float32 on the same draws; they differ by rounding only
# (exp/log/erf_inv implementations, fused multiply-adds, another algebra
# for the same sale). A survivor that nearly ran out and recovered carries
# a cancellation-amplified rounding error, so its final balance is held to
# 1e-4 of the larger of its own and the run's median surviving balance.
# Guardrail bands, the crash threshold and the lifespan's month are step
# functions: where the two round to different sides of one, the path goes
# on differently. Such paths are counted against DIVERGED_SHARE, and the
# distribution they belong to is held by the median and mean.
FINAL_RTOL = 1e-4      # per alive path, of max(|final|, median alive final)
DIVERGED_SHARE = 1e-3  # alive paths allowed outside FINAL_RTOL
STAT_RTOL = 1e-4       # median and mean of the alive final balances
FLAG_SHARE = 1e-4      # success flags may disagree on this share of paths
PROB_PP = 0.02         # success probability, percentage points


def compare_paths(np, name, succ_k, fin_k, succ_s, fin_s):
    n = succ_s.shape[0]
    succ_k = np.asarray(succ_k)[:n] > 0.5
    fin_k = np.asarray(fin_k)[:n].astype(np.float64)
    succ_s = np.asarray(succ_s).astype(bool)
    fin_s = np.asarray(fin_s).astype(np.float64)
    both = succ_k & succ_s
    if not both.any():
        fail(f"parity {name}: no path survives in both runs")
    a, b = fin_k[both], fin_s[both]
    scale = max(float(np.median(np.abs(b))), 1.0)
    err = np.abs(a - b) / np.maximum(np.abs(b), scale)
    diverged = float((err > FINAL_RTOL).mean())
    d_med = abs(float(np.median(a) / np.median(b)) - 1.0)
    d_mean = abs(float(a.mean() / b.mean()) - 1.0)
    flags = float((succ_k != succ_s).mean())
    dp = abs(float(succ_k.mean() - succ_s.mean())) * 100.0
    q = np.quantile(err, [0.5, 0.999, 0.9999])
    print(f"parity {name}: n={n} success kernel {succ_k.mean() * 100:.4f}% "
          f"scan {succ_s.mean() * 100:.4f}% (|dp| {dp:.4f} pp); flags differ "
          f"on {flags:.2e}; final balance (alive, rel. to max(|final|, "
          f"median {scale:.4g})): p50 {q[0]:.2e} p99.9 {q[1]:.2e} p99.99 "
          f"{q[2]:.2e} max {err.max():.2e}; share above {FINAL_RTOL}: "
          f"{diverged:.2e}; median rel {d_med:.2e}, mean rel {d_mean:.2e}")
    if (diverged > DIVERGED_SHARE or d_med > STAT_RTOL or d_mean > STAT_RTOL
            or flags > FLAG_SHARE or dp > PROB_PP):
        fail(f"parity {name} outside tolerance")


def phase_parity(jax, jnp, np, full):
    from monte_carlo_retirement_tpu.engine import pallas_kernel as pk
    from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
    from monte_carlo_retirement_tpu.models.retirement import SimParams
    from monte_carlo_retirement_tpu.ops.quantiles import order_statistics
    from monte_carlo_retirement_tpu.ops.shocks import stream_keys

    key = stream_keys(SEED)[1]
    for name, cfg, w in [("config.json", load("config.json"), 240),
                         ("jorge.json", load("jorge.json"), 120),
                         ("stress", stress(), 240)]:
        p = SimParams.from_config(cfg, dtype=jnp.float32)
        st = pk.statics_from_config(cfg)
        R = cfg.retirement_years
        succ_k, fin_k = pk.pallas_simulate(
            p, w, key, n_paths=N, retirement_years=R, n_streams=p.n_streams,
            statics=st)
        scan = simulate_paths(
            p, jnp.int32(w), key, n_paths=N, t_scan=w + 12 * R,
            retirement_years=R, traj_len=0, dtype=jnp.float32,
            antithetic=st.antithetic, jumps=st.jumps, mortality=st.mortality)
        compare_paths(np, f"{name} W={w}", succ_k, fin_k, scan.success,
                      scan.final_balance)

    # Injected draws: the scan's own normals fed to the kernel.
    cfg = load("config.json", retirement_years=30)
    p = SimParams.from_config(cfg, dtype=jnp.float32)
    n, w, T = 65_536, 240, 600
    z = jnp.stack([jax.random.normal(jax.random.fold_in(key, m), (n, 3),
                                     jnp.float32) for m in range(1, T + 1)])
    succ_k, fin_k = pk.pallas_simulate(
        p, w, 0, n_paths=n, retirement_years=30, n_streams=p.n_streams,
        statics=pk.statics_from_config(cfg), shocks=jnp.transpose(z, (0, 2, 1)),
        with_shocks=True)
    scan = simulate_paths(p, jnp.int32(w), key, n_paths=n, t_scan=T,
                          retirement_years=30, traj_len=0, dtype=jnp.float32)
    compare_paths(np, "injected 65536 x 600", succ_k, fin_k, scan.success,
                  scan.final_balance)

    # Exact order statistics of the kernel's trajectories vs numpy.
    traj = full["trajectory"][:N, :8]
    ranks = np.asarray([0, N // 20, N // 2, N - N // 20, N - 1], np.int32)
    dev = np.asarray(order_statistics(
        traj, jnp.broadcast_to(jnp.asarray(ranks), (8, ranks.size))))
    host = np.sort(np.asarray(traj), axis=0)[ranks].T
    if not np.array_equal(dev, host):
        fail("order statistics differ from numpy on the same arrays")
    sub = jnp.asarray([1e-40, 0.0, -1e-40], jnp.float32)
    seen = np.asarray(jax.jit(lambda v: v > 0.0)(sub))
    print(f"order statistics: exact on 8 x {N} trajectory columns; "
          f"subnormal 1e-40 compares > 0 on the card: {bool(seen[0])}")
    print("PHASE 3 parity: ok", flush=True)


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------


class _Final:
    """The payload builder's simulator seam, served by Engine.run."""

    def __init__(self, engine):
        self.engine = engine

    def run_result_reduced(self, working_months, num_simulations):
        return self.engine.run(working_months, num_simulations,
                               stream="final", reduced=True)


def _check_payload(payload, path="payload"):
    if isinstance(payload, dict):
        for k, v in payload.items():
            _check_payload(v, f"{path}.{k}")
    elif isinstance(payload, list):
        for i, v in enumerate(payload):
            _check_payload(v, f"{path}[{i}]")
    elif isinstance(payload, float) and not math.isfinite(payload):
        fail(f"non-finite value at {path}")
    elif payload is None and "withdrawal_rate" not in path and (
        "percentiles" in path or "trajectory" in path
    ):
        fail(f"missing table value at {path}")


def main_path(jnp, name):
    from monte_carlo_retirement_tpu.constants import MAX_SEARCH_YEARS
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.hosts.payload import build_result
    from monte_carlo_retirement_tpu.search.driver import (
        find_minimum_working_months,
    )

    cfg = load(name, seed=SEED, num_simulations_search=N_SEARCH,
               num_simulations_main=N)
    engine = Engine(cfg, dtype=jnp.float32)
    for kind, backend in (("probe", engine._resolve_probe_backend(None)),
                          ("run", engine._resolve_run_backend(None))):
        if backend != "pallas":
            fail(f"{name}: {kind} backend is {backend!r}, not the kernel")
    horizon = cfg.starting_working_months_search + MAX_SEARCH_YEARS * 12
    months, prob, curve = find_minimum_working_months(
        lambda m: engine.probe(m, N_SEARCH, stream="search",
                               horizon_months=horizon),
        starting_working_months=cfg.starting_working_months_search,
        target_probability_pct=cfg.target_probability,
        sim_count=N_SEARCH, verbose=False,
    )
    if months < cfg.starting_working_months_search or prob < cfg.target_probability:
        fail(f"{name}: search found {months} months at {prob}%")
    payload = build_result(cfg, _Final(engine), months, curve,
                           include_raw=False)
    _check_payload(payload)
    return months, prob, payload["summary"]


def phase_main_path(jnp, card):
    for name in ("config.json", "jorge.json"):
        (months, prob, summary), cold = timed(lambda: main_path(jnp, name))
        _, warm = timed(lambda: main_path(jnp, name))
        keys = ("success_probability", "median_final_balance_successful",
                "safe_withdrawal_rate")
        shown = {k: summary.get(k) for k in keys if k in summary}
        print(f"main path {name}: {months} months at {prob:.3f}% (target "
              f"met); final {shown}; search+final+payload cold {cold:.2f} s, "
              f"warm {warm:.2f} s on {card} (informational)")
    print("PHASE 4 main path: ok", flush=True)


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------


def phase_grid(np):
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.engine.scenario_batch import (
        GRID_FINAL_PERCENTILES,
        run_scenario_grid,
    )

    configs = [load("config.json", monthly_expenses=8_000.0 + 250.0 * i)
               for i in range(16)]
    w = 240
    res, dt = timed(lambda: run_scenario_grid(configs, [w] * 16, N, seed=SEED))
    row = 5
    single = Engine(configs[row], main_seed_override=SEED).run(
        w, N, stream="final", reduced=True)
    p50 = list(GRID_FINAL_PERCENTILES).index(0.5)
    got = (float(res.success_probability[row]),
           float(res.final_balance_percentiles[row][p50]))
    want = (single.success_probability,
            float(single.final_balance_percentiles[4]))  # 0.50 of 9 quantiles
    print(f"grid 16 x {N}: {dt:.2f} s; row {row} {got} vs single run {want}")
    if abs(got[0] - want[0]) > 1e-6 or got[1] != want[1]:
        fail("grid row differs from the single-scenario run")
    print("PHASE 5 grid: ok", flush=True)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


# Per-path outputs are bit-equal across meshes; a success probability is a
# float32 mean whose summation order follows the mesh, so it may move in its
# last bits (1e-6 of probability = 1e-4 percentage points).
PROB_4 = 1e-6


def four_cards(jax, jnp, np):
    from monte_carlo_retirement_tpu.engine import pallas_kernel as pk
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.models.retirement import SimParams
    from monte_carlo_retirement_tpu.ops.shocks import stream_keys
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    cfg = stress(retirement_years=50)
    p = SimParams.from_config(cfg, dtype=jnp.float32)
    kw = dict(retirement_years=50, n_streams=p.n_streams,
              statics=pk.statics_from_config(cfg))
    key = stream_keys(SEED)[1]
    n4 = 4 * N
    local = pk._local_blocks(n4, 4, pk.BLOCK_PATHS) * pk.BLOCK_PATHS
    n_same = 4 * local  # one card, same global block count
    w = 240  # 20 working years, then 600 retirement months
    L = 1 + (w + 12 * 50) // 12

    months = jnp.asarray([w - 24, w - 12, w, w + 12] * 4, jnp.int32)
    probe4 = lambda: np.asarray(pk.pallas_probe_sharded(
        p, months, key, mesh=mesh, n_candidates=16, n_paths=n4, **kw))
    probe1 = lambda: np.asarray(pk.pallas_probe(
        p, months, key, n_candidates=16, n_paths=n_same, **kw))
    p4, p1 = probe4(), probe1()
    (_, t4), (_, t1) = timed(probe4), timed(probe1)
    print(f"sharded probe 16 x {n4}: warm {t4 * 1e3:.1f} ms on 4 cards, "
          f"{t1 * 1e3:.1f} ms on one (informational); success {p4[:4]}; "
          f"max |dp| vs one card {np.abs(p4 - p1).max():.2e} pp")
    if np.abs(p4 - p1).max() > PROB_4 * 100.0:
        fail("sharded probe differs from the one-card probe")

    f4 = pk.pallas_simulate_full_sharded(p, w, key, mesh=mesh, n_paths=n4,
                                         traj_len=L, **kw)
    f1 = pk.pallas_simulate_full(p, w, key, n_paths=n_same, traj_len=L, **kw)
    for name in pk.FULL_OUTPUTS:
        a, b = np.asarray(f4[name]), np.asarray(f1[name])
        if not np.array_equal(a, b, equal_nan=True):
            fail(f"sharded full run differs from one card in {name}")
    print(f"sharded full run {n4} x 600: every per-path output bit-equal "
          "to the one-card run")
    del f4, f1

    r4 = Engine(cfg, main_seed_override=SEED, mesh=mesh).run(
        w, n4, stream="final", reduced=True)
    r1 = Engine(cfg, main_seed_override=SEED).run(
        w, n4, stream="final", reduced=True)
    q4 = np.asarray(r4.final_balance_percentiles)
    q1 = np.asarray(r1.final_balance_percentiles)
    print(f"Engine 4-card mesh vs one card: success "
          f"{r4.success_probability:.6f} vs {r1.success_probability:.6f}; "
          f"final-balance percentiles equal: {np.array_equal(q4, q1)}")
    if (abs(r4.success_probability - r1.success_probability) > PROB_4 * 100.0
            or not np.array_equal(q4, q1)):
        fail("meshed Engine run differs from the one-card run")
    print("FOUR CARDS: ok", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the path-sharded path on 4 GPUs")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "monte_carlo_retirement_tpu")):
        fail("run from a checkout of the repository")
    sys.path.insert(0, HERE)

    import jax
    import jax.numpy as jnp
    import numpy as np

    want = 4 if args.four_cards else 1
    phase_device(jax, want)
    card = card_line()
    if args.four_cards:
        four_cards(jax, jnp, np)
    else:
        full = phase_compile(jax, jnp, np)
        phase_parity(jax, jnp, np, full)
        del full
        phase_main_path(jnp, card)
        phase_grid(np)
    dev = jax.devices()[0]
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

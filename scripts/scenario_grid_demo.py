"""A 256-variant scenario grid on one device.

Sweeps a 16x16 (expenses x equity-mean) grid of the default scenario on the
GPU kernel's (path-block, scenario) grid — per-row parameters, shared shock
draws (CRN across the whole grid) — chunked into a few dispatches.

Usage: python scripts/scenario_grid_demo.py [n_paths] [chunk]
"""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from monte_carlo_retirement_tpu.config import Config, load_config_from_json
from monte_carlo_retirement_tpu.engine.pallas_kernel import pallas_scenario_grid
from monte_carlo_retirement_tpu.engine.scenario_batch import grid_statics
from monte_carlo_retirement_tpu.engine.runner import enable_persistent_compilation_cache
from monte_carlo_retirement_tpu.engine.scenario_batch import stack_params

enable_persistent_compilation_cache()

N_PATHS = int(sys.argv[1]) if len(sys.argv) > 1 else 131_072
CHUNK = int(sys.argv[2]) if len(sys.argv) > 2 else 16
W = 231
R = 50

raw = load_config_from_json(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config.json"))
raw["seed"] = 1

expenses = np.linspace(4_000, 14_000, 16)
eq_means = np.linspace(0.06, 0.14, 16)
configs = [
    Config(**{**raw, "monthly_expenses": float(e), "inv1_returns_mean": float(m)})
    for e in expenses for m in eq_means
]
print(f"{len(configs)} scenarios x {N_PATHS:,} paths x {W + 12 * R} months, "
      f"chunks of {CHUNK}")

t0 = time.time()
probs = np.zeros(len(configs), np.float32)
for i in range(0, len(configs), CHUNK):
    chunk = configs[i : i + CHUNK]
    batch = stack_params(chunk, dtype=jnp.float32)
    months = jnp.full((len(chunk),), W, jnp.int32)
    out = pallas_scenario_grid(
        batch, months, 7,
        n_scenarios=len(chunk), n_paths=N_PATHS, retirement_years=R,
        n_streams=int(batch.stream_amount.shape[-1]),
        statics=grid_statics(chunk),
    )
    probs[i : i + len(chunk)] = np.asarray(out)
elapsed = time.time() - t0
grid = probs.reshape(len(expenses), len(eq_means))
total_path_months = len(configs) * N_PATHS * (W + 12 * R)
print(f"done in {elapsed:.1f}s  ({total_path_months / elapsed / 1e9:.2f}B "
      f"path-months/s)")
print("success% grid (rows: expenses 4k->14k, cols: equity mean 6%->14%):")
for e, row in zip(expenses, grid):
    print(f"  {e:7,.0f}: " + " ".join(f"{v:5.1f}" for v in row))

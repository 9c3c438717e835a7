"""Equity-inflation correlation sweep.

Sweeps rho over [-1, 1] on the default scenario with shared shocks (CRN over
the grid — identical raw draws, only the correlation mixing differs), one
vmapped device dispatch for the whole sweep.
"""
import os, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from monte_carlo_retirement_tpu.config import Config, load_config_from_json
from monte_carlo_retirement_tpu.engine.runner import enable_persistent_compilation_cache
from monte_carlo_retirement_tpu.engine.scenario_batch import run_scenario_batch

enable_persistent_compilation_cache()

raw = load_config_from_json(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config.json"))
raw["seed"] = 2026

rhos = np.linspace(-1.0, 1.0, 9)
configs = [Config(**{**raw, "equity_inflation_correlation": float(r)}) for r in rhos]
months = [240] * len(configs)

result = run_scenario_batch(configs, months, num_simulations=2000, seed=2026)
print(f"{'rho':>6} {'success %':>10} {'median final':>16}")
for r, p, m in zip(rhos, result.success_probability, result.median_final_balance):
    print(f"{r:6.2f} {p:10.2f} {m:16,.0f}")

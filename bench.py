"""Kernel timings on the GPU through the Engine's entry points.

    python bench.py

Workload: the default scenario retired at T=0 with retirement_years=50 —
exactly 600 simulated months per path — sized so paths survive the whole
horizon (no early-ruin shortcut flatters the number), at 1M paths:

  * probe — one ``Engine.probe`` call: a 16-candidate batch (the search's
    dispatch width) of success probabilities;
  * full  — one ``Engine.run(reduced=True)``: every percentile table,
    histogram and bin the dashboard needs, reduced on the device.

Each entry point is called once to compile, then timed REPEATS times; each
call returns host values, so a time covers the device work and the fetch.
Prints the card and one JSON line with every time (ms). Exits nonzero when
JAX finds no GPU. What the benchmark measures, and its cells, are not
settled yet (see PERF.md).
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_PATHS = 1_000_000
RETIREMENT_YEARS = 50  # 600 months
REPEATS = 5
SEED = 2026


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0]


def timed(fn) -> list:
    fn()  # compile (or load from the persistent cache)
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return times


def main() -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX runs on {dev.platform!r})")

    from monte_carlo_retirement_tpu.config import Config, load_config_from_json
    from monte_carlo_retirement_tpu.engine.runner import Engine

    raw = load_config_from_json(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.json")
    )
    # Retire at T=0 with a sustainable draw so the full 600 months simulate.
    raw.update(retirement_years=RETIREMENT_YEARS, initial_balance=1_500_000.0,
               monthly_expenses=4_000.0)
    engine = Engine(Config(**raw), dtype=jnp.float32, main_seed_override=SEED)
    backend = engine._resolve_probe_backend(None)
    months = [0] * 16

    probe_ms = timed(lambda: engine.probe(months, N_PATHS, stream="final"))
    full_ms = timed(lambda: engine.run(0, N_PATHS, stream="final",
                                       reduced=True))
    success = engine.run(0, N_PATHS, stream="final",
                         reduced=True).success_probability

    print(f"card: {card()}")
    print(json.dumps({
        "workload": "1M paths x 600 months, default scenario retired at T=0",
        "backend": backend,
        "probe16_ms": probe_ms,
        "probe16_median_ms": statistics.median(probe_ms),
        "full_ms": full_ms,
        "full_median_ms": statistics.median(full_ms),
        "success_rate_pct": success,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled:
  * CPU so closed-form expectations hold at 1e-9 tolerances (the GPU kernel
    runs float32; here it runs in interpret mode against the scan, and on
    the card through chip_smoke.py and the `gpu`-marked tests),
  * 8 fake devices so multi-device sharding tests exercise real collectives.

The platform is chosen via jax.config right after importing jax.
"""

import os
import sys

os.environ["MCRT_WARMUP"] = "0"  # no background compiles during tests
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from monte_carlo_retirement_tpu.config import Config

# ----------------------------------------------------------------------
# Executable map-count guard.
#
# A long pytest process compiles hundreds of CPU executables; every one
# holds several dozen mmap'd JIT sections, and the kernel's per-process map
# ceiling (vm.max_map_count, 65530 here) does NOT surface as a Python
# exception when XLA's native deserialization trips it — it SIGSEGVs (seen
# at jax compilation_cache.py:238 ~73% through the suite; the same test
# passes in isolation). docs/NOTES.md records the same ceiling killing the
# fuzz campaign with an LLVM "Cannot allocate memory". The guard drops
# compiled executables whenever the map count crosses a safety line —
# recompiles reload from the persistent cache in seconds.
# ----------------------------------------------------------------------

_MAP_LIMIT = int(os.environ.get("MCRT_TEST_MAP_LIMIT", "35000"))
_map_stats = {"max": 0, "clears": 0}


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as fh:
            return sum(1 for _ in fh)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _bound_executable_maps():
    yield
    n = _map_count()
    if n > _map_stats["max"]:
        _map_stats["max"] = n
    if n > _MAP_LIMIT:
        jax.clear_caches()
        import gc

        gc.collect()
        _map_stats["clears"] += 1


def pytest_terminal_summary(terminalreporter):
    terminalreporter.write_line(
        f"[map guard] peak /proc/self/maps lines: {_map_stats['max']} "
        f"(limit {_MAP_LIMIT}, ceiling 65530, clears: {_map_stats['clears']})"
    )


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skips unless JAX runs on a GPU. The check
    runs here, at test time, never while modules are collected."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/)")


def base_config_dict(**overrides) -> dict:
    data = {
        "scenario": "test",
        "initial_balance": 500_000.0,
        "monthly_contribution": 0.0,
        "contribution_growth_rate_annual": 0.0,
        "monthly_expenses": 2_000.0,
        "current_age": 40.0,
        "retirement_years": 10,
        "allocation_inv1_pct": 0.6,
        "inv1_returns_mean": 0.08,
        "inv1_returns_volatility": 0.15,
        "inv1_annual_tax_on_gains_rate": 0.0,
        "inv1_realized_gains_tax_rate": 0.0,
        "inv1_use_realized_gains_tax_system": False,
        "inv2_premium_over_inflation_mean": 0.02,
        "inv2_premium_over_inflation_volatility": 0.01,
        "inv2_annual_tax_on_gains_rate": 0.0,
        "inv2_realized_gains_tax_rate": 0.0,
        "inv2_use_realized_gains_tax_system": False,
        "inflation_rate_mean": 0.03,
        "inflation_rate_volatility": 0.01,
        "equity_inflation_correlation": 0.0,
        "num_simulations_main": 50,
        "num_simulations_search": 40,
        "target_probability": 80.0,
        "starting_working_months_search": 0,
        "seed": 42,
        "num_processes": 1,
        "other_income_streams": [],
    }
    data.update(overrides)
    return data


def make_config(**overrides) -> Config:
    return Config(**base_config_dict(**overrides))


# A zero-volatility, zero-tax override set for closed-form path tests.
DETERMINISTIC = dict(
    inflation_rate_mean=0.0,
    inflation_rate_volatility=0.0,
    inv1_returns_mean=0.0,
    inv1_returns_volatility=0.0,
    inv2_premium_over_inflation_mean=0.0,
    inv2_premium_over_inflation_volatility=0.0,
    inv1_use_realized_gains_tax_system=False,
    inv1_annual_tax_on_gains_rate=0.0,
    inv2_use_realized_gains_tax_system=False,
    inv2_annual_tax_on_gains_rate=0.0,
)


def binomial_sigma_pct(p_pct: float, n: int) -> float:
    """One-sigma Monte Carlo error (in percent) of a success probability
    estimated from n Bernoulli paths."""
    import math

    p = min(max(p_pct / 100.0, 1e-6), 1 - 1e-6)
    return math.sqrt(p * (1 - p) / n) * 100.0


def fake_success_frame(success_count: int, num_simulations: int):
    """The 7-tuple a fake engine seam returns: a summary DataFrame with the
    first ``success_count`` paths succeeding. Shared by every search test
    that injects a deterministic probability curve — the frame shape is the
    contract both searches read."""
    import pandas as pd

    flags = [True] * success_count + [False] * (num_simulations - success_count)
    df = pd.DataFrame(
        {
            "Start Balance": [100.0] * num_simulations,
            "Final Balance": [1.0 if f else 0.0 for f in flags],
            "Success": flags,
            "First Year Gross Withdrawal": [1.0] * num_simulations,
            "Inflation At Retirement": [1.0] * num_simulations,
        }
    )
    return df, None, None, None, None, None, None

"""Retirement Monte Carlo framework on JAX.

A ground-up JAX/XLA re-architecture of the retirement planning Monte Carlo
engine: the per-month lifecycle is a compiled `lax.scan`, paths are a
vectorised (and device-shardable) batch axis, working-month candidates batch
through `vmap`, and summary statistics reduce on-device.

Public surface:
  * Config / load_config_from_json — scenario schema (reference-compatible)
  * Engine — the compiled runner (probe / run / run_path)
  * RetirementMonteCarloSimulator — reference-compatible facade
  * find_minimum_working_months — batched search driver
"""

from .config import Config, ConfigurationError, OtherIncomeStreamConfig, load_config_from_json
from .constants import MONTHS_PER_YEAR, SMALL_EPSILON
from .models.retirement import SimParams, arithmetic_to_log_params
from .timing import (
    age_at_retirement_year,
    expected_trajectory_length,
    num_working_years,
    retirement_age,
    stream_payment_start_age,
    stream_payment_start_month_index,
    trajectory_time_points,
    years_from_t0_to_age,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "ConfigurationError",
    "OtherIncomeStreamConfig",
    "load_config_from_json",
    "MONTHS_PER_YEAR",
    "SMALL_EPSILON",
    "SimParams",
    "arithmetic_to_log_params",
    "retirement_age",
    "stream_payment_start_age",
    "stream_payment_start_month_index",
    "age_at_retirement_year",
    "years_from_t0_to_age",
    "num_working_years",
    "expected_trajectory_length",
    "trajectory_time_points",
]


def __getattr__(name):
    # Lazy imports keep `import monte_carlo_retirement_tpu` light (no JAX
    # device initialisation) until an engine is actually requested.
    if name == "Engine":
        from .engine.runner import Engine

        return Engine
    if name == "RetirementMonteCarloSimulator":
        from .engine.simulator import RetirementMonteCarloSimulator

        return RetirementMonteCarloSimulator
    if name == "median_first_year_withdrawal_rate":
        from .engine.summary import median_first_year_withdrawal_rate

        return median_first_year_withdrawal_rate
    if name == "find_minimum_working_months":
        from .search.driver import find_minimum_working_months

        return find_minimum_working_months
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Quantify the float32 semantic deviation (ops.tax.fail_rtol).

On the GPU the engine runs float32 with a 2e-5 *relative* funding-failure
tolerance, vs the reference's absolute 1e-6 in float64. This test bounds the
effect on the headline metric: success probability under f32 and f64 on the
two shipped scenarios must agree within the Monte Carlo noise of the paired
run sizes (the two dtypes draw different normals from the same threefry
stream widths, so the comparison is statistical).

On the card, chip_smoke.py compares the float32 kernel with the float32
scan path by path (PERF.md); this test pins the CI-scale bound so a regression in the f32 numerics
(a widened fail_rtol, a lost guard, an unstable reformulation) fails loudly.
"""

from __future__ import annotations

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_retirement_tpu.config import Config
from monte_carlo_retirement_tpu.engine.runner import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PATHS = 30_000


from tests.conftest import binomial_sigma_pct as _sigma_pct  # noqa: E402


@pytest.mark.parametrize("scenario,months", [("config.json", 233), ("jorge.json", 75)])
def test_f32_success_probability_within_mc_error_of_f64(scenario, months):
    data = json.load(open(os.path.join(REPO, scenario)))
    data["seed"] = 2026
    config = Config(**data)

    p = {}
    for dtype in (jnp.float64, jnp.float32):
        res = Engine(config, dtype=dtype).run(months, N_PATHS, stream="final")
        p[dtype] = float(np.mean(np.asarray(res.success))) * 100.0

    sigma = math.hypot(
        _sigma_pct(p[jnp.float64], N_PATHS), _sigma_pct(p[jnp.float32], N_PATHS)
    )
    tol = max(4.0 * sigma, 0.30)  # floor guards the p->1 binomial edge
    delta = abs(p[jnp.float64] - p[jnp.float32])
    assert delta <= tol, (
        f"{scenario}@{months}: f64 {p[jnp.float64]:.3f}% vs f32 "
        f"{p[jnp.float32]:.3f}% (delta {delta:.3f}%, tol {tol:.3f}%)"
    )
    # The deviation must also sit inside the project parity budget.
    assert delta <= 0.5

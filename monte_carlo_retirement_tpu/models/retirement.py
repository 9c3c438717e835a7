"""The retirement-planning model: stochastic processes + scenario parameters.

``SimParams`` is the traced parameter pytree handed to the compiled kernel.
Every scalar that a user can edit in the dashboard is a *traced* array leaf,
so changing ages, rates, taxes or amounts NEVER triggers recompilation; only
structural knobs (retirement_years, number of income streams, path counts)
are static.

Model (matching the reference's stochastic setup, backend/simulation.py:14-29,
452-474):
  * Asset 1 (equity-like): annual arithmetic mean/vol converted to lognormal
    params so that E[annual gross] = 1 + mean; monthly gross factor is
    exp(mu/12 + sigma/sqrt(12) * z).
  * Inflation: same lognormal construction; its unit shock is correlated with
    the equity shock by rho (exact at rho = +/-1).
  * Asset 2 (inflation-linked): gross factor = inflation gross x premium gross,
    with the premium drawn independently.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constants import MONTHS_PER_YEAR


def arithmetic_to_log_params(mean: float, vol: float) -> Tuple[float, float]:
    """Lognormal (mu, sigma) such that E[exp(mu + sigma Z)] = 1 + mean.

    vol == 0 degenerates to the deterministic drift log(1 + mean).
    """
    if mean <= -1.0:
        raise ValueError("Arithmetic mean must be greater than -100%.")
    if vol < 0:
        raise ValueError("Volatility cannot be negative.")
    if vol == 0:
        return math.log(1.0 + mean), 0.0
    gross = 1.0 + mean
    sigma = math.sqrt(math.log(1.0 + (vol * vol) / (gross * gross)))
    mu = math.log(gross) - 0.5 * sigma * sigma
    return mu, sigma


def prune_streams(config: Config) -> list:
    """Income streams that can actually pay: zero-amount or zero-duration
    streams contribute exactly nothing to the waterfall but would cost
    per-month kernel work. The SAME pruned list orders both the SimParams
    stream arrays and the Pallas ``Statics`` per-stream flags — a single
    predicate keeps their indices aligned. Host-side consumers (reference
    lines, payloads) read the Config, which keeps every stream."""
    return [
        s
        for s in config.other_income_streams
        if s.monthly_amount_today > 1e-6 and s.duration_years != 0
    ]


class SimParams(NamedTuple):
    """Traced scenario parameters (all leaves are jnp scalars / small arrays).

    Stream arrays all have shape (n_streams,); ``n_streams`` is static.
    ``months_from_t0`` is (start_at_age - current_age) * 12 computed host-side
    in float64 so the in-kernel payment start month
    ceil(months_from_t0 - W - eps) is exact at month boundaries.
    """

    initial_balance: jnp.ndarray
    monthly_contribution: jnp.ndarray
    contribution_growth: jnp.ndarray
    monthly_expenses: jnp.ndarray
    alloc1: jnp.ndarray  # target allocation of asset 1 in [0, 1] at T=0
    # Glide-path endpoint: the asset-1 target at retirement start (== alloc1
    # when the config sets no glide, so non-glide kernels can ignore it).
    # The per-month target interpolates linearly over the working months;
    # whether the interpolation code exists at all is compile-time
    # (Statics.glide / the scan kernel's static flag).
    alloc1_final: jnp.ndarray

    mu1: jnp.ndarray  # equity lognormal drift (annual)
    sigma1: jnp.ndarray
    mu_inf: jnp.ndarray  # inflation lognormal drift (annual)
    sigma_inf: jnp.ndarray
    mu_prem: jnp.ndarray  # asset-2 premium lognormal drift (annual)
    sigma_prem: jnp.ndarray
    rho: jnp.ndarray  # equity-inflation shock correlation

    ann_tax1: jnp.ndarray  # annual mark-to-market tax rates
    ann_tax2: jnp.ndarray
    real_tax1: jnp.ndarray  # realized-gains tax rates on sales
    real_tax2: jnp.ndarray
    use_real1: jnp.ndarray  # bool: asset taxed on realization (else annually)
    use_real2: jnp.ndarray

    # Spending guardrails (config.spending_guardrails; whether the rule
    # exists at all is compile-time Statics). Rule-off sentinel values keep
    # the multiplier pinned at 1 (upper=+inf, lower=0, adjustment=0,
    # floor=cap=1) so grid guards can detect structure mismatches by value.
    gr_upper: jnp.ndarray  # WR fraction above which spending cuts
    gr_lower: jnp.ndarray  # WR fraction below which spending raises
    gr_adjust: jnp.ndarray  # step per trigger, fraction
    gr_floor: jnp.ndarray  # multiplier floor, fraction of plan
    gr_cap: jnp.ndarray  # multiplier cap, fraction of plan

    # Market-crash jumps (config.market_crashes; rule existence is
    # compile-time — Statics.jumps / the scan kernel's static flag — so the
    # crash-free kernel draws nothing extra). Rule-off sentinels (p=0,
    # mu=sigma=beta=comp=0) make every jump term an exact no-op inside a
    # jumps-on executable, which grid guards use to detect live rows.
    jump_p: jnp.ndarray  # monthly crash probability (frequency / 12)
    jump_mu: jnp.ndarray  # log median jump factor, log(1 - drop/100) <= 0
    jump_sigma: jnp.ndarray  # log jump size dispersion
    jump_beta: jnp.ndarray  # asset-2 loading of the log jump
    jump_comp1: jnp.ndarray  # monthly log compensator, asset 1
    jump_comp2: jnp.ndarray  # monthly log compensator, asset 2

    # Longevity (config.longevity; rule existence is compile-time —
    # Statics.mortality / the scan kernel's static flag — so the fixed-
    # horizon kernel draws nothing extra). The kernel turns one uniform u
    # into a remaining lifetime at the retirement date:
    #   g_ret = mort_g0 - W / mort_b12
    #   t = mort_b12 * ln(1 - ln(u) * exp(g_ret))   [stable 2-branch form]
    #   d = min(t, mort_cap - W), clamped >= 0
    # Rule-off sentinels (g0=0, b12=0, cap=3e7) mark dead rows inside a
    # mortality-on executable: b12 > 0 is the live-row predicate the grid
    # guards and the kernels' d = +inf override both key on.
    mort_g0: jnp.ndarray  # (mode_age - current_age) / dispersion_years
    mort_b12: jnp.ndarray  # 12 * dispersion_years; 0 = no longevity rule
    mort_cap: jnp.ndarray  # (max_age - current_age) * 12, months from T=0

    stream_amount: jnp.ndarray  # (n_streams,) monthly amount in T=0 dollars
    stream_months_from_t0: jnp.ndarray  # (n_streams,) (start_age - age) * 12
    stream_duration_months: jnp.ndarray  # (n_streams,) +inf when indefinite
    stream_indexed: jnp.ndarray  # (n_streams,) bool
    stream_tax: jnp.ndarray  # (n_streams,)

    @property
    def n_streams(self) -> int:
        return int(self.stream_amount.shape[0])

    @staticmethod
    def from_config(config: Config, dtype=jnp.float32) -> "SimParams":
        """Build the traced parameter pytree from a validated Config."""
        host = SimParams.host_leaves(config, dtype=dtype)
        return SimParams(*(jnp.asarray(leaf) for leaf in host))

    @staticmethod
    def host_leaves(config: Config, dtype=jnp.float32) -> "SimParams":
        """The same parameter pytree with *numpy* leaves — no device ops.

        Scenario grids stack hundreds of these per request; building them
        host-side (and letting jit transfer the stacked result once at
        dispatch) avoids ~25 small device transfers per config."""
        mu1, s1 = arithmetic_to_log_params(
            config.inv1_returns_mean, config.inv1_returns_volatility
        )
        mui, si = arithmetic_to_log_params(
            config.inflation_rate_mean, config.inflation_rate_volatility
        )
        mup, sp = arithmetic_to_log_params(
            config.inv2_premium_over_inflation_mean,
            config.inv2_premium_over_inflation_volatility,
        )
        # Expense ratios (extension): an annual fee deducted inside the
        # fund is exactly a drift shift of log(1 - ratio) per year — the
        # kernels never see it. log1p(-0.0) == 0.0, so the fee-free default
        # leaves the drifts bit-identical.
        mu1 += math.log1p(-getattr(config, "inv1_expense_ratio_annual", 0.0))
        mup += math.log1p(-getattr(config, "inv2_expense_ratio_annual", 0.0))
        streams = prune_streams(config)
        n = len(streams)
        amounts = np.array([s.monthly_amount_today for s in streams], dtype=np.float64)
        from_t0 = np.array(
            [
                (float(s.start_at_age) - float(config.current_age)) * MONTHS_PER_YEAR
                for s in streams
            ],
            dtype=np.float64,
        )
        durations = np.array(
            [
                np.inf if s.duration_years is None
                else float(s.duration_years) * MONTHS_PER_YEAR
                for s in streams
            ],
            dtype=np.float64,
        )
        indexed = np.array([s.inflation_indexed for s in streams], dtype=bool)
        taxes = np.array([s.tax_rate for s in streams], dtype=np.float64)
        gr = getattr(config, "spending_guardrails", None)
        mc = getattr(config, "market_crashes", None)
        lg = getattr(config, "longevity", None)
        if lg is None:
            mg0, mb12, mcap = 0.0, 0.0, 3.0e7
        else:
            mg0 = (lg.mode_age - config.current_age) / lg.dispersion_years
            mb12 = MONTHS_PER_YEAR * lg.dispersion_years
            mcap = max(
                0.0, (lg.max_age - config.current_age) * MONTHS_PER_YEAR
            )
        if mc is None:
            jp = jmu = jsig = jbeta = jc1 = jc2 = 0.0
        else:
            # Exact compensators keep E[monthly gross] at the configured
            # mean: E[exp(a*J)] over Bernoulli(p) x Normal(mu, sigma) is
            # 1 - p + p * exp(a*mu + (a*sigma)^2 / 2). Computed in float64
            # host-side with the same expression the test oracle uses.
            jp = mc.frequency_per_year / MONTHS_PER_YEAR
            jmu = math.log(1.0 - mc.mean_drop_pct / 100.0)
            jsig = mc.size_volatility
            jbeta = mc.inv2_beta
            jc1 = math.log(
                (1.0 - jp) + jp * math.exp(jmu + 0.5 * jsig * jsig)
            )
            jc2 = math.log(
                (1.0 - jp)
                + jp * math.exp(jbeta * jmu + 0.5 * (jbeta * jsig) ** 2)
            )

        f = lambda x: np.asarray(x, dtype=np.dtype(dtype))
        return SimParams(
            initial_balance=f(config.initial_balance),
            monthly_contribution=f(config.monthly_contribution),
            contribution_growth=f(config.contribution_growth_rate_annual),
            monthly_expenses=f(config.monthly_expenses),
            alloc1=f(config.allocation_inv1_pct),
            alloc1_final=f(
                config.allocation_inv1_pct
                if getattr(config, "allocation_inv1_final_pct", None) is None
                else config.allocation_inv1_final_pct
            ),
            mu1=f(mu1),
            sigma1=f(s1),
            mu_inf=f(mui),
            sigma_inf=f(si),
            mu_prem=f(mup),
            sigma_prem=f(sp),
            rho=f(config.equity_inflation_correlation),
            ann_tax1=f(config.inv1_annual_tax_on_gains_rate),
            ann_tax2=f(config.inv2_annual_tax_on_gains_rate),
            real_tax1=f(config.inv1_realized_gains_tax_rate),
            real_tax2=f(config.inv2_realized_gains_tax_rate),
            use_real1=np.asarray(config.inv1_use_realized_gains_tax_system),
            use_real2=np.asarray(config.inv2_use_realized_gains_tax_system),
            gr_upper=f(np.inf if gr is None else gr.upper_wr_pct / 100.0),
            gr_lower=f(0.0 if gr is None else gr.lower_wr_pct / 100.0),
            gr_adjust=f(0.0 if gr is None else gr.adjustment_pct / 100.0),
            gr_floor=f(1.0 if gr is None else gr.floor_pct / 100.0),
            gr_cap=f(1.0 if gr is None else gr.cap_pct / 100.0),
            jump_p=f(jp),
            jump_mu=f(jmu),
            jump_sigma=f(jsig),
            jump_beta=f(jbeta),
            jump_comp1=f(jc1),
            jump_comp2=f(jc2),
            mort_g0=f(mg0),
            mort_b12=f(mb12),
            mort_cap=f(mcap),
            stream_amount=f(amounts.reshape(n)),
            stream_months_from_t0=f(from_t0.reshape(n)),
            stream_duration_months=f(durations.reshape(n)),
            stream_indexed=indexed.reshape(n),
            stream_tax=f(taxes.reshape(n)),
        )

"""The compiled path kernel: one `lax.scan` over absolute months.

Design notes (compiled re-architecture of the reference's per-path Python
loop, backend/simulation.py:476-950):

  * The time axis is a `lax.scan` with a small struct-of-arrays carry; the
    path axis is a plain vector dimension inside the step, so sharding the
    paths over a device mesh requires no kernel changes.
  * `working_months` (W) is a *traced* scalar. The month phase — accumulation
    vs retirement vs past-horizon — is a SCALAR predicate (identical for all
    paths), so it lowers to real `lax.cond` branches: each scan iteration
    executes only its phase's body, the annual-tax block runs only on
    absolute 12-month boundaries, and months past the horizon are free. One
    compilation still serves every candidate W; under the search's
    `vmap`-over-candidates the conds degrade gracefully to selects.
  * Per-path divergence (ruin, stream starts, capacity limits) stays
    branchless masking inside the phase bodies. Dead paths freeze their whole
    state, which reproduces the reference's early-`break` semantics exactly —
    including the yearly trajectory samples: a path that dies mid-year
    freezes its balance, so the regular year-end record captures the
    at-death value with no extra per-month writes.
  * Yearly trajectory / price-level / withdrawal-rate series are recorded by
    in-carry buffers updated with `dynamic_update_slice` at scalar slots on
    scalar-predicated months, instead of materialising (T, n_paths) scan
    outputs in HBM. Probe mode (`traj_len=0`) also drops every
    summary-only carry field (years-to-ruin, first-year withdrawals,
    retirement snapshot), halving HBM carry traffic for the search.

Event timeline inside one retirement month m (1-indexed absolute month):
  income & need -> ruin check A -> growth & inflation -> ruin check B ->
  capacity-limited pro-rata withdrawal -> rebalance -> annual tax at
  absolute 12-month boundaries -> final-period settle at the horizon end ->
  death resolution -> year-end records.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import MONTHS_PER_YEAR, SMALL_EPSILON
from ..models.retirement import SimParams
from ..ops.shocks import (
    gompertz_remaining_months,
    monthly_gross_factors,
    monthly_jump_draws,
    monthly_shocks,
    mortality_uniform,
)
from ..ops.tax import (
    apply_annual_gain_taxes,
    fail_rtol,
    rebalance,
    sale_tax_profile,
    withdraw_net_target,
)

EPS = SMALL_EPSILON


class PathOutputs(NamedTuple):
    """Per-path results of one batched simulation run.

    In probe mode (traj_len == 0) only ``success`` and ``final_balance`` are
    populated; the remaining fields are None.
    """

    success: jnp.ndarray  # (n,) bool — every month of spending was funded
    final_balance: jnp.ndarray  # (n,)
    start_balance: Optional[jnp.ndarray]  # (n,) balance on the retirement date
    years_to_ruin: Optional[jnp.ndarray]  # (n,) NaN when successful
    first_year_gross: Optional[jnp.ndarray]  # (n,) nominal gross withdrawals, year 0
    first_year_real_gross: Optional[jnp.ndarray]  # (n,) in retirement-date $
    inflation_at_retirement: Optional[jnp.ndarray]  # (n,) price level at retirement
    trajectory: Optional[jnp.ndarray]  # (n, L) yearly samples
    price_levels: Optional[jnp.ndarray]  # (n, L) price level at each sample
    withdrawal_rates: Optional[jnp.ndarray]  # (n, R) real % of start balance


class _Carry(NamedTuple):
    b1: jnp.ndarray
    c1: jnp.ndarray
    b2: jnp.ndarray
    c2: jnp.ndarray
    infl: jnp.ndarray
    g1acc: jnp.ndarray
    g2acc: jnp.ndarray
    alive: jnp.ndarray
    preret_failed: jnp.ndarray
    fixed_nom: Optional[jnp.ndarray]  # (n, S) frozen nominal stream amounts
    # Spending-guardrail multiplier (1.0 bit-exactly when no rule is set —
    # the sentinel parameter values make every update an exact no-op).
    spend: jnp.ndarray
    # Summary-tracking fields (None in probe mode):
    ytr: Optional[jnp.ndarray]
    start_bal: Optional[jnp.ndarray]
    infl_ret: Optional[jnp.ndarray]
    yg: Optional[jnp.ndarray]  # gross withdrawals, current retirement year
    yr: Optional[jnp.ndarray]  # same, deflated to retirement-date dollars
    fy_g: Optional[jnp.ndarray]
    fy_r: Optional[jnp.ndarray]
    traj: Optional[jnp.ndarray]
    price: Optional[jnp.ndarray]
    wr: Optional[jnp.ndarray]


@partial(
    jax.jit,
    static_argnames=(
        "n_paths",
        "t_scan",
        "retirement_years",
        "traj_len",
        "dtype",
        "antithetic",
        "jumps",
        "mortality",
    ),
)
def simulate_paths(
    params: SimParams,
    working_months: jnp.ndarray,
    stream_key: jax.Array,
    *,
    n_paths: int,
    t_scan: int,
    retirement_years: int,
    traj_len: int,
    dtype,
    antithetic: bool = False,
    jumps: bool = False,
    mortality: bool = False,
) -> PathOutputs:
    """Simulate ``n_paths`` full lifetimes with ``working_months`` (traced).

    ``t_scan`` must be >= working_months + 12 * retirement_years (months past
    the horizon are skipped by a scalar branch). ``traj_len`` == 0 selects
    probe mode: no trajectory buffers and no summary-only carry fields.
    ``antithetic`` selects paired sampling (ops/shocks.monthly_shocks): path
    2i+1 simulates under the negated shocks of path 2i — a variance-reduction
    extension the reference lacks; the month math is untouched.
    ``jumps`` compiles in the market-crash jump draws (config.market_crashes,
    another extension): the jump stream is a disjoint fold_in counter space,
    so the base shocks — and every result when the rule-off sentinel
    parameters are passed — are unchanged bit for bit.
    ``mortality`` compiles in the longevity rule (config.longevity, another
    extension): one extra uniform per path (again a disjoint counter space,
    so rule-off sentinel rows — mort_b12 == 0 — stay bit-identical) turns
    into a remaining lifetime at the retirement date; expired months force
    the spending need to zero while the estate keeps evolving, and
    withdrawal-rate observations exist only for fully-lived years.
    """
    p = params
    R = retirement_years
    W = jnp.asarray(working_months, dtype=jnp.int32)
    f = lambda x: jnp.asarray(x, dtype=dtype)
    zeros = jnp.zeros((n_paths,), dtype=dtype)
    track = traj_len > 0
    n_streams = p.n_streams
    frtol = fail_rtol(dtype)

    w_f = W.astype(dtype)
    full_wy = W // MONTHS_PER_YEAR
    partial_wy = (W % MONTHS_PER_YEAR != 0).astype(jnp.int32)
    t_end = W + MONTHS_PER_YEAR * R

    b1_0 = f(p.initial_balance * p.alloc1) * jnp.ones_like(zeros)
    b2_0 = f(p.initial_balance) - b1_0

    if n_streams:
        # First eligible retirement-month index per stream (scalar per stream;
        # months_from_t0 is precomputed host-side in float64).
        stream_start_m = jnp.maximum(
            0.0,
            jnp.ceil(jnp.maximum(0.0, f(p.stream_months_from_t0) - w_f) - EPS),
        )  # (S,)

    init = _Carry(
        b1=b1_0,
        c1=b1_0,
        b2=b2_0,
        c2=b2_0,
        infl=jnp.ones_like(zeros),
        g1acc=zeros,
        g2acc=zeros,
        alive=jnp.ones((n_paths,), dtype=bool),
        preret_failed=jnp.zeros((n_paths,), dtype=bool),
        fixed_nom=(
            jnp.full((n_paths, n_streams), -1.0, dtype=dtype) if n_streams else None
        ),
        spend=jnp.ones_like(zeros),
        ytr=jnp.full((n_paths,), jnp.nan, dtype=dtype) if track else None,
        start_bal=f(p.initial_balance) * jnp.ones_like(zeros) if track else None,
        infl_ret=jnp.ones_like(zeros) if track else None,
        yg=zeros if track else None,
        yr=zeros if track else None,
        fy_g=zeros if track else None,
        fy_r=zeros if track else None,
        traj=(
            jnp.zeros((n_paths, traj_len), dtype=dtype)
            .at[:, 0]
            .set(f(p.initial_balance))
            if track
            else None
        ),
        price=jnp.ones((n_paths, traj_len), dtype=dtype) if track else None,
        wr=jnp.full((n_paths, R), jnp.nan, dtype=dtype) if track else None,
    )

    def growth_factors(m):
        z_eq, z_inf, z_prem = monthly_shocks(
            stream_key, m, n_paths, f(p.rho), dtype, antithetic=antithetic
        )
        g1, gi, g2 = monthly_gross_factors(
            z_eq, z_inf, z_prem,
            f(p.mu1), f(p.sigma1), f(p.mu_inf), f(p.sigma_inf),
            f(p.mu_prem), f(p.sigma_prem),
        )
        if jumps:
            # Market-crash jump (config.market_crashes): compensated so the
            # mean gross return is unchanged — see MarketCrashConfig. The
            # p=0 sentinel makes J == 0 and comp == 0, so g * exp(0) == g
            # bit-exactly (grid rows without crashes stay exact inside a
            # jumps-on executable).
            u, z_j = monthly_jump_draws(
                stream_key, m, n_paths, dtype, antithetic=antithetic
            )
            j_log = jnp.where(
                u < f(p.jump_p), f(p.jump_mu) + f(p.jump_sigma) * z_j, f(0.0)
            )
            g1 = g1 * jnp.exp(j_log - f(p.jump_comp1))
            g2 = g2 * jnp.exp(f(p.jump_beta) * j_log - f(p.jump_comp2))
        return g1, gi, g2

    # Allocation target by month: linear glide alloc1 -> alloc1_final over
    # the working months, alloc1_final held through retirement (extension —
    # the reference's allocation is constant). Without a configured glide,
    # alloc1_final == alloc1 bit-exactly, so alloc_at reduces to
    # alloc1 + 0 * m == alloc1 and every result is unchanged.
    glide_scale = (f(p.alloc1_final) - f(p.alloc1)) / jnp.maximum(
        w_f, f(1.0)
    )

    def alloc_at(m):
        """Target for month m (valid during accumulation, m <= W)."""
        return f(p.alloc1) + glide_scale * m.astype(dtype)

    if mortality:
        # Longevity (config.longevity): remaining lifetime per path, in
        # retirement months. Loop-invariant (one uniform per path), so it
        # lives in the closure, not the carry.
        u_mort = mortality_uniform(
            stream_key, n_paths, dtype, antithetic=antithetic
        )
        d_mort = gompertz_remaining_months(
            u_mort, f(p.mort_g0), f(p.mort_b12), f(p.mort_cap), w_f, dtype
        )

    def annual_tax(c: _Carry, a1):
        return apply_annual_gain_taxes(
            c.b1, c.c1, c.b2, c.c2, c.g1acc, c.g2acc,
            a1,
            p.use_real1, f(p.real_tax1), f(p.ann_tax1),
            p.use_real2, f(p.real_tax2), f(p.ann_tax2),
        )

    def monthly_rebalance(b1, c1, b2, c2, a1):
        return rebalance(
            b1, c1, b2, c2, a1,
            p.use_real1, f(p.real_tax1), p.use_real2, f(p.real_tax2),
        )

    def write_col(buf, col, value, mask):
        """buf[:, col] = where(mask, value, buf[:, col]) at a scalar col."""
        zero = jnp.int32(0)
        col = jnp.clip(col, 0, buf.shape[1] - 1).astype(jnp.int32)
        old = lax.dynamic_slice(buf, (zero, col), (n_paths, 1))[:, 0]
        new = jnp.where(mask, value, old)
        return lax.dynamic_update_slice(buf, new[:, None], (zero, col))

    # ------------------------------------------------------------------
    # Accumulation month body (m <= W)
    # ------------------------------------------------------------------
    def accum_month(m, c: _Carry) -> _Carry:
        g1, gi, g2 = growth_factors(m)
        g1acc = c.g1acc + c.b1 * (g1 - 1.0)
        g2acc = c.g2acc + c.b2 * (g2 - 1.0)
        b1 = c.b1 * g1
        b2 = c.b2 * g2
        infl = c.infl * gi

        # Contribution grows at the start of each contribution year.
        contrib_years = ((m - 1) // MONTHS_PER_YEAR).astype(dtype)
        contrib = f(p.monthly_contribution) * jnp.power(
            1.0 + f(p.contribution_growth), contrib_years
        )
        al = alloc_at(m)
        ca1 = contrib * al
        ca2 = contrib - ca1
        b1, c1 = b1 + ca1, c.c1 + ca1
        b2, c2 = b2 + ca2, c.c2 + ca2

        b1, c1, b2, c2 = monthly_rebalance(b1, c1, b2, c2, al)

        mid = c._replace(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl,
                         g1acc=g1acc, g2acc=g2acc)

        # Annual mark-to-market taxes at absolute 12-month boundaries.
        def on_boundary(cc: _Carry) -> _Carry:
            tb1, tc1, tb2, tc2, tfail = annual_tax(cc, al)
            cc = cc._replace(
                b1=tb1, c1=tc1, b2=tb2, c2=tc2,
                g1acc=jnp.zeros_like(cc.g1acc), g2acc=jnp.zeros_like(cc.g2acc),
                preret_failed=cc.preret_failed | tfail,
            )
            if track:
                total = cc.b1 + cc.b2
                ones = jnp.ones((n_paths,), dtype=bool)
                cc = cc._replace(
                    traj=write_col(cc.traj, m // MONTHS_PER_YEAR, total, ones),
                    price=write_col(cc.price, m // MONTHS_PER_YEAR, cc.infl, ones),
                )
            return cc

        return lax.cond(
            m % MONTHS_PER_YEAR == 0, on_boundary, lambda cc: cc, mid
        )

    # ------------------------------------------------------------------
    # Retirement-date snapshot — straight-line, once, between the phases
    # (+ partial-year trajectory sample).
    # ------------------------------------------------------------------
    def at_retirement(cc: _Carry) -> _Carry:
        kill = cc.preret_failed
        cc = cc._replace(alive=cc.alive & ~kill)
        if track:
            cc = cc._replace(
                start_bal=cc.b1 + cc.b2,
                infl_ret=cc.infl,
                ytr=jnp.where(kill, 0.0, cc.ytr),
            )
            def partial_sample(c2_: _Carry) -> _Carry:
                ones = jnp.ones((n_paths,), dtype=bool)
                slot = full_wy + 1
                return c2_._replace(
                    traj=write_col(c2_.traj, slot, c2_.b1 + c2_.b2, ones),
                    price=write_col(c2_.price, slot, c2_.infl, ones),
                )
            cc = lax.cond(
                partial_wy == 1, partial_sample, lambda x: x, cc
            )
        return cc

    # ------------------------------------------------------------------
    # Retirement month body (W < m <= t_end)
    # ------------------------------------------------------------------
    def ret_month(m, c: _Carry) -> _Carry:
        k = m - W  # retirement month, 1-indexed
        ret_idx = k - 1
        alive0 = c.alive

        # New retirement year: reset the per-year withdrawal accumulators.
        if track:
            new_year = (ret_idx % MONTHS_PER_YEAR) == 0
            yg = jnp.where(new_year, 0.0, c.yg)
            yr = jnp.where(new_year, 0.0, c.yr)

        # --- other income & net spending need
        price0 = c.infl
        # Spending-guardrail multiplier (extension; see config.
        # SpendingGuardrailsConfig). At each year start after the first,
        # the planned WR against the balance entering the month moves the
        # multiplier. Without a configured rule the sentinel leaves
        # (upper=inf, lower=0, adjust=0, floor=cap=1) make every branch an
        # exact no-op and the multiplier stays 1.0 bit for bit.
        smult = c.spend
        planned = 12.0 * f(p.monthly_expenses) * smult * price0
        wr_now = planned / jnp.maximum(c.b1 + c.b2, EPS)
        s_new = jnp.where(
            wr_now > f(p.gr_upper), smult * (1.0 - f(p.gr_adjust)), smult
        )
        s_new = jnp.where(
            wr_now < f(p.gr_lower), smult * (1.0 + f(p.gr_adjust)), s_new
        )
        s_new = jnp.minimum(jnp.maximum(s_new, f(p.gr_floor)), f(p.gr_cap))
        at_year_start = ((ret_idx % MONTHS_PER_YEAR) == 0) & (ret_idx > 0)
        smult = jnp.where(at_year_start & c.alive, s_new, smult)
        expenses = f(p.monthly_expenses) * smult * price0
        fixed_nom = c.fixed_nom
        if n_streams:
            ret_idx_f = ret_idx.astype(dtype)
            active_s = (ret_idx_f >= stream_start_m) & (
                ret_idx_f < stream_start_m + f(p.stream_duration_months)
            )  # (S,)
            starts_now = active_s & (ret_idx_f == stream_start_m)
            fixed_nom = jnp.where(
                starts_now[None, :] & (fixed_nom < 0),
                f(p.stream_amount)[None, :] * price0[:, None],
                fixed_nom,
            )
            nominal = jnp.where(
                p.stream_indexed[None, :],
                f(p.stream_amount)[None, :] * price0[:, None],
                fixed_nom,
            )
            net_income = jnp.sum(
                jnp.where(
                    active_s[None, :],
                    nominal * (1.0 - f(p.stream_tax))[None, :],
                    0.0,
                ),
                axis=1,
            )
        else:
            net_income = zeros
        need = jnp.maximum(0.0, expenses - net_income)
        if mortality:
            # Spending (and the income that offsets it) ends with the
            # owner; zero need means no withdrawal and no possible ruin.
            # The estate keeps evolving below — growth, rebalancing and
            # annual taxes all still run — so the final balance is the
            # bequest at the plan horizon.
            living = ret_idx.astype(dtype) < d_mort
            need = jnp.where(living, need, 0.0)

        # --- ruin check A: broke before the month begins
        total0 = c.b1 + c.b2
        dies_a = alive0 & (total0 <= EPS) & (need > EPS)

        # --- market growth & inflation (dead/ruined paths freeze)
        g1, gi, g2 = growth_factors(m)
        gmask = alive0 & ~dies_a
        g1acc = c.g1acc + jnp.where(gmask, c.b1 * (g1 - 1.0), 0.0)
        g2acc = c.g2acc + jnp.where(gmask, c.b2 * (g2 - 1.0), 0.0)
        b1 = jnp.where(gmask, c.b1 * g1, c.b1)
        b2 = jnp.where(gmask, c.b2 * g2, c.b2)
        infl = jnp.where(gmask, c.infl * gi, c.infl)
        c1, c2 = c.c1, c.c2

        # --- ruin check B: growth alone cannot fund the month
        total1 = b1 + b2
        dies_b = gmask & (total1 <= EPS) & (need > EPS)
        b1 = jnp.where(dies_b, jnp.maximum(0.0, b1), b1)
        b2 = jnp.where(dies_b, jnp.maximum(0.0, b2), b2)

        # --- capacity-limited withdrawal, split pro-rata by net capacity
        wmask = gmask & ~dies_b
        eff1, nc1 = sale_tax_profile(b1, c1, p.use_real1, f(p.real_tax1))
        eff2, nc2 = sale_tax_profile(b2, c2, p.use_real2, f(p.real_tax2))
        tnc = nc1 + nc2
        target = jnp.maximum(0.0, jnp.minimum(need, tnc))
        # Funding failures use a dtype-relative slack (ops.tax.fail_rtol);
        # in float64 this is the reference's absolute epsilon.
        ftol = EPS + frtol * (need + total1)
        fail_cap = wmask & (need > EPS) & (target < need - ftol)
        prop1 = jnp.where(
            tnc > EPS, nc1 / jnp.where(tnc > EPS, tnc, 1.0), f(p.alloc1)
        )

        wb1, wc1, gw1, nw1 = withdraw_net_target(
            b1, c1, target * prop1, p.use_real1, f(p.real_tax1), eff_tax=eff1
        )
        wb2, wc2, gw2, nw2 = withdraw_net_target(
            b2, c2, target * (1.0 - prop1), p.use_real2, f(p.real_tax2),
            eff_tax=eff2,
        )
        b1 = jnp.where(wmask, wb1, b1)
        c1 = jnp.where(wmask, wc1, c1)
        b2 = jnp.where(wmask, wb2, b2)
        c2 = jnp.where(wmask, wc2, c2)
        if track:
            gw = jnp.where(wmask, gw1 + gw2, 0.0)
            yg = yg + gw
            yr = yr + gw * c.infl_ret / jnp.maximum(price0, EPS)
        fail_net = wmask & (need > EPS) & (nw1 + nw2 < need - ftol)

        # --- monthly rebalance (runs even in a capacity-failure month;
        #     ruin-check deaths skip it)
        rb1, rc1, rb2, rc2 = monthly_rebalance(b1, c1, b2, c2, f(p.alloc1_final))
        b1 = jnp.where(wmask, rb1, b1)
        c1 = jnp.where(wmask, rc1, c1)
        b2 = jnp.where(wmask, rb2, b2)
        c2 = jnp.where(wmask, rc2, c2)

        mid = c._replace(b1=b1, c1=c1, b2=b2, c2=c2, infl=infl,
                         g1acc=g1acc, g2acc=g2acc, fixed_nom=fixed_nom,
                         spend=smult)

        # --- annual taxes. Two mutually exclusive scalar triggers share ONE
        # instantiation of the tax subgraph (graph size = compile time):
        #   * absolute 12-month boundary — skipped by paths failing this
        #     month; resets the gain accumulators; a failure is a death.
        #   * horizon end with a trailing partial tax period (settle) — the
        #     reference's terminal-wealth settlement; no accumulator reset.
        tmask_ok = wmask & ~fail_cap & ~fail_net
        is_boundary = (m % MONTHS_PER_YEAR) == 0
        is_settle = (m == t_end) & ((W % MONTHS_PER_YEAR) != 0)

        def apply_tax(cc: _Carry):
            tb1, tc1, tb2, tc2, tfail = annual_tax(cc, f(p.alloc1_final))
            dies_pre = dies_a | dies_b | fail_cap | fail_net
            mask = jnp.where(is_boundary, tmask_ok, alive0 & ~dies_pre)
            cc = cc._replace(
                b1=jnp.where(mask, tb1, cc.b1),
                c1=jnp.where(mask, tc1, cc.c1),
                b2=jnp.where(mask, tb2, cc.b2),
                c2=jnp.where(mask, tc2, cc.c2),
                g1acc=jnp.where(mask & is_boundary, 0.0, cc.g1acc),
                g2acc=jnp.where(mask & is_boundary, 0.0, cc.g2acc),
            )
            fail = mask & tfail
            return cc, fail & is_boundary, fail & is_settle

        no_fail = jnp.zeros((n_paths,), dtype=bool)
        mid, ret_tax_fail, settle_fail = lax.cond(
            is_boundary | is_settle,
            apply_tax,
            lambda cc: (cc, no_fail, no_fail),
            mid,
        )

        dies_regular = dies_a | dies_b | fail_cap | fail_net | ret_tax_fail

        # --- death resolution
        alive = alive0 & ~dies_regular & ~settle_fail
        mid = mid._replace(alive=alive)
        if track:
            ytr = mid.ytr
            ytr = jnp.where(
                dies_regular,
                (ret_idx.astype(dtype) + 1.0) / MONTHS_PER_YEAR,
                ytr,
            )
            ytr = jnp.where(settle_fail, jnp.asarray(R, dtype=dtype), ytr)
            # First-retirement-year capture: at death in year 0 or its end.
            year0 = (ret_idx // MONTHS_PER_YEAR) == 0
            year_end = (k % MONTHS_PER_YEAR) == 0
            cap_fy = alive0 & year0 & (dies_regular | year_end)
            mid = mid._replace(
                ytr=ytr,
                yg=yg,
                yr=yr,
                fy_g=jnp.where(cap_fy, yg, mid.fy_g),
                fy_r=jnp.where(cap_fy, yr, mid.fy_r),
            )

            # --- year-end records (scalar predicate). Dead paths freeze, so
            # the year-end value IS the at-death balance for deaths this year
            # and 0-padding (with masked write skipped) for older deaths.
            def record(cc: _Carry) -> _Carry:
                slot = full_wy + partial_wy + k // MONTHS_PER_YEAR
                y = k // MONTHS_PER_YEAR - 1
                total2 = cc.b1 + cc.b2
                # Death month (1-indexed within retirement) = round(ytr * 12);
                # rounding guards the /12*12 float round-trip. NaN (alive or
                # pre-retirement failure) compares false on both sides.
                death_k = jnp.round(cc.ytr * MONTHS_PER_YEAR)
                died_this_year = (death_k > y * MONTHS_PER_YEAR + 0.5) & (
                    death_k < k.astype(dtype) + 0.5
                )
                write_mask = cc.alive | died_this_year
                value = jnp.where(cc.alive, total2, jnp.maximum(0.0, total2))
                # Price levels write unconditionally: a dead path's infl is
                # frozen at death, so later slots carry the at-death price
                # level forward — the reference's padding semantics
                # (backend/simulation.py:902-937).
                ones = jnp.ones((n_paths,), dtype=bool)
                cc = cc._replace(
                    traj=write_col(cc.traj, slot, value, write_mask),
                    price=write_col(cc.price, slot, cc.infl, ones),
                )
                wr_mask = alive0 & ~dies_regular  # completed the whole year
                if mortality:
                    # A WR observation exists only for fully-lived years
                    # (at year end, ret_idx is the year's last month, so
                    # `living` == the whole year was lived). Later years
                    # stay NaN, mirroring the reference's post-ruin years.
                    wr_mask = wr_mask & living
                wr_value = jnp.where(
                    cc.start_bal > EPS,
                    cc.yr / jnp.maximum(cc.start_bal, EPS) * 100.0,
                    0.0,
                )
                cc = cc._replace(wr=write_col(cc.wr, y, wr_value, wr_mask))
                return cc

            mid = lax.cond(
                (k % MONTHS_PER_YEAR) == 0, record, lambda cc: cc, mid
            )
        return mid

    # ------------------------------------------------------------------
    # Two phase scans instead of one scan with a per-month phase dispatch:
    # the accumulation scan covers the bucketed working horizon (months past
    # a candidate's own W pass through a guard), the retirement scan is
    # exactly 12R months with no guard at all, and the retirement snapshot
    # runs straight-line between them. Per-month arithmetic is identical to
    # the single-scan form (bit-exact under f64), but each scan body carries
    # one phase, which roughly halves the executable and removes dead work
    # from vmapped candidate probes.
    # ------------------------------------------------------------------
    t_acc = t_scan - MONTHS_PER_YEAR * R  # static; >= any candidate's W

    def acc_step(carry: _Carry, m):
        return lax.cond(
            m <= W, lambda c: accum_month(m, c), lambda c: c, carry
        ), None

    def ret_step(carry: _Carry, k):
        return ret_month(W + k, carry), None

    state = init
    if t_acc > 0:
        state, _ = lax.scan(
            acc_step, state, jnp.arange(1, t_acc + 1, dtype=jnp.int32)
        )
    state = at_retirement(state)
    final, _ = lax.scan(
        ret_step, state,
        jnp.arange(1, MONTHS_PER_YEAR * R + 1, dtype=jnp.int32),
    )

    return PathOutputs(
        success=final.alive,
        final_balance=jnp.maximum(0.0, final.b1 + final.b2),
        start_balance=final.start_bal,
        years_to_ruin=final.ytr,
        first_year_gross=final.fy_g,
        first_year_real_gross=final.fy_r,
        inflation_at_retirement=final.infl_ret,
        trajectory=final.traj,
        price_levels=final.price,
        withdrawal_rates=final.wr,
    )

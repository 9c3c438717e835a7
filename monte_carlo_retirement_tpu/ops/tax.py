"""Branchless, vectorised tax & portfolio kernels.

These are the four algebraic sub-kernels at the bottom of every simulated
month. Each is a pure function on (batched) balances — no Python branching on
data, so they vmap/scan/shard cleanly and fuse into the month step under XLA.

Behavioral contracts (verified by closed-form unit tests in
tests/test_tax_ops.py) mirror the reference engine:
  * withdraw_net_target     <- backend/simulation.py:201-254
  * net_liquidation_value   <- backend/simulation.py:256-272
  * rebalance               <- backend/simulation.py:274-359
  * apply_annual_gain_taxes <- backend/simulation.py:361-450
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..constants import SMALL_EPSILON

EPS = SMALL_EPSILON


def fail_rtol(dtype) -> float:
    """Relative slack for funding-failure comparisons.

    The reference compares "cash delivered < cash needed - 1e-6" in float64.
    Under float32 the arithmetic chain (basis fractions scale with *balance*,
    not with the withdrawal) carries rounding error of hundreds of balance
    ulps, which dwarfs an absolute 1e-6 when balances run into the millions.
    In float32 a failure must therefore exceed a relative margin of the
    quantities involved; in float64 the margin is zero and the semantics are
    bit-comparable to the reference.
    """
    return 2e-5 if jnp.dtype(dtype) == jnp.dtype(jnp.float32) else 0.0


def _safe(x: jnp.ndarray) -> jnp.ndarray:
    """A strictly positive denominator stand-in for balances near zero."""
    return jnp.where(x > EPS, x, jnp.ones_like(x))


def sale_tax_profile(
    bal: jnp.ndarray,
    basis: jnp.ndarray,
    use_realized_tax: jnp.ndarray,
    tax_rate: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-asset quantities shared by capacity checks and withdrawals:
    the effective tax per gross dollar sold and the full-liquidation net
    capacity (identical to ``net_liquidation_value``)."""
    gain = jnp.maximum(0.0, bal - basis)
    eff_tax = jnp.where(use_realized_tax, (gain / _safe(bal)) * tax_rate, 0.0)
    tax = jnp.where(use_realized_tax, gain * tax_rate, 0.0)
    capacity = jnp.where(bal <= EPS, 0.0, jnp.maximum(0.0, bal - tax))
    return eff_tax, capacity


def withdraw_net_target(
    bal: jnp.ndarray,
    basis: jnp.ndarray,
    net_target: jnp.ndarray,
    use_realized_tax: jnp.ndarray,
    tax_rate: jnp.ndarray,
    eff_tax=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sell just enough of one asset to deliver ``net_target`` cash after
    realized-gains tax, under average-cost basis accounting.

    Basis removed is proportional to the *fraction of shares sold* — after a
    loss it may legitimately exceed sale proceeds. The sale is capped at the
    full balance, so the net cash delivered can fall short of the target.
    ``eff_tax`` (from ``sale_tax_profile``) may be passed to share the
    gain-fraction computation with a preceding capacity check.

    Returns (new_balance, new_basis, gross_withdrawal, net_cash_delivered).
    """
    active = (bal > EPS) & (net_target > 0)

    if eff_tax is None:
        gain_frac = jnp.maximum(0.0, bal - basis) / _safe(bal)
        eff_tax = jnp.where(use_realized_tax, gain_frac * tax_rate, 0.0)
    net_frac = jnp.maximum(EPS, 1.0 - eff_tax)
    gross = jnp.minimum(net_target / net_frac, bal)

    # gross <= bal by construction, so the sold fraction needs no clamping
    # and basis * frac_sold <= basis (basis >= 0 throughout).
    frac_sold = gross / _safe(bal)
    basis_removed = basis * frac_sold
    taxable_gain = jnp.maximum(0.0, gross - basis_removed)
    tax_paid = jnp.where(use_realized_tax, taxable_gain * tax_rate, 0.0)
    net_cash = jnp.maximum(0.0, gross - tax_paid)

    new_bal = jnp.maximum(0.0, bal - gross)
    new_basis = jnp.maximum(0.0, basis - basis_removed)
    emptied = new_bal <= EPS
    new_bal = jnp.where(emptied, 0.0, new_bal)
    new_basis = jnp.where(emptied, 0.0, new_basis)

    idle_bal = jnp.maximum(0.0, bal)
    idle_basis = jnp.maximum(0.0, basis)
    return (
        jnp.where(active, new_bal, idle_bal),
        jnp.where(active, new_basis, idle_basis),
        jnp.where(active, gross, 0.0),
        jnp.where(active, net_cash, 0.0),
    )


def net_liquidation_value(
    bal: jnp.ndarray,
    basis: jnp.ndarray,
    use_realized_tax: jnp.ndarray,
    tax_rate: jnp.ndarray,
) -> jnp.ndarray:
    """Cash obtained by fully liquidating an asset and paying gains tax.

    This defines both withdrawal *capacity* and the ruin test; the value is
    ``sale_tax_profile``'s capacity output, delegated so the definition is
    single-sourced.
    """
    return sale_tax_profile(bal, basis, use_realized_tax, tax_rate)[1]


def rebalance(
    bal1: jnp.ndarray,
    basis1: jnp.ndarray,
    bal2: jnp.ndarray,
    basis2: jnp.ndarray,
    alloc1: jnp.ndarray,
    use_real1: jnp.ndarray,
    rate1: jnp.ndarray,
    use_real2: jnp.ndarray,
    rate2: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Tax-aware restore of the target allocation between the two assets.

    Because the sale tax shrinks the portfolio, the gross sale x of the
    over-weight asset solves  bal_s - x = alloc_s * (total - tax_per_$ * x),
    making the *post-tax* weights exact. The buyer's basis increases by the
    net purchase only. Both drift directions are computed branchlessly by
    selecting the over-weight side.
    """
    total = bal1 + bal2
    drift1 = bal1 - total * alloc1
    noop = (total <= EPS) | (jnp.abs(drift1) <= EPS)
    sell1 = drift1 > 0

    alloc2 = 1.0 - alloc1
    # Gather the selling side s and the buying side b. The realized-tax flag
    # is applied as a 0/1 multiplier (not a boolean select); multiplying by
    # exactly 0.0/1.0 is bit-identical.
    bal_s = jnp.where(sell1, bal1, bal2)
    basis_s = jnp.where(sell1, basis1, basis2)
    flag1 = jnp.asarray(use_real1, bal1.dtype)
    flag2 = jnp.asarray(use_real2, bal1.dtype)
    taxed_rate_s = jnp.where(sell1, rate1 * flag1, rate2 * flag2)
    alloc_s = jnp.where(sell1, alloc1, alloc2)
    drift_s = jnp.where(sell1, drift1, bal2 - total * alloc2)

    gain_frac = jnp.maximum(0.0, bal_s - basis_s) / _safe(bal_s)
    tax_per_dollar = gain_frac * taxed_rate_s
    denom = jnp.maximum(EPS, 1.0 - alloc_s * tax_per_dollar)
    gross_sale = jnp.minimum(bal_s, drift_s / denom)

    frac_sold = gross_sale / _safe(bal_s)
    basis_removed = jnp.minimum(basis_s, basis_s * frac_sold)
    taxable_gain = jnp.maximum(0.0, gross_sale - basis_removed)
    tax_paid = taxable_gain * taxed_rate_s
    net_purchase = gross_sale - tax_paid

    new_s_bal = jnp.maximum(0.0, bal_s - gross_sale)
    new_s_basis = jnp.maximum(0.0, basis_s - basis_removed)
    bal_b = jnp.where(sell1, bal2, bal1) + net_purchase
    basis_b = jnp.where(sell1, basis2, basis1) + net_purchase

    out_b1 = jnp.where(sell1, new_s_bal, bal_b)
    out_c1 = jnp.where(sell1, new_s_basis, basis_b)
    out_b2 = jnp.where(sell1, bal_b, new_s_bal)
    out_c2 = jnp.where(sell1, basis_b, new_s_basis)

    z1 = out_b1 <= EPS
    z2 = out_b2 <= EPS
    out_b1 = jnp.where(z1, 0.0, out_b1)
    out_c1 = jnp.where(z1, 0.0, out_c1)
    out_b2 = jnp.where(z2, 0.0, out_b2)
    out_c2 = jnp.where(z2, 0.0, out_c2)

    return (
        jnp.where(noop, bal1, out_b1),
        jnp.where(noop, basis1, out_c1),
        jnp.where(noop, bal2, out_b2),
        jnp.where(noop, basis2, out_c2),
    )


def apply_annual_gain_taxes(
    bal1: jnp.ndarray,
    basis1: jnp.ndarray,
    bal2: jnp.ndarray,
    basis2: jnp.ndarray,
    gain1: jnp.ndarray,
    gain2: jnp.ndarray,
    alloc1: jnp.ndarray,
    use_real1: jnp.ndarray,
    rate_real1: jnp.ndarray,
    rate_ann1: jnp.ndarray,
    use_real2: jnp.ndarray,
    rate_real2: jnp.ndarray,
    rate_ann2: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Settle one completed mark-to-market tax period.

    ``gain*`` are monthly-accrued *market* P&L (contributions, withdrawals and
    rebalance transfers excluded). The combined bill is drawn from the whole
    portfolio pro-rata by net liquidation capacity — paying it from a
    realized-tax asset can itself trigger extra gross sales. Ends with an
    unconditional rebalance. Returns (b1, c1, b2, c2, tax_failed).
    """
    due1 = jnp.where(use_real1, 0.0, jnp.maximum(0.0, gain1) * rate_ann1)
    due2 = jnp.where(use_real2, 0.0, jnp.maximum(0.0, gain2) * rate_ann2)
    total_due = due1 + due2

    eff1, cap1 = sale_tax_profile(bal1, basis1, use_real1, rate_real1)
    eff2, cap2 = sale_tax_profile(bal2, basis2, use_real2, rate_real2)
    total_cap = cap1 + cap2
    payment = jnp.minimum(total_due, total_cap)
    tol = EPS + fail_rtol(bal1.dtype) * (total_due + total_cap)
    tax_failed = payment < total_due - tol

    do_pay = (total_cap > EPS) & (payment > 0)
    share1 = cap1 / _safe(total_cap)
    share2 = 1.0 - share1

    nb1, nc1, _, net1 = withdraw_net_target(
        bal1, basis1, payment * share1, use_real1, rate_real1, eff_tax=eff1
    )
    nb2, nc2, _, net2 = withdraw_net_target(
        bal2, basis2, payment * share2, use_real2, rate_real2, eff_tax=eff2
    )
    bal1 = jnp.where(do_pay, nb1, bal1)
    basis1 = jnp.where(do_pay, nc1, basis1)
    bal2 = jnp.where(do_pay, nb2, bal2)
    basis2 = jnp.where(do_pay, nc2, basis2)
    tax_failed = tax_failed | (do_pay & (net1 + net2 < total_due - tol))

    bal1, basis1, bal2, basis2 = rebalance(
        bal1, basis1, bal2, basis2, alloc1, use_real1, rate_real1, use_real2, rate_real2
    )
    return bal1, basis1, bal2, basis2, tax_failed

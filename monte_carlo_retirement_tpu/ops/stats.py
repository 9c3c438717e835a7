"""On-device summary reductions over the path axis.

Where the reference hauled every path back to the host and reduced with
pandas (backend/simulation.py:1012-1118), these reductions run inside the
same XLA program as the simulation: under a sharded paths axis they lower to
collectives, and only the small percentile tables cross back to the host.

Every percentile is computed with the sort-free selection engine
(ops/quantiles.py) — exact np.percentile/nanpercentile semantics at a
fraction of the device time of per-column sorts — and the serving summary
additionally reduces the dashboard's histogram payloads (60-bin successful
final balances, integer-year ruin bins) on device, so a 1M-path serving
response fetches kilobytes instead of the per-path arrays
(reference response builder: backend/server.py:416-565).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import (
    FINAL_BALANCE_PERCENTILES,
    SMALL_EPSILON,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from .quantiles import (
    exact_quantiles,
    exact_quantiles_parts,
    quantiles_percol,
    upper_median,
)

EPS = SMALL_EPSILON

# Bin count of the dashboard's successful-final-balance histogram
# (reference frontend HistogramChart.jsx computes 60 client-side).
FINAL_HIST_BINS = 60


class RunSummary(NamedTuple):
    """Reduced statistics for one full simulation batch (device arrays)."""

    success_probability: jnp.ndarray  # scalar, percent
    median_start_balance: jnp.ndarray  # scalar
    median_final_successful: jnp.ndarray  # scalar (NaN if no successes)
    swr: jnp.ndarray  # scalar, percent (NaN if no valid start balances)
    final_balance_percentiles: jnp.ndarray  # (9,)
    trajectory_percentiles: jnp.ndarray  # (7, L)
    real_trajectory_percentiles: jnp.ndarray  # (7, L)
    sample_trajectories: jnp.ndarray  # (num_samples, L)
    sample_real_trajectories: jnp.ndarray  # (num_samples, L)
    wr_percentiles: jnp.ndarray  # (5, R)
    wr_observation_counts: jnp.ndarray  # (R,)


class ServingBins(NamedTuple):
    """Pre-binned dashboard aggregates, reduced on device.

    Semantics mirror hosts/payload.py's numpy binning exactly (same
    truncation, clamping and width rules), so the capped serving path can
    skip fetching per-path arrays entirely.
    """

    success_count: jnp.ndarray  # scalar int
    finals_min_successful: jnp.ndarray  # scalar (+inf if no successes)
    finals_max_successful: jnp.ndarray  # scalar (-inf if no successes)
    finals_hist_counts: jnp.ndarray  # (FINAL_HIST_BINS,) int
    finals_median_successful: jnp.ndarray  # scalar, sorted[n//2] (NaN if none)
    ruin_counts: jnp.ndarray  # (R+1,) int — integer-year bins incl. == R
    ruin_max: jnp.ndarray  # scalar (-inf if no failures)
    failure_count: jnp.ndarray  # scalar int — failed paths with finite ruin


def vector_summary(success, final, start, first_year_real_gross):
    """Headline scalars + final-balance percentiles from per-path vectors.
    Returns (success_prob, median_start, median_final_successful, swr,
    final_pcts).

    The three medians and the 9-point final-balance ladder reduce in ONE
    per-column quantile search (four columns, heterogeneous fraction rows)
    instead of four separate bisection loops — same np.percentile /
    nanpercentile values, a quarter of the loop passes."""
    success_prob = jnp.mean(success.astype(jnp.float32)) * 100.0
    success = success.astype(bool)
    start_ok = start > EPS
    rates = first_year_real_gross / jnp.maximum(start, EPS) * 100.0
    cols = jnp.stack([start, final, rates, final], axis=1)
    all_ok = jnp.ones_like(start_ok)
    valid = jnp.stack([all_ok, success, start_ok, all_ok], axis=1)
    fq = jnp.asarray(FINAL_BALANCE_PERCENTILES, dtype=final.dtype)
    half = jnp.full(fq.shape, 0.5, dtype=final.dtype)  # repeat-padded rows
    qmat = jnp.stack([half, half, half, fq], axis=0)
    tbl = quantiles_percol(cols, qmat, valid=valid)
    return success_prob, tbl[0, 0], tbl[1, 0], tbl[2, 0], tbl[3, :]


def series_summary(traj, price, wr, sample_idx):
    """Per-year percentile tables + sample paths from the (n, L)/(n, R)
    series. Returns (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
    wr_counts)."""
    real = jnp.where(price > EPS, traj / jnp.maximum(price, EPS), 0.0)
    traj_q = jnp.asarray(TRAJECTORY_PERCENTILES)
    # Nominal + real tables share one bisection loop (half the search
    # passes; measured ~2 ms at the 1M-path serving scale).
    traj_pcts, real_pcts = exact_quantiles_parts([traj, real], traj_q)
    samples = traj[sample_idx]
    samples_real = real[sample_idx]
    wr_valid = ~jnp.isnan(wr)
    wr_pcts = exact_quantiles(
        wr, jnp.asarray(WITHDRAWAL_RATE_PERCENTILES), valid=wr_valid
    )
    wr_counts = jnp.sum(wr_valid, axis=0)
    return traj_pcts, real_pcts, samples, samples_real, wr_pcts, wr_counts


def summarize(outs, sample_idx: jnp.ndarray) -> RunSummary:
    """Reduce a PathOutputs batch to percentile tables and headline scalars."""
    (success_prob, median_start, median_final_successful, swr,
     final_pcts) = vector_summary(
        outs.success, outs.final_balance, outs.start_balance,
        outs.first_year_real_gross,
    )
    (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
     wr_counts) = series_summary(
        outs.trajectory, outs.price_levels, outs.withdrawal_rates, sample_idx
    )
    return RunSummary(
        success_probability=success_prob,
        median_start_balance=median_start,
        median_final_successful=median_final_successful,
        swr=swr,
        final_balance_percentiles=final_pcts,
        trajectory_percentiles=traj_pcts,
        real_trajectory_percentiles=real_pcts,
        sample_trajectories=samples,
        sample_real_trajectories=samples_real,
        wr_percentiles=wr_pcts,
        wr_observation_counts=wr_counts,
    )


def serving_bins(outs, r_years: int | None = None) -> ServingBins:
    """Reduce the dashboard's histogram payloads on device.

    Replicates hosts/payload.bin_successful_finals and bin_years_to_ruin
    bit-for-bit (same width rule, truncation-toward-zero indexing, last-bin
    clamp); the host only applies the data-dependent trims the wire format
    asks for (trailing-zero removal, ceil(max)-length ruin bins).
    """
    success = outs.success
    final = outs.final_balance
    dtype = final.dtype

    succ_count = jnp.sum(success.astype(jnp.int32))
    pos_inf = jnp.asarray(jnp.inf, dtype)
    lo = jnp.min(jnp.where(success, final, pos_inf))
    hi = jnp.max(jnp.where(success, final, -pos_inf))
    width0 = (hi - lo) / FINAL_HIST_BINS
    width = jnp.where(width0 == 0.0, jnp.asarray(1.0, dtype), width0)
    idx = jnp.minimum(
        FINAL_HIST_BINS - 1, jnp.floor((final - lo) / width).astype(jnp.int32)
    )
    onehot = (
        idx[:, None] == jnp.arange(FINAL_HIST_BINS, dtype=jnp.int32)[None, :]
    )
    hist = jnp.sum(
        jnp.where(success[:, None], onehot, False).astype(jnp.int32), axis=0
    )
    hist_median = upper_median(final, success)

    ytr = outs.years_to_ruin
    # R from the withdrawal-rate table width (static) unless given; ruin
    # years lie in [0, R], so R+1 integer bins cover every value incl. an
    # exact == R.
    if r_years is None:
        r_years = outs.withdrawal_rates.shape[1]
    failed = (~success) & ~jnp.isnan(ytr)
    ridx = jnp.minimum(r_years, jnp.floor(ytr).astype(jnp.int32))
    r_onehot = ridx[:, None] == jnp.arange(r_years + 1, dtype=jnp.int32)[None, :]
    ruin_counts = jnp.sum(
        jnp.where(failed[:, None], r_onehot, False).astype(jnp.int32), axis=0
    )
    ruin_max = jnp.max(jnp.where(failed, ytr, -pos_inf))
    failure_count = jnp.sum(failed.astype(jnp.int32))

    return ServingBins(
        success_count=succ_count,
        finals_min_successful=lo,
        finals_max_successful=hi,
        finals_hist_counts=hist,
        finals_median_successful=hist_median,
        ruin_counts=ruin_counts,
        ruin_max=ruin_max,
        failure_count=failure_count,
    )

"""Sort-free exact quantiles: bisection over the IEEE-754 bit order.

The reference reduced percentiles on the host with numpy/pandas sorts
(reference: backend/simulation.py:1045-1118); an earlier port moved them
on device but kept XLA's O(n log n) sort, which dominated the
full-statistics run. This module replaces
the sorts with *rank selection by binary search over the value space*:

  * The IEEE-754 bit pattern of a float, XOR-folded so that sign ordering
    becomes unsigned-integer ordering, is a monotone image of the float
    order. The k-th order statistic is therefore the smallest key ``v``
    with ``count(x <= value(v)) >= k + 1``.
  * That predicate is monotone in ``v``, so each of the 32 (f32) or 64
    (f64) result bits is decided high-to-low with one fused
    compare-and-count pass over the data — a pure VPU reduction that XLA
    fuses without materialising the broadcast, and that lowers to a psum
    when the path axis is sharded over a mesh.
  * Only the *floor* rank of each quantile is searched; the adjacent
    *ceil* order statistic comes from a single extra pass (count-at plus
    masked next-larger-min), halving the search work.
  * Candidate thresholds are converted to floats per step (a (C, K)-sized
    operation), so the n-sized compares run in the native float domain at
    full VPU rate — the data array itself is never bit-cast.

Cost: ``bits`` streaming passes of n x C x Q compares instead of C sorts
of n rows — an order of magnitude less device time at the 1M-path serving
scale, with results exactly equal (same order statistics, same linear
interpolation) to ``np.percentile`` / ``np.nanpercentile``.

Caveat: masked entries sort as +inf, so *valid data must be finite* (the
engine's money/rate columns are); a valid +inf would tie with the mask
sentinel at the extreme top rank.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import jax.numpy as jnp
from jax import lax

# numpy scalars, NOT jnp: building a jnp.uint64 at import time would fail
# on runtimes without x64 (the float32 serving process); the f64 branch is only
# ever traced where x64 is enabled.
_F32_SIGN = np.uint32(0x80000000)
_F64_SIGN = np.uint64(0x8000000000000000)


def _default_bits_per_pass() -> int:
    """How many result bits each compare-count pass decides (radix 2^k).

    k bits per pass needs 2^k - 1 ordered probes per (column, rank) —
    compare work grows (2^k - 1)/k per element while the number of
    streaming passes over the data shrinks k-fold. The data passes are
    expected to be memory-bandwidth-bound at the serving scale (~200-400 MB
    per pass), so k > 1 trades cheap compares for memory sweeps. k must
    divide the float's bit width (32/64): one of 1, 2, 4, 8.

    MCRT_QUANTILE_RADIX_BITS overrides (trace-time: different k compiles
    a different — bit-identical-valued — executable).
    """
    return int(os.environ.get("MCRT_QUANTILE_RADIX_BITS", "1"))


def _uint_info(dtype):
    if dtype == jnp.dtype(jnp.float32):
        return _F32_SIGN, jnp.uint32, 32
    if dtype == jnp.dtype(jnp.float64):
        return _F64_SIGN, jnp.uint64, 64
    raise TypeError(f"quantiles support f32/f64 arrays, got {dtype}")


def _from_ordered_bits(keys: jnp.ndarray, dtype) -> jnp.ndarray:
    """Ordered-key space -> float: inverse of the XOR fold (small arrays
    only — candidates, never the data)."""
    sign, _, _ = _uint_info(dtype)
    was_neg = (keys & sign) == 0
    bits = jnp.where(was_neg, ~keys, keys ^ sign)
    return lax.bitcast_convert_type(bits, dtype)


def _snap_zero_band(out: jnp.ndarray) -> jnp.ndarray:
    """Collapse subnormal-magnitude results (and -0.0) to +0.0.

    XLA:CPU runs compares with DAZ/FTZ (subnormal operands read as zero),
    so every key in the subnormal band is count-indistinguishable from 0.0
    and the bisection may land anywhere inside it; under those semantics
    the exact answer for the band IS zero. XLA:GPU compares subnormals as
    they are (chip_smoke.py checks it), so there the search resolves them
    and this snap reports them as 0.0 too: both platforms give the same
    value, which differs from numpy's only for a subnormal order statistic
    (by less than 1.2e-38)."""
    tiny = np.finfo(np.dtype(out.dtype)).tiny
    return jnp.where(jnp.abs(out) < tiny, jnp.zeros((), out.dtype), out)


def _count_dtype(n: int):
    # f32 adds run at full VPU rate and count integers exactly below 2**24;
    # larger batches fall back to exact i32 accumulation.
    return jnp.float32 if n < 2**24 else jnp.int32


def _column_slices(parts):
    """Column offsets of each part within the joint (C, K) tables."""
    out, c0 = [], 0
    for p in parts:
        out.append(slice(c0, c0 + p.shape[1]))
        c0 += p.shape[1]
    return out, c0


def _search_floor_values_parts(
    parts, need: jnp.ndarray, bits_per_pass: Optional[int] = None
) -> jnp.ndarray:
    """Smallest value v (as a float) with count(x <= v) >= need, per
    (column, rank), jointly for a LIST of column groups.

    Each part is (n, C_i) with masked entries already +inf; the groups'
    columns are stacked (in order) into the joint need/result tables of
    shape (sum C_i, K). One bisection loop decides every group's bits
    together — per-part counts are concatenated each pass — so G groups
    pay ONE loop's pass overhead instead of G (measured ~2 ms per merged
    1M x 51 group at the serving scale), and no (n, sum C_i) concat is
    ever materialised.

    Each pass decides ``k = bits_per_pass`` result bits (radix 2^k, see
    :func:`_default_bits_per_pass`): with the high bits fixed in ``res``
    and a k-bit group at position ``b``, the candidate key for group
    value m is ``res | (m << b) | ((1 << b) - 1)`` (group = m, all lower
    bits 1) and ``count(x <= decode(candidate)) >= need`` iff the true
    group value is <= m — monotone in m, so the group value is simply
    how many of the 2^k - 1 probes (m = 0..2^k-2) FAIL the test. k = 1
    reduces to classic bisection. Results are bit-identical for every k.

    Returns (C, K) floats (+inf when need > #finite).
    """
    n = parts[0].shape[0]
    dtype = parts[0].dtype
    slices, _ = _column_slices(parts)
    _, uint, nbits = _uint_info(dtype)
    k = _default_bits_per_pass() if bits_per_pass is None else bits_per_pass
    if nbits % k:
        raise ValueError(f"bits_per_pass {k} must divide {nbits}")
    n_probes = (1 << k) - 1
    cdt = _count_dtype(n)
    need_c = need.astype(cdt)
    one = jnp.asarray(1, dtype=uint)
    ms = jnp.arange(n_probes, dtype=uint)  # probe group values 0..2^k-2

    K = need.shape[1]

    def body(i, res):
        b = jnp.asarray(nbits, uint) - (i.astype(uint) + 1) * jnp.asarray(
            k, uint
        )
        # Candidates: prefix | m << b | (all lower bits 1), m = 0..2^k-2.
        low_ones = (one << b) - one
        test_keys = res[..., None] | (ms << b) | low_ones
        test = _from_ordered_bits(test_keys, dtype)
        # Candidate keys outside the float range decode to NaN. Keys above
        # +inf (positive-NaN space) have every real key below them: clamp
        # to +inf so the compare counts everything (keeps an exact +inf
        # answer reachable). Keys below -inf (negative-NaN space, sign bit
        # set) have nothing below: leave them NaN — x <= NaN is false.
        test = jnp.where(
            jnp.isnan(test) & ~jnp.signbit(test),
            jnp.asarray(jnp.inf, dtype), test,
        )
        # Probes fold into the rank axis — the compare stays the rank-3
        # (n, C, K*P) broadcast XLA fuses into the count reduction without
        # materialising (a trailing size-P axis instead measured 91 ->
        # 760 ms full stats on chip: the rank-4 pattern broke the fusion).
        test_flat = test.reshape(test.shape[0], K * n_probes)
        cnt = jnp.concatenate(
            [
                jnp.sum(
                    (xf[:, :, None] <= test_flat[None, s, :]).astype(cdt),
                    axis=0,
                )
                for xf, s in zip(parts, slices)
            ],
            axis=0,
        ).reshape(need.shape[0], K, n_probes)
        g = jnp.sum(
            (cnt < need_c[..., None]).astype(jnp.int32), axis=-1
        ).astype(uint)
        return res | (g << b)

    res = lax.fori_loop(
        0, nbits // k, body, jnp.zeros(need.shape, dtype=uint)
    )
    return _from_ordered_bits(res, dtype)


def _search_floor_values(
    xf: jnp.ndarray, need: jnp.ndarray
) -> jnp.ndarray:
    """Single-group form of :func:`_search_floor_values_parts`."""
    return _search_floor_values_parts([xf], need)


def _ceil_values_parts(parts, v_lo: jnp.ndarray, lo_ranks: jnp.ndarray):
    """The (lo+1)-th order statistic given the lo-th, in ONE pass: it is
    v_lo itself when duplicates extend past rank lo+1, else the smallest
    entry strictly above v_lo. Joint over column groups like
    :func:`_search_floor_values_parts`."""
    n = parts[0].shape[0]
    dtype = parts[0].dtype
    slices, _ = _column_slices(parts)
    cdt = _count_dtype(n)
    pos_inf = jnp.asarray(jnp.inf, dtype)
    # Written as independent broadcast-reductions so XLA fuses each into
    # its own pass instead of materialising an (n, C, K) intermediate.
    cnt_le = jnp.concatenate(
        [
            jnp.sum((xf[:, :, None] <= v_lo[None, s, :]).astype(cdt), axis=0)
            for xf, s in zip(parts, slices)
        ],
        axis=0,
    )
    gt_min = jnp.concatenate(
        [
            jnp.min(
                jnp.where(
                    xf[:, :, None] <= v_lo[None, s, :], pos_inf, xf[:, :, None]
                ),
                axis=0,
            )
            for xf, s in zip(parts, slices)
        ],
        axis=0,
    )
    dup = cnt_le >= (lo_ranks + 2).astype(cdt)
    # For in-range fractional ranks gt_min is always a real entry (a rank
    # lo+1 exists and is not a duplicate precisely when something lies above
    # v_lo); the +inf no-entry case only surfaces where the caller's
    # interpolation weight is zero and discards it.
    return jnp.where(dup, v_lo, gt_min)


def _ceil_values(xf: jnp.ndarray, v_lo: jnp.ndarray, lo_ranks: jnp.ndarray):
    """Single-group form of :func:`_ceil_values_parts`."""
    return _ceil_values_parts([xf], v_lo, lo_ranks)


def order_statistics(
    x: jnp.ndarray,
    ranks: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Exact order statistics along axis 0, one search per (column, rank).

    Args:
      x: ``(n, C)`` float32/float64 values (finite where valid).
      ranks: ``(C, K)`` int32 0-indexed ranks within each column's *valid*
        entries (rank 0 = smallest). Ranks at or beyond the valid count
        return NaN.
      valid: optional ``(n, C)`` bool; invalid entries sort last and are
        never selected by in-range ranks. NaNs in ``x`` must be masked
        invalid.

    Returns:
      ``(C, K)`` values of ``x``'s dtype; NaN where the rank is out of
      range (e.g. an all-invalid column).
    """
    if x.ndim != 2 or ranks.ndim != 2 or x.shape[1] != ranks.shape[0]:
        raise ValueError(
            f"expected x (n, C) and ranks (C, K); got {x.shape} / {ranks.shape}"
        )
    n = x.shape[0]
    if valid is None:
        xf = x
        n_valid = jnp.full((x.shape[1],), n, dtype=jnp.int32)
    else:
        xf = jnp.where(valid, x, jnp.asarray(jnp.inf, x.dtype))
        n_valid = jnp.sum(valid.astype(jnp.int32), axis=0)
    vals = _search_floor_values(xf, ranks.astype(jnp.int32) + 1)
    out = jnp.where(
        ranks < n_valid[:, None], vals, jnp.asarray(jnp.nan, x.dtype)
    )
    return _snap_zero_band(out)


def _masked_parts(parts, valids):
    """Apply per-part masks (+inf sentinel) and count valid rows/column."""
    xfs, n_valids = [], []
    for x, valid in zip(parts, valids):
        n, _ = x.shape
        if valid is None:
            xfs.append(x)
            n_valids.append(jnp.full((x.shape[1],), n, dtype=jnp.int32))
        else:
            xfs.append(jnp.where(valid, x, jnp.asarray(jnp.inf, x.dtype)))
            n_valids.append(jnp.sum(valid.astype(jnp.int32), axis=0))
    return xfs, jnp.concatenate(n_valids, axis=0)


def _interpolated_quantiles(xfs, n_valid, h):
    """Shared core: linear-interpolated quantiles at positions ``h``
    ((C, K), in sorted-rank units) over joint column groups. Returns
    (C, K); NaN where a column has zero valid entries."""
    dtype = xfs[0].dtype
    lo = jnp.floor(h).astype(jnp.int32)
    frac = h - lo.astype(dtype)
    v_lo = _search_floor_values_parts(xfs, lo + 1)
    v_hi = _ceil_values_parts(xfs, v_lo, lo)
    out = jnp.where(frac == 0, v_lo, v_lo + frac * (v_hi - v_lo))
    out = jnp.where(
        n_valid[:, None] > 0, out, jnp.asarray(jnp.nan, dtype)
    )
    return _snap_zero_band(out)


def exact_quantiles(
    x: jnp.ndarray,
    qs,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """``np.percentile(x, qs*100, axis=0)`` / ``nanpercentile`` without sorts.

    Args:
      x: ``(n, C)`` values; quantiles reduce over axis 0. Valid entries
        must be finite.
      qs: ``(Q,)`` quantile fractions in [0, 1].
      valid: optional ``(n, C)`` bool mask — the NaN-aware/masked form.
        Columns with zero valid entries return NaN (nanpercentile
        semantics).

    Returns:
      ``(Q, C)`` linear-interpolated quantiles, exactly equal to numpy's
      default (linear) method on the same values.
    """
    return exact_quantiles_parts([x], qs, valids=[valid])[0]


def exact_quantiles_parts(parts, qs, valids=None):
    """:func:`exact_quantiles` over several same-``n`` column groups in ONE
    bisection loop.

    Equivalent to calling ``exact_quantiles`` per group (or concatenating
    the groups along columns), but every group's order statistics are
    searched by the same 32/64 passes — one loop's pass overhead instead of
    one per group, and no materialised concat. The serving reducer uses it
    to fold the nominal- and real-trajectory tables together (measured
    ~2 ms saved per merged 1M x 51 group).

    Args:
      parts: list of ``(n, C_i)`` arrays (same n and dtype).
      qs: ``(Q,)`` shared quantile fractions in [0, 1].
      valids: optional list of per-part masks (``None`` entries allowed).

    Returns:
      List of ``(Q, C_i)`` tables, one per part.
    """
    if valids is None:
        valids = [None] * len(parts)
    dtype = parts[0].dtype
    qs = jnp.asarray(qs, dtype=dtype)
    xfs, n_valid = _masked_parts(parts, valids)
    # Interpolation position h = q * (n_valid - 1) per (column, quantile).
    h = qs[None, :] * jnp.maximum(n_valid[:, None] - 1, 0).astype(dtype)
    out = _interpolated_quantiles(xfs, n_valid, h)
    slices, _ = _column_slices(parts)
    return [jnp.transpose(out[s]) for s in slices]


def quantiles_percol(
    x: jnp.ndarray,
    qmat: jnp.ndarray,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Per-COLUMN quantile fractions, one joint bisection loop.

    ``out[c, k] = np.(nan)percentile(x[:, c], qmat[c, k] * 100)`` — each
    column brings its own fraction row, so heterogeneous scalar tables
    (medians at 0.5 next to a 9-point percentile ladder) reduce in a single
    search. Pad short rows by repeating a fraction; duplicates cost nothing
    extra.

    Args:
      x: ``(n, C)`` values.
      qmat: ``(C, K)`` fractions in [0, 1].
      valid: optional ``(n, C)`` mask.

    Returns:
      ``(C, K)`` values (NaN for all-invalid columns).
    """
    if qmat.ndim != 2 or qmat.shape[0] != x.shape[1]:
        raise ValueError(
            f"expected qmat (C, K) matching x (n, C); got {qmat.shape} / {x.shape}"
        )
    xfs, n_valid = _masked_parts([x], [valid])
    qmat = jnp.asarray(qmat, dtype=x.dtype)
    h = qmat * jnp.maximum(n_valid[:, None] - 1, 0).astype(x.dtype)
    return _interpolated_quantiles(xfs, n_valid, h)


def masked_median(x: jnp.ndarray, valid: Optional[jnp.ndarray] = None):
    """Median over valid entries of a vector (np.percentile 50 semantics)."""
    out = exact_quantiles(x[:, None], jnp.asarray([0.5]),
                          valid=None if valid is None else valid[:, None])
    return out[0, 0]


def upper_median(x: jnp.ndarray, valid: jnp.ndarray):
    """``sorted(x[valid])[count // 2]`` — the element the dashboard's
    client-side histogram labels as the median (no interpolation)."""
    n_valid = jnp.sum(valid.astype(jnp.int32))
    rank = jnp.maximum(n_valid // 2, 0)
    vals = order_statistics(x[:, None], rank[None, None], valid=valid[:, None])
    return vals[0, 0]

"""Pallas kernel (Triton route): each path's whole lifetime in registers.

Why this exists: the XLA scan (engine/kernel.py) carries every path's state
through device memory on each of the ~600 months and materialises each
month's threefry draws there. This kernel runs one program per block of
paths; the state of each path stays in registers for the whole horizon, the
draws are made inside the kernel, and the only device-memory traffic is the
per-path outputs (plus, in full mode, one row store per recorded year).

Design:

  * the accumulation and retirement phases are separate dynamic-bound
    `fori_loop`s with a straight-line retirement snapshot between them, so
    `working_months` is a traced scalar: candidates never recompile;
  * structural config facts (which tax system each asset uses, whether any
    annual mark-to-market bill can exist, which streams are CPI-indexed /
    duration-capped, and the optional extensions) are compile-time
    `Statics` — editing rates/amounts never recompiles;
  * the tax algebra exploits the average-cost-basis invariant (the gain
    fraction is unchanged by proportional sales), so one per-asset sale
    profile serves the capacity check, the withdrawal and the rebalance,
    and realized tax is exactly `gross * eff`. Pro-rata-by-net-capacity
    sales reduce the withdrawal and the annual bill to ONE shared sale
    fraction (target / tnc) applied to both balances and bases.

Random numbers: the kernel draws the scan's own stream. Month m's key is
``fold_in(stream_key, m)`` and path p's three normals are the threefry2x32
counters ``3p, 3p+1, 3p+2`` of ``jax.random.normal(key_m, (n_paths, 3))``
(partitionable threefry: bits = hi-word ^ lo-word), mapped to normals the
way ``jax.random.normal`` maps them. Crash draws and the longevity uniform
follow ops/shocks.py the same way. The draws are keyed by the GLOBAL path
index, so the block size never changes a result, a sharded run reproduces
a one-device run path for path, and antithetic pairing is the scan's
path-level rule (path 2i+1 negates path 2i). Kernel and scan therefore
simulate the same paths; they differ only by float32 rounding (exp/log
implementations, fused multiply-adds, summation order).

Entry points: `pallas_simulate` (per-path success/final), `pallas_probe`
(candidate-parallel success probabilities for the search),
`pallas_simulate_full` (adds retirement snapshots and the yearly
trajectory/price/withdrawal-rate series), `pallas_scenario_grid` /
`pallas_scenario_grid_raw` (per-row parameter sweeps), and their
`*_sharded` forms over a 1-D 'paths' mesh.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import MONTHS_PER_YEAR, SMALL_EPSILON
from ..models.retirement import SimParams
from ..ops.shocks import JUMP_FOLD_OFFSET, MORT_FOLD_OFFSET
from ..ops.tax import fail_rtol

EPS = SMALL_EPSILON
FAIL_RTOL = fail_rtol(jnp.float32)  # shared with the scan kernel

# Paths per program and warps per program (Triton block sizes are powers of
# two). Results do not depend on either: draws are keyed by global path.
BLOCK_PATHS = 512
NUM_WARPS = 4

# fparams vector layout (float32). The use_real/bill flags are NOT here: the
# tax system is compile-time Statics, never a traced parameter — grid rows
# that disagree with the Statics are rejected before dispatch
# (_check_grid_statics), not read per row.
(
    F_MU1_M, F_S1_M, F_MUI_M, F_SI_M, F_MUP_M, F_SP_M,
    F_RHO, F_RHO_C,
    F_ALLOC1, F_INIT_BAL, F_CONTRIB0, F_LOG1P_GROWTH, F_EXPENSES,
    F_R_REAL1, F_R_ANN1,
    F_R_REAL2, F_R_ANN2,
    F_ALLOC1_F,
    F_GR_UP, F_GR_LO, F_GR_ADJ, F_GR_FLOOR, F_GR_CAP,
    F_JP, F_JMU, F_JSIG, F_JBETA, F_JC1, F_JC2,
    F_MORT_G0, F_MORT_B12, F_MORT_CAP,
    NUM_FPARAMS,
) = range(33)
FPARAMS_PAD = 64  # the parameter vector is padded to a power of two

# iparams row layout (int32): working months, horizon end, the global block
# offset of this call's block 0 (a sharded or chunked dispatch passes its
# place in the global block sequence, so draws stay keyed by global path
# index), and the antithetic flag. The flag is data, not structure: iid and
# antithetic runs execute the same program, so the even paths of an
# antithetic run equal a half-size iid run bit for bit on any backend.
I_W, I_T_END, I_BLOCK_OFF, I_ANTI, NUM_IPARAMS = range(5)

# Shock-injection planes (tests and parity checks): 3 base normals, then the
# crash uniform and normal, then the longevity uniform (read at month 0).
SHOCK_JUMP_U, SHOCK_JUMP_Z, SHOCK_MORT_U = 3, 4, 5

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
# jax.random.uniform scales by (maxval - minval) computed in float32
_NORMAL_SPAN = np.float32(np.float32(1.0) - _NORMAL_LO)
_SQRT2 = np.float32(np.sqrt(2.0))


class Statics(NamedTuple):
    """Compile-time structure of a scenario: which tax *systems* are active
    and the shape of the income-stream table. Rates/amounts/ages stay traced
    (editing them reuses the executable); flipping any of these flags builds
    a new kernel."""

    use_real1: bool
    use_real2: bool
    # An annual mark-to-market bill can exist (not realized-system AND a
    # nonzero annual rate). When neither asset can ever owe one, the whole
    # boundary/settle subgraph and both gain accumulators vanish: a second
    # rebalance right after the monthly one is an exact no-op.
    bill1: bool
    bill2: bool
    stream_indexed: Tuple[bool, ...]
    stream_capped: Tuple[bool, ...]
    # Antithetic sampling (config.antithetic): path 2i+1 replays path 2i's
    # draws negated (the scan's rule, ops/shocks.monthly_shocks). The
    # kernel reads it as data (iparams I_ANTI); it is part of the Statics so
    # that one grid dispatch cannot mix it.
    antithetic: bool = False
    # Allocation glide path (config.allocation_inv1_final_pct is not None):
    # the rebalance target interpolates alloc1 -> alloc1_final over the
    # working months. Compile-time so the non-glide kernel reads neither
    # the second endpoint nor the per-month interpolation.
    glide: bool = False
    # Dynamic spending guardrails (config.spending_guardrails is not None):
    # a per-path spending multiplier adjusts at retirement-year starts when
    # the planned WR crosses a band. Compile-time: off drops the multiplier
    # carry slot and every year-start band op from the kernel.
    guardrails: bool = False
    # Market-crash jumps (config.market_crashes is not None): each month
    # draws one extra uniform + normal for the compensated jump factor from
    # a disjoint fold_in stream, so the base draws are untouched. One grid
    # dispatch cannot mix it (grid_statics enforces uniformity); p=0
    # sentinel rows inside a jumps-on executable are exact no-ops.
    jumps: bool = False
    # Longevity (config.longevity is not None): one extra uniform per path
    # (again a disjoint stream) becomes a remaining lifetime at the
    # retirement date; expired months zero the spending need while the
    # estate keeps evolving. Sentinel rows (mort_b12 = 0) never expire.
    mortality: bool = False


def statics_from_config(config) -> Statics:
    """Derive kernel Statics from a validated Config. Streams are pruned by
    the SAME helper that builds the SimParams stream arrays, so the per-stream
    flag indices here always align with the kernel's stream table."""
    from ..models.retirement import prune_streams

    streams = prune_streams(config)
    use1 = bool(config.inv1_use_realized_gains_tax_system)
    use2 = bool(config.inv2_use_realized_gains_tax_system)
    return Statics(
        use_real1=use1,
        use_real2=use2,
        bill1=(not use1) and config.inv1_annual_tax_on_gains_rate > 0.0,
        bill2=(not use2) and config.inv2_annual_tax_on_gains_rate > 0.0,
        stream_indexed=tuple(bool(s.inflation_indexed) for s in streams),
        stream_capped=tuple(s.duration_years is not None for s in streams),
        antithetic=bool(getattr(config, "antithetic", False)),
        glide=getattr(config, "allocation_inv1_final_pct", None) is not None,
        guardrails=getattr(config, "spending_guardrails", None) is not None,
        jumps=getattr(config, "market_crashes", None) is not None,
        mortality=getattr(config, "longevity", None) is not None,
    )


def _local_blocks(n_paths: int, n_dev: int, block_paths: int) -> int:
    """Blocks each device runs: ceil(ceil(n_paths / n_dev) / block_paths)."""
    per_dev = (n_paths + n_dev - 1) // n_dev
    return max(1, (per_dev + block_paths - 1) // block_paths)


def _check_grid_statics(params_batch: SimParams, statics: Statics) -> None:
    """Best-effort guard: when the batched parameters are concrete, verify
    every row matches the compile-time ``statics`` — the kernel ignores the
    per-row tax-system and stream-structure data and branches solely on the
    static flags, so a mismatched row would silently simulate under another
    row's structure. Traced inputs skip the check (callers validate configs
    via engine.scenario_batch.grid_statics)."""
    try:
        u1 = np.asarray(params_batch.use_real1) > 0.5
        u2 = np.asarray(params_batch.use_real2) > 0.5
        a1 = np.asarray(params_batch.ann_tax1) > 0.0
        a2 = np.asarray(params_batch.ann_tax2) > 0.0
        # (K, S) per-row stream structure vs the static per-stream flags
        s_idx = np.asarray(params_batch.stream_indexed) > 0.5
        s_cap = np.isfinite(np.asarray(params_batch.stream_duration_months))
        # Without the glide flag the kernel never reads alloc1_final: a row
        # with a real glide endpoint would silently simulate constant-alloc.
        glide_rows = np.asarray(params_batch.alloc1_final) != np.asarray(
            params_batch.alloc1
        )
        # Same for guardrails: adjustment > 0 marks a row with a live rule.
        gr_rows = np.asarray(params_batch.gr_adjust) > 0.0
        # And for jumps: p > 0 marks a live crash rule.
        jump_rows = np.asarray(params_batch.jump_p) > 0.0
        # And for longevity: b12 > 0 marks a live lifespan rule.
        mort_rows = np.asarray(params_batch.mort_b12) > 0.0
    except jax.errors.TracerArrayConversionError:
        return  # tracers: cannot inspect values here
    want_idx = np.asarray(statics.stream_indexed, dtype=bool)
    want_cap = np.asarray(statics.stream_capped, dtype=bool)
    ok = (
        bool((u1 == statics.use_real1).all())
        and bool((u2 == statics.use_real2).all())
        and bool(((~u1 & a1) == statics.bill1).all())
        and bool(((~u2 & a2) == statics.bill2).all())
        and (statics.glide or not bool(glide_rows.any()))
        and (statics.guardrails or not bool(gr_rows.any()))
        and (statics.jumps or not bool(jump_rows.any()))
        and (statics.mortality or not bool(mort_rows.any()))
    )
    if ok and want_idx.size:
        # Fail loudly on a stream-count mismatch — reshape would otherwise
        # regroup rows and compare the wrong (row, stream) pairs.
        ok = (
            s_idx.shape[-1] == want_idx.size
            and bool((s_idx.reshape(-1, want_idx.size) == want_idx).all())
            and bool((s_cap.reshape(-1, want_cap.size) == want_cap).all())
        )
    if not ok:
        raise ValueError(
            "scenario batch mixes tax-system/annual-bill/stream structure "
            "that conflicts with the compile-time Statics; all rows of one "
            "Pallas grid dispatch must share them (see "
            "engine.scenario_batch.grid_statics). Use the XLA scan path "
            "(run_scenario_batch) for mixed batches."
        )


# ---------------------------------------------------------------------------
# Counter-based generator: threefry2x32 in uint32 add/rotate/xor, the same
# function jax.random evaluates, so kernel draws equal jax.random draws.
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), as jax.random runs it."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def fold_in(k0, k1, data):
    """jax.random.fold_in on a raw threefry key: hash of counter (0, data)."""
    return threefry2x32(k0, k1, jnp.uint32(0), jnp.asarray(data).astype(jnp.uint32))


def random_bits(k0, k1, counter):
    """The 32 random bits jax.random draws at flat index ``counter`` (< 2^32)
    of an array under key (k0, k1): partitionable threefry, hi ^ lo."""
    b0, b1 = threefry2x32(k0, k1, jnp.uint32(0), counter)
    return b0 ^ b1


def bits_to_unit(bits):
    """jax.random.uniform's mapping: 23 mantissa bits -> [0, 1)."""
    one = lax.bitcast_convert_type(
        (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32
    )
    return one - jnp.float32(1.0)


def bits_to_normal(bits):
    """jax.random.normal's mapping: uniform on (-1, 1), sqrt(2) * erf_inv."""
    u = bits_to_unit(bits) * _NORMAL_SPAN + _NORMAL_LO
    u = jnp.maximum(jnp.float32(_NORMAL_LO), u)
    return _SQRT2 * lax.erf_inv(u)


def _mod12(x):
    """x % 12 for x >= 0 (lax.rem: the Triton route lowers it directly)."""
    return lax.rem(x, jnp.int32(MONTHS_PER_YEAR))


def _div12(x):
    """x // 12 for x >= 0."""
    return lax.div(x, jnp.int32(MONTHS_PER_YEAR))


def _key_words(seed):
    """Raw threefry key words (uint32[2]) from either a raw key (the
    engine's stream keys) or an integer seed (jax.random.PRNGKey)."""
    seed = jnp.asarray(seed)
    if seed.ndim == 0:
        seed = jax.random.PRNGKey(seed)
    return seed.astype(jnp.uint32).reshape(2)


def _make_kernel(
    n_streams: int,
    retirement_years: int,
    with_shocks: bool,
    statics: Statics,
    block_axis: int = 0,
    cand_axis=None,
    traj_len: int = 0,
    multi_params: bool = False,
):
    """Build the block kernel for one (streams, R, statics) combination.

    The month loop is two dynamic-bound fori_loops (accumulation, then
    retirement) around a straight-line retirement snapshot; per-candidate
    `working_months` is read from iparams so candidates share one
    executable.
    """
    R = retirement_years
    B = BLOCK_PATHS
    shape = (B,)
    track = traj_len > 0
    st_ = statics
    any_bills = st_.bill1 or st_.bill2
    # fixed-nominal slots exist only for non-CPI-indexed streams
    fixed_slot = {}
    for s in range(n_streams):
        if not st_.stream_indexed[s]:
            fixed_slot[s] = len(fixed_slot)
    n_fixed = len(fixed_slot)

    # carry layout ---------------------------------------------------------
    # 0..5: b1, c1, b2, c2, infl, alive_f
    # [g1a, g2a, preret_f] when any_bills
    # n_fixed fixed-nominal slots
    # [spending multiplier] when guardrails
    # [ytr, yg, yr] when track
    i_bills = 6
    i_fixed = i_bills + (3 if any_bills else 0)
    i_spend = i_fixed + n_fixed
    i_track = i_spend + (1 if st_.guardrails else 0)

    def kernel(key_ref, iparams, fparams, *rest):
        rest = list(rest)
        if n_streams:
            s_amount, s_from_t0, s_duration, s_indexed, s_tax = rest[:5]
            rest = rest[5:]
        if with_shocks:
            shocks_ref = rest.pop(0)
        if track:
            # traj/price/wr inputs are aliased to their outputs: the
            # initial fill (zeros / ones / NaN) comes in with the buffers.
            rest = rest[3:]
            (out_success, out_final, out_start, out_ytr, out_fyg, out_fyr,
             out_inflret, out_traj, out_price, out_wr) = rest
        else:
            out_success, out_final = rest

        row = pl.program_id(cand_axis) if cand_axis is not None else 0
        pid = pl.program_id(block_axis)
        cols = pl.ds(pl.multiple_of(pid * B, B), B)

        def vload(ref):
            return ref[row, cols]

        def vstore(ref, value):
            ref[row, cols] = value

        def series_store(ref, slot, value):
            ref[slot, cols] = value

        w = iparams[row, I_W]
        t_end = iparams[row, I_T_END]
        if multi_params:
            # Scenario grids: every float parameter (and stream table) is a
            # per-candidate row, read once here.
            fvals = [fparams[row, i] for i in range(NUM_FPARAMS)]
            stream_cell = lambda arr, s: arr[row, s]
        else:
            fvals = [fparams[i] for i in range(NUM_FPARAMS)]
            stream_cell = lambda arr, s: arr[s]
        f = lambda i: fvals[i]
        if n_streams:
            svals = {
                id(arr): [stream_cell(arr, s) for s in range(n_streams)]
                for arr in (s_amount, s_from_t0, s_duration, s_indexed, s_tax)
            }
            cell = lambda arr, s: svals[id(arr)][s]
        w_f = w.astype(jnp.float32)

        if not with_shocks:
            k0 = key_ref[0]
            k1 = key_ref[1]
            gpath = (iparams[row, I_BLOCK_OFF] + pid) * B + lax.broadcasted_iota(
                jnp.int32, shape, 0
            )
            # Antithetic: path 2i+1 replays path 2i's draws (row i), negated.
            anti = iparams[row, I_ANTI] != 0
            odd = anti & ((gpath & 1) == 1)
            draw_row = jnp.where(anti, gpath >> 1, gpath).astype(jnp.uint32)
            ctr3 = draw_row * jnp.uint32(3)

        def draw_normals(m):
            km0, km1 = fold_in(k0, k1, m)
            return [
                jnp.where(odd, -zz, zz)
                for zz in (
                    bits_to_normal(random_bits(km0, km1, ctr3 + jnp.uint32(j)))
                    for j in range(3)
                )
            ]

        def draw_jump(m):
            """Crash draws (u, z_j): ops/shocks.monthly_jump_draws — the
            month key folds at JUMP_FOLD_OFFSET and splits into (ku, kz)."""
            if with_shocks:
                return (shocks_ref[m - 1, SHOCK_JUMP_U, cols],
                        shocks_ref[m - 1, SHOCK_JUMP_Z, cols])
            kj0, kj1 = fold_in(k0, k1, m + JUMP_FOLD_OFFSET)
            ku0, ku1 = threefry2x32(kj0, kj1, jnp.uint32(0), jnp.uint32(0))
            kz0, kz1 = threefry2x32(kj0, kj1, jnp.uint32(0), jnp.uint32(1))
            u = bits_to_unit(random_bits(ku0, ku1, draw_row))
            zj = bits_to_normal(random_bits(kz0, kz1, draw_row))
            # Antithetic pairs mirror: z negates, u reflects.
            return jnp.where(odd, 1.0 - u, u), jnp.where(odd, -zj, zj)

        if st_.mortality:
            # Longevity (config.longevity): ONE uniform per path
            # (ops/shocks.mortality_uniform), turned into a remaining
            # lifetime at the retirement date.
            if with_shocks:
                u_mort = shocks_ref[0, SHOCK_MORT_U, cols]
            else:
                km0, km1 = fold_in(k0, k1, MORT_FOLD_OFFSET)
                u_mort = bits_to_unit(random_bits(km0, km1, draw_row))
                u_mort = jnp.where(odd, 1.0 - u_mort, u_mort)
            from ..ops.shocks import gompertz_remaining_months

            d_mort = gompertz_remaining_months(
                u_mort, f(F_MORT_G0), f(F_MORT_B12), f(F_MORT_CAP), w_f,
                jnp.float32,
            )

        alloc1 = f(F_ALLOC1)
        if st_.glide:
            # Linear target glide a0 -> af over the working months; the
            # retirement phase holds af exactly.
            alloc1_ret = f(F_ALLOC1_F)
            glide_scale = (alloc1_ret - alloc1) / jnp.maximum(w_f, 1.0)
        else:
            alloc1_ret = alloc1
        r1 = f(F_R_REAL1)
        r2 = f(F_R_REAL2)

        if n_streams:
            stream_start = [
                jnp.maximum(
                    0.0,
                    jnp.ceil(jnp.maximum(0.0, cell(s_from_t0, s) - w_f) - EPS),
                )
                for s in range(n_streams)
            ]

        # ------------------------------------------------------------------
        # shared per-asset sale profiles: eff (tax per gross dollar), nf
        # (net per gross dollar) and nc (full-liquidation net capacity).
        # Gain fraction is invariant under proportional-basis sales, so one
        # profile per month serves capacity check, withdrawal and rebalance.
        # ------------------------------------------------------------------
        def profile(b, c, use, rate):
            if not use:
                one = jnp.ones(shape, jnp.float32)
                return jnp.zeros(shape, jnp.float32), one, jnp.where(
                    b > EPS, b, 0.0
                )
            safe = jnp.where(b > EPS, b, 1.0)
            gf = jnp.maximum(0.0, b - c) / safe
            eff = gf * rate
            nf = 1.0 - eff
            nc = jnp.where(b > EPS, b * nf, 0.0)
            return eff, nf, nc

        def rebalance_lite(b1, c1, b2, c2, eff1, eff2, a1, extra_noop=None):
            """Tax-aware exact-post-tax rebalance toward target ``a1``.
            drift2 == -drift1, so the seller's drift is |drift1|; realized
            tax is gross*eff exactly."""
            total = b1 + b2
            drift1 = b1 - total * a1
            adrift = jnp.abs(drift1)
            sell1 = drift1 > 0
            noop = (total <= EPS) | (adrift <= EPS)
            if extra_noop is not None:
                noop = noop | extra_noop
            bal_s = jnp.where(sell1, b1, b2)
            basis_s = jnp.where(sell1, c1, c2)
            eff_s = jnp.where(sell1, eff1, eff2)
            alloc_s = jnp.where(sell1, a1, 1.0 - a1)
            denom = jnp.maximum(EPS, 1.0 - alloc_s * eff_s)
            gross_s = jnp.minimum(bal_s, adrift / denom)
            frac_s = gross_s / jnp.where(bal_s > EPS, bal_s, 1.0)
            net_p = gross_s * (1.0 - eff_s)
            new_sb = bal_s - gross_s
            new_sc = basis_s - basis_s * frac_s
            bal_b = jnp.where(sell1, b2, b1) + net_p
            basis_b = jnp.where(sell1, c2, c1) + net_p
            ob1 = jnp.where(sell1, new_sb, bal_b)
            oc1 = jnp.where(sell1, new_sc, basis_b)
            ob2 = jnp.where(sell1, bal_b, new_sb)
            oc2 = jnp.where(sell1, basis_b, new_sc)
            z1 = ob1 <= EPS
            z2 = ob2 <= EPS
            ob1 = jnp.where(z1, 0.0, ob1)
            oc1 = jnp.where(z1, 0.0, oc1)
            ob2 = jnp.where(z2, 0.0, ob2)
            oc2 = jnp.where(z2, 0.0, oc2)
            return (
                jnp.where(noop, b1, ob1),
                jnp.where(noop, c1, oc1),
                jnp.where(noop, b2, ob2),
                jnp.where(noop, c2, oc2),
            )

        def monthly_rebalance(b1, c1, b2, c2, a1, extra_noop=None):
            eff1, _, _ = profile(b1, c1, st_.use_real1, r1)
            eff2, _, _ = profile(b2, c2, st_.use_real2, r2)
            return rebalance_lite(b1, c1, b2, c2, eff1, eff2, a1, extra_noop)

        def annual_tax(b1, c1, b2, c2, g1a, g2a, a1):
            """Mark-to-market settlement for one completed tax period; only
            built when a bill can exist (any_bills). Bill paid pro-rata by
            net capacity; ends with an exact-post-tax rebalance."""
            due1 = (
                jnp.maximum(0.0, g1a) * f(F_R_ANN1)
                if st_.bill1 else jnp.zeros(shape, jnp.float32)
            )
            due2 = (
                jnp.maximum(0.0, g2a) * f(F_R_ANN2)
                if st_.bill2 else jnp.zeros(shape, jnp.float32)
            )
            total_due = due1 + due2
            eff1, nf1, nc1 = profile(b1, c1, st_.use_real1, r1)
            eff2, nf2, nc2 = profile(b2, c2, st_.use_real2, r2)
            tnc = nc1 + nc2
            payment = jnp.minimum(total_due, tnc)
            tol = EPS + FAIL_RTOL * (total_due + tnc)
            do_pay = (tnc > EPS) & (payment > 0)
            pay_f = jnp.where(do_pay, 1.0, 0.0)
            # The minimum makes 0 <= frac <= 1 hold by construction, so
            # rounding just below the capacity boundary cannot drive
            # balances negative.
            frac_t = jnp.minimum(1.0, jnp.where(
                total_due >= tnc, 1.0, total_due / jnp.maximum(tnc, EPS)
            )) * pay_f
            keep_t = 1.0 - frac_t
            ok1 = nc1 > 0
            ok2 = nc2 > 0
            g1 = jnp.where(ok1, b1 * frac_t, 0.0)
            g2 = jnp.where(ok2, b2 * frac_t, 0.0)
            c1 = jnp.where(ok1, c1 * keep_t, c1)
            c2 = jnp.where(ok2, c2 * keep_t, c2)
            b1 = b1 - g1
            b2 = b2 - g2
            e1 = b1 <= EPS
            e2 = b2 <= EPS
            b1 = jnp.where(e1, 0.0, b1)
            c1 = jnp.where(e1, 0.0, c1)
            b2 = jnp.where(e2, 0.0, b2)
            c2 = jnp.where(e2, 0.0, c2)
            tfail = payment < total_due - tol
            b1, c1, b2, c2 = monthly_rebalance(b1, c1, b2, c2, a1)
            return b1, c1, b2, c2, tfail

        zero_v = jnp.zeros(shape, jnp.float32)
        b1_0 = zero_v + f(F_INIT_BAL) * alloc1
        b2_0 = zero_v + f(F_INIT_BAL) - b1_0
        if track:
            # First-year withdrawals accumulate by read-modify-write on
            # their outputs (their window is the first retirement year
            # only), keeping them out of the loop carry.
            vstore(out_fyg, zero_v)
            vstore(out_fyr, zero_v)

        init = [b1_0, b1_0, b2_0, b2_0, zero_v + 1.0, zero_v + 1.0]
        if any_bills:
            init += [zero_v, zero_v, zero_v]  # g1a, g2a, preret_f
        init += [zero_v - 1.0] * n_fixed
        if st_.guardrails:
            init += [zero_v + 1.0]  # spending multiplier, year 0 = the plan
        if track:
            init += [
                zero_v,  # alive-months counter: +1 per retirement month the
                         # path is alive at month start; at the kernel end
                         # /12 = years_to_ruin (survivors -> NaN)
                zero_v,  # yg (year gross)
                zero_v,  # yr (year gross deflated to T=0 dollars; x
                         # infl_ret applied where it is consumed)
            ]
        init = tuple(init)

        full_wy = _div12(w)
        partial_wy = (_mod12(w) != 0).astype(jnp.int32)

        def draw(m):
            if with_shocks:
                z_eq = shocks_ref[m - 1, 0, cols]
                z_ind = shocks_ref[m - 1, 1, cols]
                z_prem = shocks_ref[m - 1, 2, cols]
            else:
                z_eq, z_ind, z_prem = draw_normals(m)
            z_inf = f(F_RHO) * z_eq + f(F_RHO_C) * z_ind
            if st_.jumps:
                # Compensated market-crash jump (config.market_crashes),
                # folded into the exponents: no extra exps.
                u, z_j = draw_jump(m)
                jl = jnp.where(u < f(F_JP), f(F_JMU) + f(F_JSIG) * z_j, 0.0)
                g1 = jnp.exp(
                    f(F_MU1_M) + f(F_S1_M) * z_eq + (jl - f(F_JC1))
                )
                gi = jnp.exp(f(F_MUI_M) + f(F_SI_M) * z_inf)
                gp = jnp.exp(
                    f(F_MUP_M) + f(F_SP_M) * z_prem
                    + (f(F_JBETA) * jl - f(F_JC2))
                )
            else:
                g1 = jnp.exp(f(F_MU1_M) + f(F_S1_M) * z_eq)
                gi = jnp.exp(f(F_MUI_M) + f(F_SI_M) * z_inf)
                gp = jnp.exp(f(F_MUP_M) + f(F_SP_M) * z_prem)
            return g1, gi, gi * gp

        # ------------------------------------------------------------------
        # accumulation month (1 <= m <= W): no deaths, no masks
        # ------------------------------------------------------------------
        def accum_month(m, st):
            st = list(st)
            b1, c1, b2, c2, infl = st[0], st[1], st[2], st[3], st[4]
            g1, gi, g2 = draw(m)
            if any_bills:
                st[i_bills] = st[i_bills] + b1 * (g1 - 1.0)
                st[i_bills + 1] = st[i_bills + 1] + b2 * (g2 - 1.0)
            b1 = b1 * g1
            b2 = b2 * g2
            infl = infl * gi

            years = (_div12(m - 1)).astype(jnp.float32)
            contrib = f(F_CONTRIB0) * jnp.exp(f(F_LOG1P_GROWTH) * years)
            if st_.glide:
                # Month-m target: a0 + (af - a0) * m / W (m <= W inside this
                # loop, so no clamp); retirement holds af exactly.
                al = alloc1 + glide_scale * m.astype(jnp.float32)
            else:
                al = alloc1
            ca1 = contrib * al
            ca2 = contrib - ca1
            b1, c1 = b1 + ca1, c1 + ca1
            b2, c2 = b2 + ca2, c2 + ca2

            b1, c1, b2, c2 = monthly_rebalance(b1, c1, b2, c2, al)

            if any_bills:
                def on_boundary(args):
                    bb1, cc1, bb2, cc2, gg1, gg2, pf = args
                    tb1, tc1, tb2, tc2, tfail = annual_tax(
                        bb1, cc1, bb2, cc2, gg1, gg2, al
                    )
                    return (tb1, tc1, tb2, tc2, gg1 * 0.0, gg2 * 0.0,
                            jnp.where(tfail, 1.0, pf))

                b1, c1, b2, c2, st[i_bills], st[i_bills + 1], st[i_bills + 2] = (
                    lax.cond(
                        _mod12(m) == 0,
                        on_boundary,
                        lambda a: a,
                        (b1, c1, b2, c2, st[i_bills], st[i_bills + 1],
                         st[i_bills + 2]),
                    )
                )
            if track:
                @pl.when(_mod12(m) == 0)
                def _():
                    slot = jnp.clip(
                        _div12(m), 0, traj_len - 1
                    ).astype(jnp.int32)
                    series_store(out_traj, slot, b1 + b2)
                    series_store(out_price, slot, infl)

            st[0], st[1], st[2], st[3], st[4] = b1, c1, b2, c2, infl
            return tuple(st)

        # ------------------------------------------------------------------
        # retirement snapshot (straight-line, once, right after month W)
        # ------------------------------------------------------------------
        def snapshot(st):
            st = list(st)
            if any_bills:
                killed = st[i_bills + 2] > 0.5  # pre-ret tax failure
                st[5] = jnp.where(killed, 0.0, st[5])
            # (Pre-retirement failures need no years_to_ruin bookkeeping:
            # their alive flag drops here, so the alive-months counter
            # simply never increments and the final /12 yields 0.)
            if track:
                total_rec = st[0] + st[2]
                infl_rec = st[4]
                # Retirement-start constants live in their outputs from here
                # on; the retirement loop reads them back only on the rare
                # record months.
                vstore(out_start, total_rec)
                vstore(out_inflret, infl_rec)
                slot = jnp.clip(full_wy + 1, 0, traj_len - 1).astype(jnp.int32)

                @pl.when(partial_wy == 1)
                def _():
                    series_store(out_traj, slot, total_rec)
                    series_store(out_price, slot, infl_rec)
            return tuple(st)

        # ------------------------------------------------------------------
        # retirement month (W < m <= t_end)
        # ------------------------------------------------------------------
        def ret_month(m, st):
            st = list(st)
            b1, c1, b2, c2, infl, alive_f = (
                st[0], st[1], st[2], st[3], st[4], st[5]
            )
            alive = alive_f > 0.5
            alive0_f = alive_f
            k = m - w
            ret_idx = k - 1
            ret_idx_f = ret_idx.astype(jnp.float32)
            k_mod = _mod12(k)
            if track:
                ytr, yg, yr = st[i_track:]
                new_year = k_mod == 1  # ret_idx % 12 == 0, k = ret_idx+1
                yg = jnp.where(new_year, 0.0, yg)
                yr = jnp.where(new_year, 0.0, yr)

            # --- income waterfall & net spending need
            price0 = infl
            if st_.guardrails:
                # Year-start guardrail check (years 1+; year 0 spends the
                # plan): planned WR against the balance entering the month.
                smult = st[i_spend]
                planned = 12.0 * f(F_EXPENSES) * smult * price0
                wr_now = planned / jnp.maximum(b1 + b2, EPS)
                s_new = jnp.where(
                    wr_now > f(F_GR_UP), smult * (1.0 - f(F_GR_ADJ)), smult
                )
                s_new = jnp.where(
                    wr_now < f(F_GR_LO), smult * (1.0 + f(F_GR_ADJ)), s_new
                )
                s_new = jnp.minimum(
                    jnp.maximum(s_new, f(F_GR_FLOOR)), f(F_GR_CAP)
                )
                at_year_start = (k_mod == 1) & (ret_idx > 0)
                smult = jnp.where(at_year_start & alive, s_new, smult)
                st[i_spend] = smult
                expenses_eff = f(F_EXPENSES) * smult
            else:
                expenses_eff = f(F_EXPENSES)
            net_income = None
            for s in range(n_streams):
                amount_s = cell(s_amount, s)
                active = ret_idx_f >= stream_start[s]
                if st_.stream_capped[s]:
                    active = active & (
                        ret_idx_f < stream_start[s] + cell(s_duration, s)
                    )
                if st_.stream_indexed[s]:
                    nominal = amount_s * price0
                else:
                    slot_f = i_fixed + fixed_slot[s]
                    fixed_s = jnp.where(
                        active & (ret_idx_f == stream_start[s])
                        & (st[slot_f] < 0),
                        amount_s * price0,
                        st[slot_f],
                    )
                    st[slot_f] = fixed_s
                    nominal = fixed_s
                inc = jnp.where(
                    active, nominal * (1.0 - cell(s_tax, s)), 0.0
                )
                net_income = inc if net_income is None else net_income + inc
            if net_income is None:
                need = expenses_eff * price0
            else:
                need = jnp.maximum(0.0, expenses_eff * price0 - net_income)
            if st_.mortality:
                # Spending (and the income offsetting it) ends with the
                # owner: zero need = no withdrawal and no possible ruin,
                # while the estate keeps evolving (growth, rebalance,
                # annual taxes) so the final balance is the bequest.
                living = ret_idx_f < d_mort
                need = jnp.where(living, need, 0.0)

            # --- ruin check A: broke before the month begins
            total0 = b1 + b2
            dies_a = alive & (total0 <= EPS) & (need > EPS)

            # --- market growth & inflation (dead/ruined paths freeze)
            g1, gi, g2 = draw(m)
            gmask = alive & ~dies_a
            if any_bills:
                st[i_bills] = st[i_bills] + jnp.where(
                    gmask, b1 * (g1 - 1.0), 0.0
                )
                st[i_bills + 1] = st[i_bills + 1] + jnp.where(
                    gmask, b2 * (g2 - 1.0), 0.0
                )
            b1 = jnp.where(gmask, b1 * g1, b1)
            b2 = jnp.where(gmask, b2 * g2, b2)
            infl = jnp.where(gmask, infl * gi, infl)

            # --- ruin check B: growth alone cannot fund the month (balances
            # are nonnegative after growth, so no clamp is needed)
            total1 = b1 + b2
            dies_b = gmask & (total1 <= EPS) & (need > EPS)
            wmask = gmask & ~dies_b
            wmask_f = jnp.where(wmask, 1.0, 0.0)

            # --- capacity-limited withdrawal, split pro-rata by net capacity
            eff1, nf1, nc1 = profile(b1, c1, st_.use_real1, r1)
            eff2, nf2, nc2 = profile(b2, c2, st_.use_real2, r2)
            tnc = nc1 + nc2
            ftol = EPS + FAIL_RTOL * (need + total1)
            frac_w = jnp.minimum(1.0, jnp.where(
                need >= tnc, 1.0, need / jnp.maximum(tnc, EPS)
            )) * wmask_f
            keep_w = 1.0 - frac_w
            ok1 = nc1 > 0
            ok2 = nc2 > 0
            gross1 = jnp.where(ok1, b1 * frac_w, 0.0)
            gross2 = jnp.where(ok2, b2 * frac_w, 0.0)
            nw = gross1 * nf1 + gross2 * nf2
            c1 = jnp.where(ok1, c1 * keep_w, c1)
            c2 = jnp.where(ok2, c2 * keep_w, c2)
            b1 = b1 - gross1
            b2 = b2 - gross2
            e1 = b1 <= EPS
            e2 = b2 <= EPS
            b1 = jnp.where(e1, 0.0, b1)
            c1 = jnp.where(e1, 0.0, c1)
            b2 = jnp.where(e2, 0.0, b2)
            c2 = jnp.where(e2, 0.0, c2)
            fail_net = wmask & (need > EPS) & (nw < need - ftol)
            if track:
                gw = gross1 + gross2  # zero where target was masked off
                yg = yg + gw
                # Deflated to T=0 dollars; the constant infl_ret factor
                # (retirement-$ conversion) is applied where yr is consumed.
                yr = yr + gw / jnp.maximum(price0, EPS)

            # --- monthly rebalance (gain fractions unchanged by the
            # proportional sale above, so the profiles are reusable)
            b1, c1, b2, c2 = rebalance_lite(
                b1, c1, b2, c2, eff1, eff2, alloc1_ret, extra_noop=~wmask
            )

            # --- annual taxes at absolute boundaries / terminal settle
            dies_pre = dies_a | dies_b | fail_net
            if any_bills:
                tmask_ok = wmask & ~fail_net
                is_boundary = (_mod12(m)) == 0
                is_settle = (m == t_end) & ((_mod12(w)) != 0)

                def apply_tax(args):
                    bb1, cc1, bb2, cc2, gg1, gg2 = args
                    tb1, tc1, tb2, tc2, tfail = annual_tax(
                        bb1, cc1, bb2, cc2, gg1, gg2, alloc1_ret
                    )
                    mask = (is_boundary & tmask_ok) | (
                        ~is_boundary & alive & ~dies_pre
                    )
                    return (
                        jnp.where(mask, tb1, bb1),
                        jnp.where(mask, tc1, cc1),
                        jnp.where(mask, tb2, bb2),
                        jnp.where(mask, tc2, cc2),
                        jnp.where(mask & is_boundary, 0.0, gg1),
                        jnp.where(mask & is_boundary, 0.0, gg2),
                        jnp.where(mask & tfail, 1.0, gg1 * 0.0),
                    )

                b1, c1, b2, c2, st[i_bills], st[i_bills + 1], tfail_f = (
                    lax.cond(
                        is_boundary | is_settle,
                        apply_tax,
                        lambda a: a + (a[4] * 0.0,),
                        (b1, c1, b2, c2, st[i_bills], st[i_bills + 1]),
                    )
                )
                dies = dies_pre | (tfail_f > 0.5)
                settle_failed = is_settle & (tfail_f > 0.5)
                dies_regular = dies & ~settle_failed
            else:
                dies = dies_pre
                dies_regular = dies

            alive_f = jnp.where(dies, 0.0, alive_f)
            if track:
                # Alive-months counter: a ruined path was alive at the start
                # of its death month, so the count freezes at exactly
                # ret_idx + 1 — including the settle-month tax failure,
                # where it freezes at R*12 (the final /12 gives R).
                # Survivors and mortality deaths (the estate keeps living)
                # count to R*12 and are mapped to NaN at the kernel end.
                ytr = ytr + alive0_f

                # First-year withdrawal capture: k <= 12 IS the year-0
                # window (ret_idx <= 11).
                @pl.when(k <= MONTHS_PER_YEAR)
                def _():
                    year_end = k_mod == 0
                    cap_fy = (alive0_f > 0.5) & (dies_regular | year_end)
                    vstore(out_fyg, jnp.where(cap_fy, yg, vload(out_fyg)))
                    vstore(out_fyr, jnp.where(
                        cap_fy, yr * vload(out_inflret), vload(out_fyr)
                    ))

                # Record-only work lives INSIDE the when: 11 of 12 months
                # skip it.
                @pl.when(k_mod == 0)
                def _():
                    slot = jnp.clip(
                        full_wy + partial_wy
                        + _div12(k + MONTHS_PER_YEAR - 1),
                        0, traj_len - 1,
                    ).astype(jnp.int32)
                    yslot = jnp.clip(
                        _div12(k) - 1, 0, R - 1
                    ).astype(jnp.int32)
                    total2 = b1 + b2
                    # Dead paths froze at death, so total2 is the at-death
                    # balance for deaths this year; older deaths pad zero.
                    # The alive-months counter IS the death month for dead
                    # paths; for still-alive paths it equals k, which the
                    # alive_now branch of the selects below absorbs.
                    death_k = ytr
                    y_f = (_div12(k) - 1).astype(jnp.float32)
                    died_this_year = (
                        death_k > y_f * MONTHS_PER_YEAR + 0.5
                    ) & (death_k < k.astype(jnp.float32) + 0.5)
                    alive_now = alive_f > 0.5
                    wmask_rec = alive_now | died_this_year
                    value_rec = jnp.where(
                        alive_now, total2, jnp.maximum(0.0, total2)
                    )
                    start_bal = vload(out_start)
                    wr_mask = (alive0_f > 0.5) & ~dies_regular
                    if st_.mortality:
                        # WR observations exist only for fully-lived years
                        # (at year end, ret_idx is the year's last month).
                        wr_mask = wr_mask & living
                    wr_value = jnp.where(
                        start_bal > EPS,
                        yr * vload(out_inflret)
                        / jnp.maximum(start_bal, EPS) * 100.0,
                        0.0,
                    )
                    old_t = out_traj[slot, cols]
                    series_store(
                        out_traj, slot, jnp.where(wmask_rec, value_rec, old_t)
                    )
                    # Unconditional: dead paths' infl froze at death, so this
                    # carries the at-death price level into post-death slots
                    # (reference padding, backend/simulation.py:902-937).
                    series_store(out_price, slot, infl)
                    old_w = out_wr[yslot, cols]
                    series_store(
                        out_wr, yslot, jnp.where(wr_mask, wr_value, old_w)
                    )

                st[i_track:] = [ytr, yg, yr]

            st[0], st[1], st[2], st[3], st[4], st[5] = (
                b1, c1, b2, c2, infl, alive_f
            )
            return tuple(st)

        state = lax.fori_loop(1, w + 1, accum_month, init)
        state = snapshot(state)
        final = lax.fori_loop(w + 1, t_end + 1, ret_month, state)

        vstore(out_success, final[5])
        vstore(out_final, jnp.maximum(0.0, final[0] + final[2]))
        if track:
            # years_to_ruin from the alive-months counter: still-alive
            # paths (survivors AND mortality deaths, whose estate lived
            # on) -> NaN; ruined paths -> death month / 12 (pre-retirement
            # kills counted zero months -> 0.0, the reference's value).
            ytr = final[i_track]
            vstore(out_ytr, jnp.where(
                final[5] > 0.5, jnp.float32(jnp.nan), ytr / MONTHS_PER_YEAR
            ))

    return kernel


def _pack_params(params: SimParams, working_months, retirement_years,
                 block_offset=0, antithetic=False):
    sq = math.sqrt(MONTHS_PER_YEAR)
    f32 = jnp.float32
    fp = jnp.stack(
        [
            params.mu1.astype(f32) / MONTHS_PER_YEAR,
            params.sigma1.astype(f32) / sq,
            params.mu_inf.astype(f32) / MONTHS_PER_YEAR,
            params.sigma_inf.astype(f32) / sq,
            params.mu_prem.astype(f32) / MONTHS_PER_YEAR,
            params.sigma_prem.astype(f32) / sq,
            params.rho.astype(f32),
            jnp.sqrt(jnp.maximum(0.0, 1.0 - params.rho.astype(f32) ** 2)),
            params.alloc1.astype(f32),
            params.initial_balance.astype(f32),
            params.monthly_contribution.astype(f32),
            jnp.log1p(params.contribution_growth.astype(f32)),
            params.monthly_expenses.astype(f32),
            params.real_tax1.astype(f32),
            params.ann_tax1.astype(f32),
            params.real_tax2.astype(f32),
            params.ann_tax2.astype(f32),
            params.alloc1_final.astype(f32),
            params.gr_upper.astype(f32),
            params.gr_lower.astype(f32),
            params.gr_adjust.astype(f32),
            params.gr_floor.astype(f32),
            params.gr_cap.astype(f32),
            params.jump_p.astype(f32),
            params.jump_mu.astype(f32),
            params.jump_sigma.astype(f32),
            params.jump_beta.astype(f32),
            params.jump_comp1.astype(f32),
            params.jump_comp2.astype(f32),
            params.mort_g0.astype(f32),
            params.mort_b12.astype(f32),
            params.mort_cap.astype(f32),
        ]
    )  # (NUM_FPARAMS,) or (NUM_FPARAMS, K) for a scenario batch
    pad = [(0, FPARAMS_PAD - NUM_FPARAMS)] + [(0, 0)] * (fp.ndim - 1)
    fp = jnp.pad(fp, pad)
    w = jnp.asarray(working_months, jnp.int32).reshape(-1)  # (K,) candidates
    offs = jnp.broadcast_to(jnp.asarray(block_offset, jnp.int32), w.shape)
    # Behind a barrier the flag stays data to the compiler too: iid and
    # antithetic runs then compile to the same program (a folded constant
    # lets XLA:CPU specialise the interpret-mode code, moving results by
    # an ulp).
    anti = lax.optimization_barrier(jnp.full(w.shape, int(antithetic), jnp.int32))
    ip = jnp.stack(
        [w, w + jnp.int32(MONTHS_PER_YEAR * retirement_years), offs, anti],
        axis=1,
    )  # (K, NUM_IPARAMS)
    return ip, fp


def _stream_inputs(params):
    f32 = jnp.float32
    return [
        params.stream_amount.astype(f32),
        params.stream_months_from_t0.astype(f32),
        jnp.minimum(
            params.stream_duration_months.astype(f32), jnp.float32(3.0e7)
        ),
        params.stream_indexed.astype(f32),
        params.stream_tax.astype(f32),
    ]


def _n_blocks(n_paths: int) -> int:
    return max(1, -(-n_paths // BLOCK_PATHS))


def _call(kernel, grid, inputs, out_shape, interpret, aliases=None):
    """One pallas_call on the Triton route: unblocked operands (the kernel
    indexes its own block of paths), 1-D program blocks of BLOCK_PATHS."""
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=out_shape,
        input_output_aliases=aliases or {},
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        name="mcrt_paths",
    )(*inputs)


def _inputs(params, seed, ip, fp, n_streams, shocks=None):
    inputs = [_key_words(seed), ip, fp]
    if n_streams:
        inputs += _stream_inputs(params)
    if shocks is not None:
        inputs.append(shocks.astype(jnp.float32))
    return inputs


@partial(
    jax.jit,
    static_argnames=("n_paths", "retirement_years", "n_streams", "statics",
                     "with_shocks", "interpret"),
)
def pallas_simulate(
    params: SimParams,
    working_months,
    seed,
    *,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    shocks: Optional[jnp.ndarray] = None,
    with_shocks: bool = False,
    interpret: bool = False,
    block_offset=0,
):
    """Probe-mode simulation: one working-months value, per-path outputs.

    ``seed`` is a raw threefry key (the engine's stream key, so the draws
    equal the scan's) or an integer seed. Returns (success_f32,
    final_balance) of shape (n_padded,); the caller slices [:n_paths].
    ``shocks`` (parity checks only): (T, C, n_padded) pre-drawn planes, see
    SHOCK_* for the plane layout.
    """
    assert n_streams == params.n_streams
    n_blocks = _n_blocks(n_paths)
    ip, fp = _pack_params(params, working_months, retirement_years,
                          block_offset, statics.antithetic and not with_shocks)
    if ip.shape[0] != 1:
        raise ValueError(
            f"pallas_simulate takes ONE working_months value, got "
            f"{ip.shape[0]} rows; use pallas_probe for candidate batches"
        )
    kernel = _make_kernel(n_streams, retirement_years, with_shocks, statics)
    vec = jax.ShapeDtypeStruct((1, n_blocks * BLOCK_PATHS), jnp.float32)
    success, final = _call(
        kernel, (n_blocks,),
        _inputs(params, seed, ip, fp, n_streams,
                shocks if with_shocks else None),
        [vec, vec], interpret,
    )
    return success.reshape(-1), final.reshape(-1)


@partial(
    jax.jit,
    static_argnames=("n_candidates", "n_paths", "retirement_years",
                     "n_streams", "statics", "interpret"),
)
def pallas_probe(
    params: SimParams,
    months,
    seed,
    *,
    n_candidates: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
    block_offset=0,
):
    """Candidate-parallel probe: one dispatch for a whole candidate batch.

    The grid is (path blocks, candidates); every program simulates its own
    candidate's working_months while the draws depend only on the path —
    all candidates see identical draws (common random numbers), exactly
    like the XLA probe path. Returns per-candidate success probabilities
    in percent, shape (n_candidates,).
    """
    assert n_streams == params.n_streams
    n_blocks = _n_blocks(n_paths)
    ip, fp = _pack_params(params, months, retirement_years, block_offset,
                          statics.antithetic)
    if ip.shape[0] != n_candidates:
        raise ValueError(
            f"months supplies {ip.shape[0]} candidate rows but the grid has "
            f"n_candidates={n_candidates}; each program reads its own row, "
            "so the counts must match exactly"
        )
    kernel = _make_kernel(
        n_streams, retirement_years, with_shocks=False, statics=statics,
        block_axis=0, cand_axis=1,
    )
    vec = jax.ShapeDtypeStruct(
        (n_candidates, n_blocks * BLOCK_PATHS), jnp.float32
    )
    success, _final = _call(
        kernel, (n_blocks, n_candidates),
        _inputs(params, seed, ip, fp, n_streams), [vec, vec], interpret,
    )
    return jnp.mean(success[:, :n_paths], axis=1) * 100.0


FULL_OUTPUTS = (
    "success", "final_balance", "start_balance", "years_to_ruin",
    "first_year_gross", "first_year_real_gross", "inflation_at_retirement",
    "trajectory", "price_levels", "withdrawal_rates",
)


@partial(
    jax.jit,
    static_argnames=("n_paths", "retirement_years", "n_streams", "statics",
                     "traj_len", "with_shocks", "interpret"),
)
def pallas_simulate_full(
    params: SimParams,
    working_months,
    seed,
    *,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    traj_len: int,
    shocks=None,
    with_shocks: bool = False,
    interpret: bool = False,
    block_offset=0,
):
    """Full-statistics simulation.

    Returns a dict of per-path arrays: success/final/start/ytr/fy_g/fy_r/
    infl_ret of shape (n_padded,), trajectory/price (n_padded, traj_len) and
    wr (n_padded, R). Same semantics as the XLA scan kernel's tracked mode.
    The kernel stores each recorded year as one row of a (len, n_padded)
    series, so no series buffer lives on chip; the wrapper transposes to
    the per-path layout.
    """
    assert n_streams == params.n_streams
    n_blocks = _n_blocks(n_paths)
    n_pad = n_blocks * BLOCK_PATHS
    ip, fp = _pack_params(params, working_months, retirement_years,
                          block_offset, statics.antithetic and not with_shocks)
    if ip.shape[0] != 1:
        raise ValueError(
            f"pallas_simulate_full takes ONE working_months value, got "
            f"{ip.shape[0]} rows; use pallas_probe for candidate batches"
        )
    R = retirement_years
    kernel = _make_kernel(
        n_streams, retirement_years, with_shocks=with_shocks,
        statics=statics, traj_len=traj_len,
    )
    inputs = _inputs(params, seed, ip, fp, n_streams,
                     shocks if with_shocks else None)
    f32 = jnp.float32
    init_bal = params.initial_balance.astype(f32)
    series_init = [
        jnp.zeros((traj_len, n_pad), f32).at[0].set(init_bal),
        jnp.ones((traj_len, n_pad), f32),
        jnp.full((R, n_pad), jnp.nan, f32),
    ]
    first = len(inputs)
    vec = jax.ShapeDtypeStruct((1, n_pad), f32)
    out_shape = [vec] * 7 + [
        jax.ShapeDtypeStruct(x.shape, f32) for x in series_init
    ]
    outs = _call(
        kernel, (n_blocks,), inputs + series_init, out_shape, interpret,
        aliases={first: 7, first + 1: 8, first + 2: 9},
    )
    vecs = [x.reshape(-1) for x in outs[:7]]
    series = [jnp.transpose(x) for x in outs[7:]]
    return dict(zip(FULL_OUTPUTS, vecs + series))


def pallas_scenario_grid(
    params_batch: SimParams,
    months,
    seed,
    **kwargs,
):
    """Public scenario-grid entry: validates (when values are concrete) that
    every row matches the compile-time ``statics`` before dispatching — a
    mixed batch would silently simulate rows under the wrong tax system.
    See ``_scenario_grid_call`` for the layout."""
    _check_grid_statics(params_batch, kwargs["statics"])
    return _pallas_scenario_grid_jit(params_batch, months, seed, **kwargs)


def pallas_scenario_grid_raw(
    params_batch: SimParams,
    months,
    seed,
    **kwargs,
):
    """Scenario grid returning the raw per-path outputs: (success, final)
    of shape (n_scenarios, n_padded) f32, caller slices [:, :n_paths].
    Same validation, grid layout and CRN draws as pallas_scenario_grid."""
    _check_grid_statics(params_batch, kwargs["statics"])
    return _pallas_scenario_grid_raw_jit(params_batch, months, seed, **kwargs)


def _scenario_grid_call(
    params_batch: SimParams,
    months,
    seed,
    *,
    n_scenarios: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
    block_offset=0,
):
    """Shared tracer for the scenario-grid dispatch: every (config,
    working_months) pair in one Pallas call.

    ``params_batch`` is a struct-of-arrays SimParams (leading scenario axis,
    see engine.scenario_batch.stack_params); the grid is (path blocks,
    scenarios) with per-row parameters and path-only draws, so the whole
    grid shares its draws (CRN across scenarios). All scenarios in a batch
    MUST share ``statics`` (same tax systems and stream structure) — the
    kernel bakes them into the executable. Use
    ``engine.scenario_batch.grid_statics(configs)``, which validates and
    returns the shared value; ``_check_grid_statics`` in the public entries
    rejects mismatched rows as a second line of defense. Returns (success,
    final) of shape (n_scenarios, n_padded) f32.
    """
    # Batched SimParams carry streams as (K, S); n_streams is the last axis.
    assert n_streams == int(params_batch.stream_amount.shape[-1])
    n_blocks = _n_blocks(n_paths)
    ip, fp_rows = _pack_params(params_batch, months, retirement_years,
                               block_offset, statics.antithetic)
    # _pack_params stacks per-parameter vectors of shape (K,) -> fp (NF, K);
    # the kernel wants rows per scenario: (K, NF).
    fp = jnp.transpose(fp_rows)
    if ip.shape[0] != n_scenarios or fp.shape[0] != n_scenarios:
        raise ValueError(
            f"scenario grid of n_scenarios={n_scenarios} needs one months "
            f"row and one SimParams row per scenario; got {ip.shape[0]} "
            f"months rows and {fp.shape[0]} parameter rows"
        )
    kernel = _make_kernel(
        n_streams, retirement_years, with_shocks=False, statics=statics,
        block_axis=0, cand_axis=1, multi_params=True,
    )
    vec = jax.ShapeDtypeStruct(
        (n_scenarios, n_blocks * BLOCK_PATHS), jnp.float32
    )
    success, final = _call(
        kernel, (n_blocks, n_scenarios),
        _inputs(params_batch, seed, ip, fp, n_streams), [vec, vec],
        interpret,
    )
    return success, final


@partial(
    jax.jit,
    static_argnames=("n_scenarios", "n_paths", "retirement_years",
                     "n_streams", "statics", "interpret"),
)
def _pallas_scenario_grid_jit(
    params_batch: SimParams,
    months,
    seed,
    *,
    n_scenarios: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
    block_offset=0,
):
    """Scenario-grid probe (see ``_scenario_grid_call``): returns success
    probabilities in percent, shape (n_scenarios,)."""
    success, _final = _scenario_grid_call(
        params_batch, months, seed,
        n_scenarios=n_scenarios, n_paths=n_paths,
        retirement_years=retirement_years, n_streams=n_streams,
        statics=statics, interpret=interpret, block_offset=block_offset,
    )
    return jnp.mean(success[:, :n_paths], axis=1) * 100.0


@partial(
    jax.jit,
    static_argnames=("n_scenarios", "n_paths", "retirement_years",
                     "n_streams", "statics", "interpret"),
)
def _pallas_scenario_grid_raw_jit(
    params_batch: SimParams,
    months,
    seed,
    *,
    n_scenarios: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
    block_offset=0,
):
    """Scenario grid returning raw (success, final) per-path arrays of
    shape (n_scenarios, n_padded); see ``_scenario_grid_call``."""
    return _scenario_grid_call(
        params_batch, months, seed,
        n_scenarios=n_scenarios, n_paths=n_paths,
        retirement_years=retirement_years, n_streams=n_streams,
        statics=statics, interpret=interpret, block_offset=block_offset,
    )


# ---------------------------------------------------------------------------
# Several devices: the kernels under shard_map over a 'paths' mesh axis
# ---------------------------------------------------------------------------

_SHARDED_CACHE: dict = {}


def pallas_probe_sharded(
    params: SimParams,
    months,
    seed,
    *,
    mesh,
    n_candidates: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
    block_offset=0,
):
    """Candidate probe data-parallel over a device mesh's first axis.

    Each device runs ``local_blocks`` path blocks at GLOBAL block ids
    (device_index * local_blocks + local block); the draws are keyed by
    global path, so common random numbers across candidates hold exactly
    as on one device, and an n-device run reproduces the one-device run
    that uses the same global block count. The path count rounds up to
    whole blocks per device; probabilities average over all simulated
    paths. Per-candidate success means reduce with a pmean.

    ``block_offset`` (traced) shifts every device's global block ids so
    Engine.probe can chunk a beyond-budget path count into mesh-sized
    dispatches that together cover the same global block sequence.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    local_blocks = _local_blocks(n_paths, n_dev, BLOCK_PATHS)
    local_pad = local_blocks * BLOCK_PATHS

    key = (
        "probe", mesh, n_candidates, local_blocks, retirement_years,
        n_streams, statics, interpret,
    )
    fn = _SHARDED_CACHE.get(key)
    if fn is None:

        def shard_fn(params, months, seed, base_offset):
            offset = base_offset + (
                jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(local_blocks)
            )
            local = pallas_probe(
                params, months, seed,
                n_candidates=n_candidates,
                n_paths=local_pad,
                retirement_years=retirement_years,
                n_streams=n_streams,
                statics=statics,
                interpret=interpret,
                block_offset=offset,
            )
            # equal local path counts on every shard: global mean = mean of
            # shard means
            return jax.lax.pmean(local, axis)

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        _SHARDED_CACHE[key] = fn
    return fn(
        params,
        jnp.asarray(months, jnp.int32),
        _key_words(seed),
        jnp.asarray(block_offset, jnp.int32),
    )


def pallas_simulate_sharded(
    params: SimParams,
    working_months,
    seed,
    *,
    mesh,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
):
    """Probe-mode simulation sharded over a 'paths' mesh: returns
    (success_f32, final_balance) with the leading axis sharded across
    devices (n_dev * local_pad entries; caller slices [:n_paths]). Draws are
    keyed by global path exactly like ``pallas_probe_sharded``."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    local_blocks = _local_blocks(n_paths, n_dev, BLOCK_PATHS)
    local_pad = local_blocks * BLOCK_PATHS

    key = (
        "simulate", mesh, local_blocks, retirement_years, n_streams,
        statics, interpret,
    )
    fn = _SHARDED_CACHE.get(key)
    if fn is None:

        def shard_fn(params, w, seed):
            offset = (
                jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(local_blocks)
            )
            return pallas_simulate(
                params, w, seed,
                n_paths=local_pad,
                retirement_years=retirement_years,
                n_streams=n_streams,
                statics=statics,
                interpret=interpret,
                block_offset=offset,
            )

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(), P()),
                out_specs=P(axis),
                check_vma=False,
            )
        )
        _SHARDED_CACHE[key] = fn
    return fn(
        params,
        jnp.asarray(working_months, jnp.int32),
        _key_words(seed),
    )


def pallas_scenario_grid_sharded(
    params_batch: SimParams,
    months,
    seed,
    *,
    mesh,
    n_scenarios: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
):
    """Scenario-grid probe data-parallel over a 'paths' mesh: every device
    simulates its share of paths for ALL scenarios (global-path draws keep
    CRN across the grid), per-scenario success means reduce with a pmean.
    Path count rounds up to whole blocks per device."""
    from jax.sharding import PartitionSpec as P

    _check_grid_statics(params_batch, statics)
    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    local_blocks = _local_blocks(n_paths, n_dev, BLOCK_PATHS)
    local_pad = local_blocks * BLOCK_PATHS

    key = (
        "grid", mesh, n_scenarios, local_blocks, retirement_years,
        n_streams, statics, interpret,
    )
    fn = _SHARDED_CACHE.get(key)
    if fn is None:

        def shard_fn(params_batch, months, seed):
            offset = (
                jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(local_blocks)
            )
            local = pallas_scenario_grid(
                params_batch, months, seed,
                n_scenarios=n_scenarios,
                n_paths=local_pad,
                retirement_years=retirement_years,
                n_streams=n_streams,
                statics=statics,
                interpret=interpret,
                block_offset=offset,
            )
            return jax.lax.pmean(local, axis)

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        _SHARDED_CACHE[key] = fn
    return fn(
        params_batch,
        jnp.asarray(months, jnp.int32),
        _key_words(seed),
    )


def pallas_scenario_grid_raw_sharded(
    params_batch: SimParams,
    months,
    seed,
    *,
    mesh,
    n_scenarios: int,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    interpret: bool = False,
):
    """Scenario grid over a 'paths' mesh returning raw per-path arrays:
    (success, final) of shape (n_scenarios, n_dev * local_pad) sharded on
    the path axis. Downstream reductions (means, the selection-based
    percentiles) run under jit with sharding propagation, so their path-axis
    sums lower to collectives — no host gather. Global-path draws keep the
    grid's CRN and make an n-device run reproduce 1-device."""
    from jax.sharding import PartitionSpec as P

    _check_grid_statics(params_batch, statics)
    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    local_blocks = _local_blocks(n_paths, n_dev, BLOCK_PATHS)
    local_pad = local_blocks * BLOCK_PATHS

    key = (
        "grid_raw", mesh, n_scenarios, local_blocks, retirement_years,
        n_streams, statics, interpret,
    )
    fn = _SHARDED_CACHE.get(key)
    if fn is None:

        def shard_fn(params_batch, months, seed):
            offset = (
                jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(local_blocks)
            )
            return _pallas_scenario_grid_raw_jit(
                params_batch, months, seed,
                n_scenarios=n_scenarios,
                n_paths=local_pad,
                retirement_years=retirement_years,
                n_streams=n_streams,
                statics=statics,
                interpret=interpret,
                block_offset=offset,
            )

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(), P()),
                out_specs=(P(None, axis), P(None, axis)),
                check_vma=False,
            )
        )
        _SHARDED_CACHE[key] = fn
    return fn(
        params_batch,
        jnp.asarray(months, jnp.int32),
        _key_words(seed),
    )


def pallas_simulate_full_sharded(
    params: SimParams,
    working_months,
    seed,
    *,
    mesh,
    n_paths: int,
    retirement_years: int,
    n_streams: int,
    statics: Statics,
    traj_len: int,
    interpret: bool = False,
    block_offset=0,
):
    """Full-statistics simulation sharded over a 'paths' mesh.

    Per-path vectors come back sharded on their leading axis and the yearly
    series on their path axis (same dict layout as ``pallas_simulate_full``,
    n_dev * local_pad entries; caller slices [:n_paths]). Global-path draws
    make an n-device run reproduce the one-device run bit for bit.

    ``block_offset`` (traced, so it reuses the executable) shifts every
    device's global block ids — Engine._run_chunked uses it to split a
    beyond-budget run into mesh-sized chunks whose union is the unchunked
    run path for path.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = int(mesh.shape[axis])
    local_blocks = _local_blocks(n_paths, n_dev, BLOCK_PATHS)
    local_pad = local_blocks * BLOCK_PATHS

    key = (
        "full", mesh, local_blocks, retirement_years, n_streams, statics,
        traj_len, interpret,
    )
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        out_specs = {
            name: (P(axis) if name not in
                   ("trajectory", "price_levels", "withdrawal_rates")
                   else P(axis, None))
            for name in FULL_OUTPUTS
        }

        def shard_fn(params, w, seed, base_offset):
            offset = base_offset + (
                jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(local_blocks)
            )
            return pallas_simulate_full(
                params, w, seed,
                n_paths=local_pad,
                retirement_years=retirement_years,
                n_streams=n_streams,
                statics=statics,
                traj_len=traj_len,
                interpret=interpret,
                block_offset=offset,
            )

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(), P(), P()),
                out_specs=out_specs,
                check_vma=False,
            )
        )
        _SHARDED_CACHE[key] = fn
    return fn(
        params,
        jnp.asarray(working_months, jnp.int32),
        _key_words(seed),
        jnp.asarray(block_offset, jnp.int32),
    )

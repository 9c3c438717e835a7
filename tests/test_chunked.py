"""Path-count chunking: a run split over device-sized chunks must equal the
single-dispatch run (SURVEY §5's device-memory OOM guard).

The kernel keys its draws by GLOBAL path index, so chunk c with
block_offset c*B simulates exactly the paths the unchunked run would; these
tests pin that equality in interpret mode on tiny budgets.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import make_config
from monte_carlo_retirement_tpu.engine.pallas_kernel import (
    BLOCK_PATHS,
    pallas_probe,
    pallas_simulate_full,
)
from monte_carlo_retirement_tpu.engine.runner import Engine

# Chunks of two kernel blocks: XLA:CPU specialises a one-step interpret
# grid, which can move float32 results by an ulp against a longer grid.
BLOCK = 2 * BLOCK_PATHS


def _engine(**overrides):
    cfg = make_config(retirement_years=2, seed=11, **overrides)
    return Engine(cfg, dtype=jnp.float32)


def _unchunked_reference(eng, w, n, traj_len):
    full = pallas_simulate_full(
        eng.params, jnp.asarray(w, jnp.int32), eng._key("final"),
        n_paths=n, retirement_years=eng.retirement_years,
        n_streams=eng.params.n_streams, statics=eng.statics,
        traj_len=traj_len, interpret=True,
    )
    return {k: np.asarray(v[:n]) for k, v in full.items()}


def _unchunked_series_tables(ref, sample_idx):
    """The single-dispatch device reduction over the reference arrays —
    the bit-equality target for the chunked band tables and samples."""
    from monte_carlo_retirement_tpu.ops.stats import series_summary

    out = series_summary(
        jnp.asarray(ref["trajectory"]),
        jnp.asarray(ref["price_levels"]),
        jnp.asarray(ref["withdrawal_rates"]),
        sample_idx,
    )
    return [np.asarray(t) for t in out]


def test_chunked_run_equals_single_dispatch(monkeypatch):
    """Two chunks reproduce every field of the unchunked run bit for bit —
    including the per-year band tables, which the additive-count search
    (ops/chunked_quantiles.py) computes exactly over ALL paths."""
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK))
    eng = _engine()
    n, w = 2 * BLOCK, 6
    traj_len = eng._pallas_traj_len(w)
    # Sample rows from BOTH chunks (the gather crosses the chunk boundary).
    sample_idx = jnp.asarray(
        [0, 3, BLOCK + 1, 2 * BLOCK - 1, 7], dtype=jnp.int32
    )

    res = eng._run_chunked(
        w, n, "final", False, traj_len, sample_idx, interpret=True
    )

    ref = _unchunked_reference(eng, w, n, traj_len)
    np.testing.assert_array_equal(res.success, ref["success"] > 0.5)
    np.testing.assert_array_equal(res.final_balance, ref["final_balance"])
    np.testing.assert_array_equal(res.start_balance, ref["start_balance"])

    (traj_pcts, real_pcts, samples, samples_real, wr_pcts,
     wr_counts) = _unchunked_series_tables(ref, sample_idx)
    L = res.trajectory_percentiles.shape[1]
    np.testing.assert_array_equal(res.trajectory_percentiles,
                                  traj_pcts[:, :L])
    np.testing.assert_array_equal(res.real_trajectory_percentiles,
                                  real_pcts[:, :L])
    np.testing.assert_array_equal(res.wr_percentiles, wr_pcts)
    np.testing.assert_array_equal(res.sample_trajectories, samples[:, :L])
    np.testing.assert_array_equal(res.sample_real_trajectories,
                                  samples_real[:, :L])
    np.testing.assert_array_equal(res.wr_observation_counts, wr_counts)


def test_chunked_reduced_bins_exact(monkeypatch):
    """Reduced mode on a chunked run: serving bins computed from the merged
    vectors equal the single-dispatch bins."""
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK))
    # Spend enough that a visible share of paths fail (non-trivial bins):
    # 24 months x $5.5k indexed needs ~$135k against $120k at t=0.
    eng = _engine(initial_balance=120_000.0, monthly_expenses=5_500.0)
    n, w = 2 * BLOCK, 0
    traj_len = eng._pallas_traj_len(w)
    sample_idx = jnp.arange(5, dtype=jnp.int32)

    res = eng._run_chunked(
        w, n, "final", True, traj_len, sample_idx, interpret=True
    )
    assert res.success is None and res.bins is not None

    ref = _unchunked_reference(eng, w, n, traj_len)
    succ = ref["success"] > 0.5
    assert res.bins.success_count == int(succ.sum())
    assert 0 < res.bins.success_count < n
    wins = ref["final_balance"][succ]
    assert res.bins.finals_min_successful == pytest.approx(wins.min())
    assert res.bins.finals_max_successful == pytest.approx(wins.max())
    assert res.bins.finals_hist_counts.sum() == len(wins)
    ytr = ref["years_to_ruin"]
    failed = ~succ & ~np.isnan(ytr)
    assert res.bins.failure_count == int(failed.sum())
    assert res.success_probability == pytest.approx(succ.mean() * 100.0)
    assert res.median_start_balance == pytest.approx(
        np.median(ref["start_balance"]), rel=1e-6
    )
    # Band tables are exact over ALL paths in reduced mode too (a run with
    # real failures exercises the WR NaN masking through the search).
    sample_idx = jnp.arange(5, dtype=jnp.int32)
    (traj_pcts, real_pcts, _s, _sr, wr_pcts,
     wr_counts) = _unchunked_series_tables(ref, sample_idx)
    L = res.trajectory_percentiles.shape[1]
    np.testing.assert_array_equal(res.trajectory_percentiles,
                                  traj_pcts[:, :L])
    np.testing.assert_array_equal(res.real_trajectory_percentiles,
                                  real_pcts[:, :L])
    np.testing.assert_array_equal(res.wr_percentiles, wr_pcts)
    np.testing.assert_array_equal(res.wr_observation_counts, wr_counts)


def test_sharded_chunked_union_equals_single_device(monkeypatch):
    """sharded=True chunking: two mesh-sized chunks of the shard_map'd full
    kernel reproduce the unchunked SINGLE-DEVICE run bit for bit (chunk
    sizes are multiples of n_dev * block, so per-device block numbering is
    globally contiguous across chunks)."""
    import jax

    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 8  # conftest forces 8 virtual CPU devices
    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK))
    n, w = 2 * n_dev * BLOCK, 6

    cfg = make_config(retirement_years=2, seed=11)
    eng = Engine(cfg, dtype=jnp.float32, mesh=mesh)
    traj_len = eng._pallas_traj_len(w)
    sample_idx = jnp.arange(5, dtype=jnp.int32)

    res = eng._run_chunked(
        w, n, "final", False, traj_len, sample_idx,
        interpret=True, sharded=True,
    )

    ref = _unchunked_reference(eng, w, n, traj_len)
    np.testing.assert_array_equal(res.success, ref["success"] > 0.5)
    np.testing.assert_array_equal(res.final_balance, ref["final_balance"])
    np.testing.assert_array_equal(res.start_balance, ref["start_balance"])
    np.testing.assert_array_equal(
        res.wr_observation_counts,
        (~np.isnan(ref["withdrawal_rates"])).sum(axis=0),
    )
    # Band tables exact across BOTH the mesh and the chunk boundary.
    (traj_pcts, real_pcts, samples, _sr, wr_pcts,
     _wc) = _unchunked_series_tables(ref, sample_idx)
    L = res.trajectory_percentiles.shape[1]
    np.testing.assert_array_equal(res.trajectory_percentiles,
                                  traj_pcts[:, :L])
    np.testing.assert_array_equal(res.real_trajectory_percentiles,
                                  real_pcts[:, :L])
    np.testing.assert_array_equal(res.wr_percentiles, wr_pcts)
    np.testing.assert_array_equal(res.sample_trajectories, samples[:, :L])


def test_run_routes_oversized_sharded_to_chunked(monkeypatch):
    """Engine.run sends a beyond-budget run on a mesh Engine into
    _run_chunked(sharded=True) with the n_dev-scaled threshold: n_dev
    budgets fit unchunked, one path more chunks."""
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    monkeypatch.setenv("MCRT_MAX_DEVICE_PATHS", str(BLOCK))
    mesh = make_mesh()
    n_dev = 8
    cfg = make_config(retirement_years=2, seed=11)
    eng = Engine(cfg, dtype=jnp.float32, mesh=mesh)

    calls = []

    def fake_chunked(working_months, n, stream, reduced, traj_len,
                     sample_idx, interpret=False, sharded=False):
        calls.append((n, sharded))
        return "sentinel"

    monkeypatch.setattr(eng, "_run_chunked", fake_chunked)
    out = eng.run(6, n_dev * BLOCK + 1, backend="pallas_sharded")
    assert out == "sentinel"
    assert calls == [(n_dev * BLOCK + 1, True)]


def test_sharded_chunked_probe_matches_single_dispatch():
    """Mesh-sized probe chunks with block offsets merge (weighted by
    simulated count) to the single sharded dispatch's probabilities."""
    import jax

    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_probe_sharded,
    )
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 8
    eng = _engine()
    months = jnp.asarray([0, 6, 12, 18] * 4, dtype=jnp.int32)
    n = 2 * n_dev * BLOCK_PATHS
    kwargs = dict(
        mesh=mesh, n_candidates=16, retirement_years=eng.retirement_years,
        n_streams=eng.params.n_streams, statics=eng.statics, interpret=True,
    )
    seed = eng._key("search")
    whole = np.asarray(pallas_probe_sharded(
        eng.params, months, seed, n_paths=n, **kwargs
    ))
    part0 = np.asarray(pallas_probe_sharded(
        eng.params, months, seed, n_paths=n // 2,
        block_offset=jnp.asarray(0, jnp.int32), **kwargs,
    ))
    part1 = np.asarray(pallas_probe_sharded(
        eng.params, months, seed, n_paths=n // 2,
        block_offset=jnp.asarray(n_dev, jnp.int32), **kwargs,
    ))
    np.testing.assert_allclose(0.5 * part0 + 0.5 * part1, whole, atol=1e-4)


def test_probe_routes_oversized_sharded_to_chunks(monkeypatch):
    """Engine.probe on a mesh chunks past n_dev probe budgets, dispatching
    contiguous global block offsets and simulated-count weights (the ragged
    tail still pads to whole per-device blocks, exactly like the unchunked
    sharded call would)."""
    from monte_carlo_retirement_tpu.engine import pallas_kernel as pk
    from monte_carlo_retirement_tpu.parallel.mesh import make_mesh

    monkeypatch.setenv("MCRT_MAX_PROBE_PATHS", str(BLOCK_PATHS))
    mesh = make_mesh()
    n_dev, unit = 8, 8 * BLOCK_PATHS
    cfg = make_config(retirement_years=2, seed=11)
    eng = Engine(cfg, dtype=jnp.float32, mesh=mesh)

    calls = []

    def fake_probe_sharded(params, months, seed, *, n_paths,
                           block_offset=0, **kw):
        calls.append((n_paths, int(np.asarray(block_offset))))
        return jnp.full((16,), 50.0, dtype=jnp.float32)

    monkeypatch.setattr(pk, "pallas_probe_sharded", fake_probe_sharded)
    monkeypatch.setattr(eng, "_resolve_probe_backend",
                        lambda backend: "pallas_sharded")
    out = eng.probe([6], 2 * unit + 5)
    # Chunks cover [0, unit), [unit, 2*unit), [2*unit, 2*unit+5); the tail
    # pads to one block per device, so offsets advance by n_dev each time
    # and the three equal simulated counts give an unweighted mean.
    assert calls == [(unit, 0), (unit, n_dev), (5, 2 * n_dev)]
    assert out == [pytest.approx(50.0)]


def test_chunked_probe_weighted_merge():
    """The probe's chunk merge (weighted mean over global-block chunks)
    equals the single-dispatch probability."""
    eng = _engine()
    months = jnp.asarray([0, 6, 12, 18] * 4, dtype=jnp.int32)
    n = 2 * BLOCK_PATHS
    kwargs = dict(
        n_candidates=16, retirement_years=eng.retirement_years,
        n_streams=eng.params.n_streams, statics=eng.statics, interpret=True,
    )
    whole = np.asarray(pallas_probe(
        eng.params, months, eng._key("search"), n_paths=n, **kwargs
    ))
    part0 = np.asarray(pallas_probe(
        eng.params, months, eng._key("search"),
        n_paths=BLOCK_PATHS, block_offset=jnp.asarray(0, jnp.int32),
        **kwargs,
    ))
    part1 = np.asarray(pallas_probe(
        eng.params, months, eng._key("search"),
        n_paths=BLOCK_PATHS, block_offset=jnp.asarray(1, jnp.int32),
        **kwargs,
    ))
    merged = 0.5 * part0 + 0.5 * part1
    np.testing.assert_allclose(merged, whole, atol=1e-4)


def test_band_search_seeded_brackets_bit_identical():
    """seed_intervals (the runner's warm start) never changes a bit: over
    random chunked data with duplicates, signed zeros, empty columns and
    extreme magnitudes, the seeded search returns tables bit-identical to
    the unseeded search AND to numpy nanpercentile, in no more rounds."""
    from monte_carlo_retirement_tpu.ops.chunked_quantiles import (
        exact_quantiles_chunked,
        snap_zero_band,
    )

    rng = np.random.default_rng(20260820)
    qs = np.asarray([0.05, 0.25, 0.5, 0.75, 0.95], np.float32)
    for trial in range(10):
        n_chunks = int(rng.integers(2, 6))
        sizes = rng.integers(3, 400, size=n_chunks)
        C = int(rng.integers(1, 9))
        chunks, valids, rows = [], [], []
        for s in sizes:
            x = np.empty((s, C), np.float32)
            for c in range(C):
                kind = rng.integers(0, 5)
                if kind == 0:  # heavy duplicates
                    x[:, c] = rng.choice(
                        np.asarray([0.0, -0.0, 1.0, 2.5], np.float32), size=s
                    )
                elif kind == 1:  # extreme magnitudes
                    x[:, c] = rng.choice([1e-38, 1e30, -1e30, 3e-39], size=s)
                elif kind == 2:  # constant column
                    x[:, c] = np.float32(trial - 2)
                else:
                    x[:, c] = rng.normal(scale=10.0 ** rng.integers(-3, 6),
                                         size=s)
            v = rng.random((s, C)) < rng.random()
            if trial % 3 == 0:
                v[:, 0] = False  # a column empty in EVERY chunk
            chunks.append(x)
            valids.append(v)
            rows.append(np.where(v, x, np.nan))
        plain = exact_quantiles_chunked(chunks, qs, valids)
        seeded = exact_quantiles_chunked(chunks, qs, valids,
                                         seed_brackets=True)
        np.testing.assert_array_equal(seeded, plain)
        # Independent semantic reference: sorted selection + the SAME f32
        # interpolation arithmetic the search documents (h and frac in
        # f32 — bit-faithful to the device reducer — then lerp, NaN for
        # empty columns, zero-band snap). Must match BIT-EXACTLY.
        stacked = np.concatenate(rows, axis=0)
        nv = np.sum(~np.isnan(stacked), axis=0).astype(np.int64)
        srt = np.sort(
            np.where(np.isnan(stacked), np.float32(np.inf), stacked), axis=0
        )
        nv_f = np.maximum(nv - 1, 0).astype(np.float32)
        h = (qs[:, None] * nv_f[None, :]).astype(np.float32)
        lo_rank = np.floor(h).astype(np.int64)
        frac = (h - lo_rank.astype(np.float32)).astype(np.float32)
        cols = np.arange(stacked.shape[1])[None, :]
        v_lo = srt[lo_rank, cols]
        v_hi = srt[np.minimum(lo_rank + 1, stacked.shape[0] - 1), cols]
        want = np.where(
            frac == 0, v_lo,
            (v_lo + frac * (v_hi - v_lo)).astype(np.float32),
        )
        want = snap_zero_band(
            np.where(nv[None, :] > 0, want, np.float32(np.nan))
        )
        np.testing.assert_array_equal(seeded, want)


def test_band_search_seeded_rounds_shrink():
    """On realistic homogeneous chunk data the seed collapses the search
    to a handful of rounds — the property the 16M headline rides on."""
    from monte_carlo_retirement_tpu.ops.chunked_quantiles import (
        BandSearch, bracket_ranks,
    )

    rng = np.random.default_rng(7)
    qs = np.asarray([0.05, 0.5, 0.95], np.float32)
    chunks = [rng.normal(loc=100.0, size=(50_000, 3)).astype(np.float32)
              for _ in range(4)]
    n_valid = np.full((3,), 200_000, dtype=np.int64)

    def drive(seed):
        search = BandSearch([qs], [n_valid])
        if seed:
            margin = len(chunks) + 8
            lo_acc = hi_acc = None
            for x in chunks:
                nv_c = np.full(3, x.shape[0], dtype=np.int64)
                lo_r, hi_r = bracket_ranks(qs, nv_c, margin)
                srt = np.sort(x, axis=0)
                cols = np.arange(3)[:, None]
                lo_v, hi_v = srt[lo_r, cols], srt[hi_r, cols]
                lo_acc = lo_v if lo_acc is None else np.minimum(lo_acc, lo_v)
                hi_acc = hi_v if hi_acc is None else np.maximum(hi_acc, hi_v)
            search.seed_intervals([lo_acc], [hi_acc])
        while not search.resolved:
            edges = search.edges()[0]
            total = np.zeros(edges.shape, dtype=np.int64)
            for x in chunks:
                total += (x[:, :, None] <= edges[None, :, :]).sum(axis=0)
            search.update([total])
        return search.rounds, search.floor_values()[0]

    rounds_plain, v_plain = drive(False)
    rounds_seeded, v_seeded = drive(True)
    np.testing.assert_array_equal(v_seeded, v_plain)
    assert rounds_seeded <= 4 < rounds_plain


def test_band_search_seed_misuse_raises():
    from monte_carlo_retirement_tpu.ops.chunked_quantiles import BandSearch

    qs = np.asarray([0.5], np.float32)
    search = BandSearch([qs], [np.asarray([8], np.int64)])
    with pytest.raises(ValueError):
        search.seed_intervals([np.zeros((2, 2), np.float32)],
                              [np.ones((2, 2), np.float32)])
    edges = search.edges()[0]
    search.update([np.full(edges.shape, 8, dtype=np.int64)])
    with pytest.raises(RuntimeError):
        search.seed_intervals([np.zeros((1, 1), np.float32)],
                              [np.ones((1, 1), np.float32)])

"""Engine: the compiled-run orchestrator.

Owns seed/stream management, backend selection (XLA scan vs Pallas vs
sharded Pallas), candidate batching for the search, device
placement/sharding, and host-side result assembly.

Compilation model: every user-editable scenario number is a traced input —
editing rates/amounts/ages re-runs the same executable. Only structural
changes recompile, and jit caches each combination:
  * Pallas kernels: (retirement_years, pruned stream count, Statics, path
    blocks) — month loops have dynamic bounds, so working months never
    enter the key and the full-stats trajectory width is scenario-static.
  * XLA scan kernels: the above plus a 60-month scan-length bucket
    (lax.scan needs static trip counts).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constants import (
    MAX_SEARCH_YEARS,
    MONTHS_PER_YEAR,
    NUM_SAMPLE_PATHS,
    SMALL_EPSILON,
    TRAJECTORY_PERCENTILES,
    WITHDRAWAL_RATE_PERCENTILES,
)
from ..logging_utils import generate_seed_from_timestamp
from ..models.retirement import SimParams
from ..ops.quantiles import _count_dtype, _search_floor_values_parts
from ..ops.shocks import stream_keys
from ..ops.stats import serving_bins, summarize
from ..timing import expected_trajectory_length
from .kernel import PathOutputs, simulate_paths

log = logging.getLogger("mcrt.engine")

# Scan lengths are rounded up to this many months so that nearby
# working-month values reuse one executable (must be a multiple of 12).
SCAN_BUCKET_MONTHS = 60

# Candidate batches are padded to this width so every probe call — ladder or
# verification sweep — reuses a single compiled executable.
PROBE_WIDTH = 16


def max_device_paths() -> int:
    """Full-statistics path budget per device dispatch. Beyond it a run is
    split into chunks (SURVEY §5's OOM guard): the full-mode kernel writes
    ~(2L + R) * 4 bytes of yearly series per path to device memory and the
    wrapper transposes them once, so 4M paths of a 70-year scenario hold
    ~8 GB of series — about a tenth of an H100's 80 GB. The bound is a
    constant, not derived from the device's memory."""
    return int(os.environ.get("MCRT_MAX_DEVICE_PATHS", str(4 * 2**20)))


def max_probe_paths() -> int:
    """Probe-mode budget per dispatch (success/final vectors only — a few
    bytes per path); chunked above it, merged as a weighted mean."""
    return int(os.environ.get("MCRT_MAX_PROBE_PATHS", str(16 * 2**20)))


def verify_compilation_cache(cache_dir: str) -> int:
    """Delete corrupt persistent-cache entries; return how many were removed.

    jax's LRU file cache writes entries with a bare, non-atomic
    ``Path.write_bytes`` and (with eviction disabled) no lock, so a process
    killed mid-write — or two processes racing the same key — can leave a
    truncated/garbled file. Reading one later crashes INSIDE XLA's native
    executable deserialization (observed: SIGSEGV under jax
    compilation_cache.get_executable_and_time), which no Python try/except
    can survive. The guard re-runs jax's own decompression + framing parse
    on every entry up front — pure Python, so corruption surfaces as a
    catchable exception — and deletes entries that fail, which merely costs
    a recompile. ~0.2 s for a ~50 MB cache; runs once per process.
    """
    removed = 0
    try:
        from jax._src import compilation_cache as _cc

        for name in os.listdir(cache_dir):
            if not name.endswith("-cache"):
                continue
            path = os.path.join(cache_dir, name)
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
                # Decompress exactly the way a cache hit would: a torn
                # write fails the compressed-frame parse here, as a clean
                # Python exception instead of a native crash later. (The
                # framing split itself never raises, so the frame check is
                # the decompression plus a minimal length floor.)
                payload = _cc.decompress_executable(raw)
                if len(payload) <= 4:
                    raise ValueError("cache entry too short to hold an executable")
            except Exception:
                removed += 1
                log.warning("removing corrupt compile-cache entry %s", name)
                for victim in (path, path[: -len("-cache")] + "-atime"):
                    try:
                        os.remove(victim)
                    except OSError:
                        pass
    except Exception as exc:  # pragma: no cover - best-effort guard
        log.debug("compile-cache verification skipped: %s", exc)
    return removed


_CACHE_READY = False


def _make_cache_writes_atomic() -> None:
    """Patch jax's file-cache ``put`` to publish entries atomically.

    With eviction disabled (the default), ``LRUCache.put`` writes entries
    with a bare ``Path.write_bytes`` and NO lock — so any concurrent
    reader (a second serving process, a multi-controller worker, a
    parallel test run) can observe a torn entry, and deserializing one
    crashes natively: observed as a SIGSEGV inside
    ``compilation_cache.get_executable_and_time`` mid-suite, and as a
    gloo "Received data size doesn't match" abort when two distributed
    workers raced the same key. Writing to a unique temp file and
    ``os.replace``-ing it into place makes every entry appear atomically;
    duplicate concurrent compiles simply last-write-win the same bytes.
    (The startup integrity sweep still guards entries torn by a process
    killed before this patch existed.)"""
    try:
        from jax._src import lru_cache as _lru
    except Exception:  # pragma: no cover - cache impl moved/unavailable
        return
    if getattr(_lru.LRUCache, "_mcrt_atomic_put", False):
        return
    orig_put = _lru.LRUCache.put

    def atomic_put(self, key, val):
        if self.eviction_enabled or not key:
            # Evicting caches take a real lock upstream; keep their path.
            return orig_put(self, key, val)
        cache_path = self.path / f"{key}{_lru._CACHE_SUFFIX}"
        if cache_path.exists():
            return
        tmp = cache_path.with_name(f".{os.getpid()}.{cache_path.name}.tmp")
        try:
            tmp.write_bytes(val)
            os.replace(tmp, cache_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    atomic_put.__doc__ = orig_put.__doc__
    _lru.LRUCache.put = atomic_put
    _lru.LRUCache._mcrt_atomic_put = True


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the compile cache kept beside the code
    (``.gitignore`` lists it)."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, ".jax_cache")


def enable_persistent_compilation_cache() -> None:
    """Cache compiled executables on disk so fresh processes skip compiles.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    the program sets no directory of its own; otherwise the cache lives at
    :func:`default_cache_dir`."""
    global _CACHE_READY
    if _CACHE_READY:
        return
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or None
    if cache_dir is None:
        cache_dir = default_cache_dir()
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as exc:
            log.warning("persistent compilation cache disabled: %s", exc)
            _CACHE_READY = True
            return
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    _make_cache_writes_atomic()
    if os.path.isdir(cache_dir):
        verify_compilation_cache(cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _CACHE_READY = True


@dataclass
class HostBins:
    """Device-reduced dashboard aggregates (numpy on the host) — the payload
    builder's capped path needs nothing else (see ops/stats.ServingBins)."""

    success_count: int
    finals_min_successful: float
    finals_max_successful: float
    finals_hist_counts: np.ndarray  # (60,)
    finals_median_successful: float
    ruin_counts: np.ndarray  # (R+1,)
    ruin_max: float
    failure_count: int


@dataclass
class RunResult:
    """Host-side results of one full simulation batch.

    In reduced mode (``Engine.run(reduced=True)``) the per-path arrays are
    None — only the reduced tables and ``bins`` cross the host link, so a
    1M-path serving run fetches kilobytes instead of ~28 MB.
    """

    working_months: int
    num_simulations: int
    # Per-path arrays (numpy; None in reduced mode)
    success: Optional[np.ndarray]
    final_balance: Optional[np.ndarray]
    start_balance: Optional[np.ndarray]
    years_to_ruin: Optional[np.ndarray]
    first_year_gross: Optional[np.ndarray]
    first_year_real_gross: Optional[np.ndarray]
    inflation_at_retirement: Optional[np.ndarray]
    # Reduced tables (numpy), trajectory tables trimmed to the exact length
    success_probability: float
    median_start_balance: float
    median_final_successful: float
    swr: float
    final_balance_percentiles: np.ndarray  # (9,)
    trajectory_percentiles: np.ndarray  # (7, L)
    real_trajectory_percentiles: np.ndarray  # (7, L)
    sample_trajectories: np.ndarray  # (k, L)
    sample_real_trajectories: np.ndarray  # (k, L)
    wr_percentiles: np.ndarray  # (5, R)
    wr_observation_counts: np.ndarray  # (R,)
    # Device-binned dashboard aggregates (reduced mode only)
    bins: Optional[HostBins] = None


def auto_backend(dtype, mesh=None, platform: Optional[str] = None) -> str:
    """The backend a platform runs: the kernel on a GPU at float32 (its
    sharded form under a mesh), the XLA scan on the CPU and at float64.
    Any other platform is an error: nothing falls back to interpret mode
    or to the CPU."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return "scan"
    if platform == "gpu":
        if jnp.dtype(dtype) != jnp.dtype(jnp.float32):
            return "scan"
        return "pallas" if mesh is None else "pallas_sharded"
    raise RuntimeError(
        f"unsupported platform {platform!r}: this engine runs on an NVIDIA "
        "GPU (kernel) or on the CPU (XLA scan)"
    )


def _round_up(value: int, multiple: int) -> int:
    return max(multiple, ((value + multiple - 1) // multiple) * multiple)


def _host_bins(dev_bins) -> HostBins:
    """ServingBins (numpy leaves, post-device_get) -> HostBins."""
    return HostBins(
        success_count=int(dev_bins.success_count),
        finals_min_successful=float(dev_bins.finals_min_successful),
        finals_max_successful=float(dev_bins.finals_max_successful),
        finals_hist_counts=np.asarray(dev_bins.finals_hist_counts),
        finals_median_successful=float(dev_bins.finals_median_successful),
        ruin_counts=np.asarray(dev_bins.ruin_counts),
        ruin_max=float(dev_bins.ruin_max),
        failure_count=int(dev_bins.failure_count),
    )


class Engine:
    """Compiled Monte Carlo engine for one scenario configuration."""

    def __init__(
        self,
        config: Config,
        main_seed_override: Optional[int] = None,
        dtype=None,
        mesh=None,
    ):
        self.config = config.model_copy(deep=True)
        if main_seed_override is not None:
            if main_seed_override < 0:
                raise ValueError("main_seed_override must be nonnegative.")
            self.main_seed = int(main_seed_override)
        elif self.config.seed is not None:
            self.main_seed = int(self.config.seed)
        else:
            self.main_seed = generate_seed_from_timestamp()

        enable_persistent_compilation_cache()
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        self.retirement_years = int(self.config.retirement_years)
        self.params = SimParams.from_config(self.config, dtype=dtype)
        # Compile-time structure for the Pallas kernels (tax systems, stream
        # shape). Editing rates/amounts reuses executables; flipping a tax
        # system or stream indexing recompiles in seconds.
        from .pallas_kernel import statics_from_config

        self.statics = statics_from_config(self.config)
        self.search_key, self.final_key = stream_keys(self.main_seed)
        # Optional jax.sharding.Mesh with a 'paths' axis: shards the path
        # batch over devices (data-parallel). MCRT_MESH=auto opts serving
        # into a mesh over every local device when the caller did not pass
        # one (hosts construct engines mesh-less; on a multi-GPU host this
        # knob is how they scale out without code changes).
        if mesh is None and os.environ.get("MCRT_MESH", "").lower() in (
            "auto", "local", "1",
        ):
            if len(jax.devices()) > 1:
                from ..parallel.mesh import make_mesh

                mesh = make_mesh()
        self.mesh = mesh
        log.info(
            "Engine initialized for scenario '%s' with main seed: %d",
            self.config.Nickname,
            self.main_seed,
        )

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _key(self, stream: str) -> jax.Array:
        if stream == "search":
            return self.search_key
        if stream == "final":
            return self.final_key
        raise ValueError(f"Unknown seed stream '{stream}'")

    def _t_scan(self, max_working_months: int) -> int:
        horizon = max_working_months + self.retirement_years * MONTHS_PER_YEAR
        return _round_up(horizon, SCAN_BUCKET_MONTHS)

    def _pallas_traj_len(self, working_months: int) -> int:
        """Trajectory width for a kernel full-statistics run.

        The kernel's month loops have dynamic bounds, so the only
        shape-bearing knob is this width. Size it for the search cap
        (start + 70y) once per scenario — warmup, overrides and search
        results then reuse ONE compiled executable. Overrides beyond the
        scenario cap bucket to 10-year steps so a sweep of large overrides
        compiles O(1) widths. The kernel stores each recorded year as one
        row in device memory, so no width is too large for it."""
        bucket = 10 * MONTHS_PER_YEAR
        scenario_cap = (
            int(self.config.starting_working_months_search)
            + MAX_SEARCH_YEARS * MONTHS_PER_YEAR
        )
        if working_months > scenario_cap:
            cap_w = -(-working_months // bucket) * bucket
        else:
            cap_w = scenario_cap
        return 1 + self._t_scan(cap_w) // MONTHS_PER_YEAR

    # ------------------------------------------------------------------
    # probe: batched success probabilities for the search
    # ------------------------------------------------------------------
    def _mesh_devices(self) -> int:
        """Device count of the Engine's path mesh (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[self.mesh.axis_names[0]])

    _BACKENDS = ("auto", "scan", "pallas", "pallas_sharded")

    def _validate_backend(self, backend: str, kind: str) -> str:
        if backend not in self._BACKENDS:
            raise ValueError(
                f"Unknown {kind} backend {backend!r}; expected one of "
                f"{self._BACKENDS}"
            )
        if backend == "pallas_sharded" and self.mesh is None:
            raise ValueError(
                "backend 'pallas_sharded' needs an Engine mesh "
                "(Engine(..., mesh=make_mesh()))"
            )
        return backend

    def _resolve_backend(self, backend: Optional[str], env: str, kind: str) -> str:
        backend = self._validate_backend(
            backend or os.environ.get(env, "auto"), kind
        )
        if backend == "auto":
            return auto_backend(self.dtype, self.mesh)
        return backend

    def _resolve_probe_backend(self, backend: Optional[str]) -> str:
        """Backend for the search probes: :func:`auto_backend` unless the
        caller or MCRT_PROBE_BACKEND names one."""
        return self._resolve_backend(backend, "MCRT_PROBE_BACKEND", "probe")

    def _resolve_run_backend(self, backend: Optional[str]) -> str:
        """Backend for the full-statistics run, resolved separately from the
        probes: :func:`auto_backend` unless the caller or MCRT_RUN_BACKEND
        names one (MCRT_RUN_BACKEND=scan forces the XLA scan)."""
        return self._resolve_backend(backend, "MCRT_RUN_BACKEND", "run")

    def probe(
        self,
        months: Sequence[int],
        num_simulations: int,
        stream: str = "search",
        horizon_months: Optional[int] = None,
        backend: Optional[str] = None,
    ) -> List[float]:
        """Success probability (percent) for each working-month candidate.

        Candidates batch with shared shocks (common random numbers are
        structural — draws depend only on (stream, month, path)). Two
        backends, which draw the same paths: 'scan' (XLA vmap over
        candidates; exact x64 semantics on the CPU) and 'pallas' (the
        (path-block, candidate) kernel grid; the GPU's default at float32,
        see :func:`auto_backend`). Batches are padded to PROBE_WIDTH so
        every call in a search reuses ONE executable.
        """
        months = [int(m) for m in months]
        if not months:
            return []
        if any(m < 0 for m in months):
            raise ValueError(f"working-month candidates must be >= 0: {months}")
        if horizon_months is not None and horizon_months < max(months):
            # The scan horizon must cover every candidate's accumulation
            # phase; a short horizon would silently truncate it and return
            # wrong probabilities.
            raise ValueError(
                f"horizon_months={horizon_months} is below the largest "
                f"candidate ({max(months)})"
            )
        t_scan = self._t_scan(int(horizon_months or max(months)))
        probe_backend = self._resolve_probe_backend(backend)
        key = self._key(stream)
        t_start = time.perf_counter()
        out: List[float] = []
        for i in range(0, len(months), PROBE_WIDTH):
            chunk = months[i : i + PROBE_WIDTH]
            padded = chunk + [chunk[-1]] * (PROBE_WIDTH - len(chunk))
            if probe_backend == "pallas":
                from .pallas_kernel import BLOCK_PATHS, pallas_probe

                n_total = int(num_simulations)
                budget = max(BLOCK_PATHS,
                             (max_probe_paths() // BLOCK_PATHS) * BLOCK_PATHS)
                probe_kwargs = dict(
                    n_candidates=PROBE_WIDTH,
                    retirement_years=self.retirement_years,
                    n_streams=self.params.n_streams,
                    statics=self.statics,
                )
                months_arr = jnp.asarray(padded, dtype=jnp.int32)
                seed = key
                if n_total <= budget:
                    # Single dispatch — no merge arithmetic.
                    probs = pallas_probe(
                        self.params, months_arr, seed, n_paths=n_total,
                        **probe_kwargs,
                    )
                else:
                    # Beyond the per-dispatch budget, chunk over global
                    # path blocks (CRN/seeding identical to one dispatch)
                    # and merge as a path-count-weighted mean.
                    acc = None
                    offset = 0
                    for start in range(0, n_total, budget):
                        cn = min(budget, n_total - start)
                        part = pallas_probe(
                            self.params, months_arr, seed, n_paths=cn,
                            block_offset=jnp.asarray(offset, jnp.int32),
                            **probe_kwargs,
                        ) * (cn / n_total)
                        acc = part if acc is None else _add_jit(acc, part)
                        offset += -(-cn // BLOCK_PATHS)
                    probs = acc
            elif probe_backend == "pallas_sharded":
                from .pallas_kernel import (
                    BLOCK_PATHS,
                    _local_blocks,
                    pallas_probe_sharded,
                )

                n_total = int(num_simulations)
                n_dev = self._mesh_devices()
                unit = n_dev * BLOCK_PATHS
                budget = max(
                    unit, (n_dev * max_probe_paths() // unit) * unit
                )
                sharded_kwargs = dict(
                    mesh=self.mesh,
                    n_candidates=PROBE_WIDTH,
                    retirement_years=self.retirement_years,
                    n_streams=self.params.n_streams,
                    statics=self.statics,
                )
                months_arr = jnp.asarray(padded, dtype=jnp.int32)
                seed = key
                if n_total <= budget:
                    probs = pallas_probe_sharded(
                        self.params, months_arr, seed, n_paths=n_total,
                        **sharded_kwargs,
                    )
                else:
                    # Beyond n_dev per-chip budgets: mesh-sized chunks over
                    # contiguous global blocks, merged as a mean weighted by
                    # each chunk's SIMULATED count (the sharded probe
                    # averages over whole padded blocks).
                    sim_counts = []
                    remaining = n_total
                    while remaining > 0:
                        cn = min(budget, remaining)
                        sim_counts.append(
                            unit * _local_blocks(cn, n_dev, BLOCK_PATHS)
                        )
                        remaining -= cn
                    total_sim = sum(sim_counts)
                    acc = None
                    offset = 0
                    start = 0
                    for sim in sim_counts:
                        cn = min(budget, n_total - start)
                        part = pallas_probe_sharded(
                            self.params, months_arr, seed, n_paths=cn,
                            block_offset=jnp.asarray(offset, jnp.int32),
                            **sharded_kwargs,
                        ) * (sim / total_sim)
                        acc = part if acc is None else _add_jit(acc, part)
                        offset += sim // BLOCK_PATHS
                        start += cn
                    probs = acc
            else:
                probs = _probe_jit(
                    self.params,
                    jnp.asarray(padded, dtype=jnp.int32),
                    key,
                    n_paths=int(num_simulations),
                    t_scan=t_scan,
                    retirement_years=self.retirement_years,
                    dtype=self.dtype,
                    mesh=self.mesh,
                    antithetic=self.statics.antithetic,
                    jumps=self.statics.jumps,
                    mortality=self.statics.mortality,
                )
            out.extend(float(v) for v in np.asarray(probs)[: len(chunk)])
        log.debug(
            "phase=probe backend=%s candidates=%d paths=%d t_scan=%d: %.3f s",
            probe_backend,
            len(months),
            int(num_simulations),
            t_scan,
            time.perf_counter() - t_start,
        )
        return out

    # ------------------------------------------------------------------
    # full run with all statistics
    # ------------------------------------------------------------------
    def run(
        self,
        working_months: int,
        num_simulations: int,
        stream: str = "final",
        backend: Optional[str] = None,
        reduced: bool = False,
    ) -> RunResult:
        """One full-statistics batch.

        ``reduced=True`` keeps the per-path arrays on device and additionally
        reduces the dashboard's histogram payloads there (ops/stats.
        serving_bins); the host fetches only percentile tables and bin
        counts. This is the serving fast path at north-star scale — the
        response needs nothing per-path.
        """
        working_months = int(working_months)
        if working_months < 0:
            raise ValueError(f"working_months must be >= 0, got {working_months}")
        n = int(num_simulations)
        t_scan = self._t_scan(working_months)
        traj_len = 1 + t_scan // MONTHS_PER_YEAR
        k = min(NUM_SAMPLE_PATHS, n)
        sample_idx = jnp.asarray(
            np.random.default_rng(self.main_seed).choice(n, size=k, replace=False),
            dtype=jnp.int32,
        )
        run_backend = self._resolve_run_backend(backend)
        if run_backend in ("pallas", "pallas_sharded"):
            pallas_traj_len = self._pallas_traj_len(working_months)
        if run_backend == "pallas" and n > max_device_paths():
            return self._run_chunked(
                working_months, n, stream, reduced, pallas_traj_len,
                sample_idx,
            )
        if (
            run_backend == "pallas_sharded"
            and n > self._mesh_devices() * max_device_paths()
        ):
            # The HBM budget is per chip; a mesh divides paths across its
            # devices, so the sharded path only chunks past n_dev budgets.
            return self._run_chunked(
                working_months, n, stream, reduced, pallas_traj_len,
                sample_idx, sharded=True,
            )
        t_start = time.perf_counter()
        if run_backend == "pallas" and reduced:
            # Serving fast path: kernel + every reduction in ONE device
            # program — a single dispatch, kilobytes fetched.
            traj_len = pallas_traj_len
            outs = None
            summary, dev_bins = _pallas_full_reduced_jit(
                self.params,
                jnp.asarray(working_months, dtype=jnp.int32),
                self._key(stream),
                sample_idx,
                n_paths=n,
                retirement_years=self.retirement_years,
                n_streams=self.params.n_streams,
                statics=self.statics,
                traj_len=traj_len,
            )
        elif run_backend in ("pallas", "pallas_sharded"):
            from .pallas_kernel import (
                pallas_simulate_full,
                pallas_simulate_full_sharded,
            )

            traj_len = pallas_traj_len
            if run_backend == "pallas_sharded":
                full = pallas_simulate_full_sharded(
                    self.params,
                    working_months,
                    self._key(stream),
                    mesh=self.mesh,
                    n_paths=n,
                    retirement_years=self.retirement_years,
                    n_streams=self.params.n_streams,
                    statics=self.statics,
                    traj_len=traj_len,
                )
            else:
                full = pallas_simulate_full(
                    self.params,
                    working_months,
                    self._key(stream),
                    n_paths=n,
                    retirement_years=self.retirement_years,
                    n_streams=self.params.n_streams,
                    statics=self.statics,
                    traj_len=traj_len,
                )
            outs = PathOutputs(
                success=full["success"][:n] > 0.5,
                final_balance=full["final_balance"][:n],
                start_balance=full["start_balance"][:n],
                years_to_ruin=full["years_to_ruin"][:n],
                first_year_gross=full["first_year_gross"][:n],
                first_year_real_gross=full["first_year_real_gross"][:n],
                inflation_at_retirement=full["inflation_at_retirement"][:n],
                trajectory=full["trajectory"][:n],
                price_levels=full["price_levels"][:n],
                withdrawal_rates=full["withdrawal_rates"][:n],
            )
            if reduced:
                summary, dev_bins = _summarize_serving_jit(outs, sample_idx)
            else:
                summary = _summarize_jit(outs, sample_idx)
        else:
            outs, summary = _run_jit(
                self.params,
                jnp.asarray(working_months, dtype=jnp.int32),
                self._key(stream),
                sample_idx,
                n_paths=n,
                t_scan=t_scan,
                retirement_years=self.retirement_years,
                traj_len=traj_len,
                dtype=self.dtype,
                mesh=self.mesh,
                antithetic=self.statics.antithetic,
                jumps=self.statics.jumps,
                mortality=self.statics.mortality,
            )
            if reduced:
                dev_bins = _serving_bins_jit(outs)
        jax.block_until_ready(summary.success_probability)
        t_device = time.perf_counter() - t_start
        # One batched host fetch for everything the RunResult needs,
        # instead of one transfer per leaf (~20 of them).
        vec_fields = None
        if not reduced:
            vec_fields = (
                outs.success, outs.final_balance, outs.start_balance,
                outs.years_to_ruin, outs.first_year_gross,
                outs.first_year_real_gross, outs.inflation_at_retirement,
            )
        summary, dev_bins, vec_fields = jax.device_get(
            (summary, dev_bins if reduced else None, vec_fields)
        )
        log.info(
            "phase=final_run backend=%s paths=%d months=%d t_scan=%d "
            "reduced=%s: %.3f s (device %.3f s)",
            run_backend,
            n,
            working_months,
            t_scan,
            reduced,
            time.perf_counter() - t_start,
            t_device,
        )
        L = expected_trajectory_length(working_months, self.retirement_years)
        bins = _host_bins(dev_bins) if reduced else None
        return RunResult(
            working_months=working_months,
            num_simulations=n,
            success=None if reduced else vec_fields[0],
            final_balance=None if reduced else vec_fields[1],
            start_balance=None if reduced else vec_fields[2],
            years_to_ruin=None if reduced else vec_fields[3],
            first_year_gross=None if reduced else vec_fields[4],
            first_year_real_gross=None if reduced else vec_fields[5],
            inflation_at_retirement=None if reduced else vec_fields[6],
            bins=bins,
            success_probability=float(summary.success_probability),
            median_start_balance=float(summary.median_start_balance),
            median_final_successful=float(summary.median_final_successful),
            swr=float(summary.swr),
            final_balance_percentiles=np.asarray(summary.final_balance_percentiles),
            trajectory_percentiles=np.asarray(summary.trajectory_percentiles)[:, :L],
            real_trajectory_percentiles=np.asarray(
                summary.real_trajectory_percentiles
            )[:, :L],
            sample_trajectories=np.asarray(summary.sample_trajectories)[:, :L],
            sample_real_trajectories=np.asarray(
                summary.sample_real_trajectories
            )[:, :L],
            wr_percentiles=np.asarray(summary.wr_percentiles),
            wr_observation_counts=np.asarray(summary.wr_observation_counts),
        )

    # ------------------------------------------------------------------
    # chunked full-statistics run (beyond the per-dispatch HBM budget)
    # ------------------------------------------------------------------
    def _run_chunked(
        self, working_months, n, stream, reduced, traj_len, sample_idx,
        interpret: bool = False, sharded: bool = False,
    ) -> RunResult:
        """Split a full-statistics run into device-sized chunks and merge.

        Chunk c simulates global path blocks [c*B, (c+1)*B) via the
        kernel's global block offsets (the same mechanism the sharded path
        uses; draws are keyed by global path), so the union of chunks IS
        the unchunked run path for path. EVERY statistic is computed exactly over all n paths and
        bit-equals the unchunked run's: the vector statistics and serving
        bins from the concatenated per-chunk vectors, the per-year band
        tables (trajectory/real/WR percentiles) by the additive-count
        order-statistic search (ops/chunked_quantiles.py) — compare-counts
        accumulate across chunks, and a chunk is re-simulated
        deterministically per search round instead of ever holding more
        than one chunk's yearly series live.

        With ``sharded=True`` each chunk dispatches the shard_map'd kernel
        over the Engine mesh: the budget scales to n_dev chips per chunk,
        and chunk sizes stay multiples of n_dev * block so the per-device
        block numbering is globally contiguous — the union still equals
        the single-device unchunked run bit for bit."""
        from ..ops.chunked_quantiles import BandSearch, bracket_ranks
        from .pallas_kernel import (
            BLOCK_PATHS,
            _local_blocks,
            pallas_simulate_full,
            pallas_simulate_full_sharded,
        )

        t_start = time.perf_counter()
        block = BLOCK_PATHS
        n_dev = self._mesh_devices() if sharded else 1
        unit = n_dev * block
        chunk_paths = max(
            unit, (n_dev * max_device_paths() // unit) * unit
        )
        n_chunks = -(-n // chunk_paths)
        seed = self._key(stream)
        w = jnp.asarray(working_months, dtype=jnp.int32)

        chunk_meta, boff = [], 0
        for c in range(n_chunks):
            start = c * chunk_paths
            cn = min(chunk_paths, n - start)
            chunk_meta.append((start, cn, boff))
            boff += (n_dev * _local_blocks(cn, n_dev, block) if sharded
                     else -(-cn // block))

        def _sim(c):
            start, cn, off = chunk_meta[c]
            kernel_kwargs = dict(
                n_paths=cn,
                retirement_years=self.retirement_years,
                n_streams=self.params.n_streams,
                statics=self.statics,
                traj_len=traj_len,
                interpret=interpret,
                block_offset=jnp.asarray(off, jnp.int32),
            )
            if sharded:
                full = pallas_simulate_full_sharded(
                    self.params, w, seed, mesh=self.mesh, **kernel_kwargs
                )
            else:
                full = pallas_simulate_full(
                    self.params, w, seed, **kernel_kwargs
                )
            return full, start, cn

        qs_band = np.asarray(TRAJECTORY_PERCENTILES, np.float32)
        qs_wr = np.asarray(WITHDRAWAL_RATE_PERCENTILES, np.float32)
        kb, kw = qs_band.shape[0], qs_wr.shape[0]
        # Bracket margin: covers the chunk-count slack and every f32
        # rounding discrepancy (ops/chunked_quantiles.bracket_ranks).
        margin = n_chunks + 8
        brk_lo: Optional[list] = None
        brk_hi: Optional[list] = None

        vec_parts, samp_t_parts, samp_r_parts, wr_count_parts = [], [], [], []
        for c in range(n_chunks):
            full, start, cn = _sim(c)
            vecs_c, cnt_c, st_c, sr_c = _chunk_reduce_jit(
                full, jnp.asarray(start, jnp.int32), sample_idx, cn=cn
            )
            vec_parts.append(vecs_c)
            wr_count_parts.append(cnt_c)
            samp_t_parts.append(st_c)
            samp_r_parts.append(sr_c)
            # Warm-start brackets for the band search, computed while this
            # chunk's series are still live: the min/max over chunks of
            # per-chunk order statistics at margin-padded ranks provably
            # contain every global order statistic (bracket_ranks), so the
            # search starts from intervals a few thousand keys wide instead
            # of the full 2^32 space — most re-simulation rounds disappear
            # with bit-identical results. The wr count fetch below doubles
            # as the per-chunk ordering barrier (replicated under a mesh,
            # so multi-controller dispatch order stays identical).
            cnt_h = np.asarray(cnt_c, dtype=np.int64)
            cw = cnt_h.shape[0]
            lo_t, hi_t = bracket_ranks(
                qs_band, np.full((traj_len,), cn, dtype=np.int64), margin
            )
            lo_w, hi_w = bracket_ranks(qs_wr, cnt_h, margin)
            pad = ((0, 0), (0, kb - kw))
            need = np.concatenate(
                [
                    lo_t, lo_t, np.pad(lo_w, pad, mode="edge"),
                    hi_t, hi_t, np.pad(hi_w, pad, mode="edge"),
                ],
                axis=0,
            ) + 1
            brk = np.asarray(
                _band_bracket_jit(full, jnp.asarray(need, jnp.int32), cn=cn),
                dtype=np.float32,
            )
            t_len = traj_len
            half = 2 * t_len + cw
            lo_half, hi_half = brk[:half], brk[half:]
            lo_vals = [lo_half[:t_len], lo_half[t_len:2 * t_len],
                       lo_half[2 * t_len:, :kw]]
            hi_vals = [hi_half[:t_len], hi_half[t_len:2 * t_len],
                       hi_half[2 * t_len:, :kw]]
            # Empty wr columns contribute no counts: exclude their
            # degenerate statistics from the accumulation.
            empty = cnt_h == 0
            lo_vals[2] = np.where(empty[:, None], np.float32(np.inf),
                                  lo_vals[2])
            hi_vals[2] = np.where(empty[:, None], np.float32(-np.inf),
                                  hi_vals[2])
            if brk_lo is None:
                brk_lo, brk_hi = lo_vals, hi_vals
            else:
                brk_lo = [np.minimum(a, b) for a, b in zip(brk_lo, lo_vals)]
                brk_hi = [np.maximum(a, b) for a, b in zip(brk_hi, hi_vals)]
            # Synchronize before dispatching the next chunk: output buffers
            # are allocated at DISPATCH time, so letting every chunk queue
            # up asynchronously would hold n_chunks x ~GBs of yearly series
            # live at once — the exact OOM this path exists to avoid. The
            # barrier caps live series at one chunk (plus the small per-
            # chunk reductions kept above). Barriering the WHOLE per-chunk
            # reduction also keeps multi-controller collective order strict
            # (see _chunk_reduce_impl).
            del full
            jax.block_until_ready((vecs_c, cnt_c, st_c, sr_c))
            log.info("phase=chunked_run chunk=%d/%d paths=%d: %.3f s",
                     c + 1, n_chunks, cn, time.perf_counter() - t_start)

        (scalars, samples, samples_real, wr_counts, dev_bins,
         vecs) = _chunked_summary_jit(
            vec_parts, samp_t_parts, samp_r_parts, wr_count_parts,
            r_years=self.retirement_years, reduced=reduced,
        )
        jax.block_until_ready(scalars[0])
        log.info("phase=chunked_summary done: %.3f s",
                 time.perf_counter() - t_start)

        # Exact band tables: host-driven additive-count bisection. Each
        # round re-simulates the chunks (deterministic: same seed + block
        # offsets) and accumulates one fused compare-count pass; the fetch
        # of each chunk's counts doubles as the ordering barrier.
        wr_counts_h = np.asarray(wr_counts)
        n_cols_full = np.full((traj_len,), n, dtype=np.int64)
        # Edges per rank per round: 32 (5 bits/round, 7 rounds) balances
        # count-pass FLOPs against kernel re-simulation. Measured dead end:
        # widening to E=256 to cut rounds makes the count program itself
        # ~90x slower per run on XLA:CPU (58.6 s vs 0.66 s at the test
        # shapes — superlinear, not the 8x the edge count predicts), so
        # wider rounds lose on both backends. See docs/NOTES.md.
        search = BandSearch(
            [qs_band, qs_band, qs_wr],
            [n_cols_full, n_cols_full, wr_counts_h.astype(np.int64)],
            edges_per_rank=32,
        )
        if brk_lo is not None:
            search.seed_intervals(brk_lo, brk_hi)
        band_passes = 0
        while not search.resolved:
            edges_dev = tuple(jnp.asarray(e) for e in search.edges())
            totals = None
            for c in range(n_chunks):
                full, _, cn = _sim(c)
                cnts = _band_counts_jit(full, *edges_dev, cn=cn)
                del full
                cnts = [np.asarray(x, np.int64) for x in jax.device_get(cnts)]
                totals = cnts if totals is None else [
                    t + x for t, x in zip(totals, cnts)
                ]
            search.update(totals)
            band_passes += 1
            log.info("phase=band_pass round=%d: %.3f s",
                     band_passes, time.perf_counter() - t_start)
        v_lo_dev = tuple(jnp.asarray(v) for v in search.floor_values())
        cnt_le = gt_min = None
        for c in range(n_chunks):
            full, _, cn = _sim(c)
            out = jax.device_get(_band_ceil_jit(full, *v_lo_dev, cn=cn))
            del full
            if cnt_le is None:
                cnt_le = [np.asarray(o[0], np.int64) for o in out]
                gt_min = [np.asarray(o[1], np.float32) for o in out]
            else:
                cnt_le = [a + np.asarray(o[0], np.int64)
                          for a, o in zip(cnt_le, out)]
                gt_min = [np.minimum(a, np.asarray(o[1], np.float32))
                          for a, o in zip(gt_min, out)]
        band_passes += 1
        traj_pcts, real_pcts, wr_pcts = search.interpolate(cnt_le, gt_min)

        # Single batched host fetch (see Engine.run) for the scalars,
        # samples, bins and (raw mode) per-path vectors.
        scalars, samples, samples_real, dev_bins, vecs_h = jax.device_get(
            (scalars, samples, samples_real, dev_bins if reduced else None,
             None if reduced else vecs)
        )
        (success_prob, median_start, median_final, swr, final_pcts) = scalars
        log.info(
            "phase=final_run backend=%s paths=%d months=%d "
            "chunks=%d band_passes=%d reduced=%s: %.3f s",
            "pallas_sharded_chunked" if sharded else "pallas_chunked",
            n, int(working_months), n_chunks, band_passes, reduced,
            time.perf_counter() - t_start,
        )
        L = expected_trajectory_length(
            int(working_months), self.retirement_years
        )
        bins = _host_bins(dev_bins) if reduced else None
        return RunResult(
            working_months=int(working_months),
            num_simulations=n,
            success=None if reduced else vecs_h["success"] > 0.5,
            final_balance=None if reduced else vecs_h["final_balance"],
            start_balance=None if reduced else vecs_h["start_balance"],
            years_to_ruin=None if reduced else vecs_h["years_to_ruin"],
            first_year_gross=None if reduced else vecs_h["first_year_gross"],
            first_year_real_gross=None if reduced else vecs_h[
                "first_year_real_gross"
            ],
            inflation_at_retirement=None if reduced else vecs_h[
                "inflation_at_retirement"
            ],
            bins=bins,
            success_probability=float(success_prob),
            median_start_balance=float(median_start),
            median_final_successful=float(median_final),
            swr=float(swr),
            final_balance_percentiles=np.asarray(final_pcts),
            trajectory_percentiles=traj_pcts[:, :L],
            real_trajectory_percentiles=real_pcts[:, :L],
            sample_trajectories=np.asarray(samples)[:, :L],
            sample_real_trajectories=np.asarray(samples_real)[:, :L],
            wr_percentiles=wr_pcts,
            wr_observation_counts=wr_counts_h,
        )

    # ------------------------------------------------------------------
    # single-path inspection (tests / debugging)
    # ------------------------------------------------------------------
    def run_path(self, working_months: int, stream: str = "final") -> dict:
        """Simulate one path and return a reference-style result dict
        (reference: backend/simulation.py:939-950)."""
        res = self.run(working_months, 1, stream=stream)
        L = expected_trajectory_length(working_months, self.retirement_years)
        traj = res.sample_trajectories[0][:L]
        real = res.sample_real_trajectories[0][:L]
        return {
            "Start Balance": float(res.start_balance[0]),
            "Final Balance": float(max(0.0, res.final_balance[0])),
            "Success": bool(res.success[0]),
            "YearsToRuin": float(res.years_to_ruin[0]),
            "First Year Gross Withdrawal": float(res.first_year_gross[0]),
            "First Year Real Gross Withdrawal": float(res.first_year_real_gross[0]),
            "Trajectory": [float(v) for v in traj],
            "RealTrajectory": [float(v) for v in real],
            "WithdrawalRateTrajectory": [
                float(v) for v in res.wr_percentiles[2]  # median == the path
            ],
            "Inflation At Retirement": float(res.inflation_at_retirement[0]),
        }


def _probe_impl(params, w_vec, key, n_paths, t_scan, retirement_years, dtype, mesh,
                antithetic=False, jumps=False, mortality=False):
    def one(w):
        outs = simulate_paths(
            params,
            w,
            key,
            n_paths=n_paths,
            t_scan=t_scan,
            retirement_years=retirement_years,
            traj_len=0,
            dtype=dtype,
            antithetic=antithetic,
            jumps=jumps,
            mortality=mortality,
        )
        return outs.success

    success = jax.vmap(one, in_axes=(0,))(w_vec)  # (k, n_paths)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import PATHS_AXIS

        success = jax.lax.with_sharding_constraint(
            success, NamedSharding(mesh, P(None, PATHS_AXIS))
        )
    return jnp.mean(success.astype(jnp.float32), axis=1) * 100.0


_probe_jit = jax.jit(
    _probe_impl,
    static_argnames=("n_paths", "t_scan", "retirement_years", "dtype", "mesh",
                     "antithetic", "jumps", "mortality"),
)


def _run_impl(
    params, w, key, sample_idx, n_paths, t_scan, retirement_years, traj_len, dtype,
    mesh, antithetic=False, jumps=False, mortality=False,
):
    outs = simulate_paths(
        params,
        w,
        key,
        n_paths=n_paths,
        t_scan=t_scan,
        retirement_years=retirement_years,
        traj_len=traj_len,
        dtype=dtype,
        antithetic=antithetic,
        jumps=jumps,
        mortality=mortality,
    )
    if mesh is not None:
        from ..parallel.mesh import constrain_paths_axis

        outs = constrain_paths_axis(mesh, outs)
    return outs, summarize(outs, sample_idx)


_run_jit = jax.jit(
    _run_impl,
    static_argnames=("n_paths", "t_scan", "retirement_years", "traj_len", "dtype",
                     "mesh", "antithetic", "jumps", "mortality"),
)

_summarize_jit = jax.jit(summarize)
_serving_bins_jit = jax.jit(serving_bins, static_argnames=("r_years",))
_summarize_serving_jit = jax.jit(
    lambda outs, sample_idx: (summarize(outs, sample_idx), serving_bins(outs))
)


def _pallas_full_reduced_impl(
    params, w, seed, sample_idx, *, n_paths, retirement_years, n_streams,
    statics, traj_len,
):
    """Single-chip serving program: Pallas full kernel + summarize +
    serving_bins traced into one executable (one dispatch, KB outputs)."""
    from .pallas_kernel import pallas_simulate_full

    full = pallas_simulate_full(
        params, w, seed,
        n_paths=n_paths,
        retirement_years=retirement_years,
        n_streams=n_streams,
        statics=statics,
        traj_len=traj_len,
    )
    n = n_paths
    outs = PathOutputs(
        success=full["success"][:n] > 0.5,
        final_balance=full["final_balance"][:n],
        start_balance=full["start_balance"][:n],
        years_to_ruin=full["years_to_ruin"][:n],
        first_year_gross=full["first_year_gross"][:n],
        first_year_real_gross=full["first_year_real_gross"][:n],
        inflation_at_retirement=full["inflation_at_retirement"][:n],
        trajectory=full["trajectory"][:n],
        price_levels=full["price_levels"][:n],
        withdrawal_rates=full["withdrawal_rates"][:n],
    )
    return summarize(outs, sample_idx), serving_bins(outs)


_pallas_full_reduced_jit = jax.jit(
    _pallas_full_reduced_impl,
    static_argnames=(
        "n_paths", "retirement_years", "n_streams", "statics", "traj_len",
    ),
)


_add_jit = jax.jit(lambda a, b: a + b)


def _chunk_real_series(full, cn):
    """The inflation-adjusted trajectory of one chunk — the IDENTICAL
    elementwise arithmetic ops/stats.series_summary applies, so values
    derived per chunk bit-match the unchunked derivation."""
    traj = full["trajectory"][:cn]
    price = full["price_levels"][:cn]
    real = jnp.where(
        price > SMALL_EPSILON, traj / jnp.maximum(price, SMALL_EPSILON), 0.0
    )
    return traj, real


def _chunk_reduce_impl(full, start, sample_idx, *, cn):
    """Per-chunk reduction of a chunked run, as ONE program: slice the
    vector outputs to the chunk's true path count, count the chunk's WR
    observations (a psum when sharded), and gather this chunk's share of
    the dashboard sample paths (each global sample index lives in exactly
    one chunk; out-of-chunk rows contribute zeros and the summary sums).

    Being one jitted program (instead of ~11 eager dispatches) matters
    beyond dispatch overhead: under a multi-controller CPU mesh, gloo
    matches collectives per TCP pair in arrival order, and XLA:CPU runs
    INDEPENDENT programs concurrently on a thread pool — so two processes
    issuing the same eager ops could enter their collectives in different
    orders and abort the job ("Received data size doesn't match expected
    size"). Inside one executable the compiled schedule orders every
    collective identically on every process."""
    vec_names = (
        "success", "final_balance", "start_balance", "years_to_ruin",
        "first_year_gross", "first_year_real_gross",
        "inflation_at_retirement",
    )
    vecs = {name: full[name][:cn] for name in vec_names}
    cnt = jnp.sum(~jnp.isnan(full["withdrawal_rates"][:cn]), axis=0)
    traj, real = _chunk_real_series(full, cn)
    in_chunk = (sample_idx >= start) & (sample_idx < start + cn)
    local = jnp.clip(sample_idx - start, 0, cn - 1)
    samp_t = jnp.where(in_chunk[:, None], traj[local], 0.0)
    samp_r = jnp.where(in_chunk[:, None], real[local], 0.0)
    return vecs, cnt, samp_t, samp_r


_chunk_reduce_jit = jax.jit(_chunk_reduce_impl, static_argnames=("cn",))


def _band_bracket_impl(full, need, *, cn):
    """Floor order statistics of ONE chunk at margin-padded bracket ranks
    (``need`` is a (2*C_total, K) table of 1-based counts: the series
    columns once with lo-bracket ranks, then again with hi-bracket ranks,
    built by the runner from ops.chunked_quantiles.bracket_ranks). The
    min/max of these per-chunk statistics across chunks provably contain
    the global order statistics the band search targets, so seeding the
    search with them (BandSearch.seed_intervals) removes most of its
    re-simulation rounds without changing a bit of the answer. Runs while
    the chunk's series are already live from the initial reduction pass —
    no extra kernel dispatch. Masking mirrors _band_counts_impl exactly
    (same count semantics as every other search pass). The lo/hi doubling
    rides the column axis (the parts list), not the rank axis, so the
    search keeps K=7 ranks."""
    traj, real = _chunk_real_series(full, cn)
    wr = full["withdrawal_rates"][:cn]
    wrf = jnp.where(jnp.isnan(wr), jnp.asarray(jnp.inf, wr.dtype), wr)
    return _search_floor_values_parts(
        [traj, real, wrf, traj, real, wrf], need
    )


_band_bracket_jit = jax.jit(_band_bracket_impl, static_argnames=("cn",))


def _band_counts_impl(full, traj_edges, real_edges, wr_edges, *, cn):
    """One band-search round's compare-counts over one chunk: for every
    (column, probe) cell, how many of this chunk's entries are <= the
    probe value (ops/chunked_quantiles.py drives the rounds; counts are
    additive across chunks and lower to a psum when the chunk is sharded).
    Masking mirrors series_summary: WR NaNs count as +inf (never <= a
    finite probe)."""
    traj, real = _chunk_real_series(full, cn)
    wr = full["withdrawal_rates"][:cn]
    wrf = jnp.where(jnp.isnan(wr), jnp.asarray(jnp.inf, wr.dtype), wr)
    # f32 accumulation runs the compare-count at full VPU rate and is
    # exact below 2**24 rows (ops.quantiles._count_dtype); the host
    # accumulator converts back to int64 losslessly.
    cdt = _count_dtype(cn)

    def count(x, edges):
        return jnp.sum(
            (x[:, :, None] <= edges[None, :, :]).astype(cdt), axis=0
        )

    return count(traj, traj_edges), count(real, real_edges), count(wrf, wr_edges)


_band_counts_jit = jax.jit(_band_counts_impl, static_argnames=("cn",))


def _band_ceil_impl(full, traj_v, real_v, wr_v, *, cn):
    """The band search's final pass over one chunk: count-at-floor and
    smallest-entry-above-floor per (column, rank) — both additive across
    chunks (sum / min) — from which the interpolation's ceil order
    statistic follows (duplicate rule identical to quantiles._ceil_values)."""
    traj, real = _chunk_real_series(full, cn)
    wr = full["withdrawal_rates"][:cn]
    wrf = jnp.where(jnp.isnan(wr), jnp.asarray(jnp.inf, wr.dtype), wr)

    cdt = _count_dtype(cn)

    def ceil_stats(x, v):
        le = x[:, :, None] <= v[None, :, :]
        cnt = jnp.sum(le.astype(cdt), axis=0)
        gt_min = jnp.min(
            jnp.where(le, jnp.asarray(jnp.inf, x.dtype), x[:, :, None]),
            axis=0,
        )
        return cnt, gt_min

    return ceil_stats(traj, traj_v), ceil_stats(real, real_v), ceil_stats(wrf, wr_v)


_band_ceil_jit = jax.jit(_band_ceil_impl, static_argnames=("cn",))


def _chunked_summary_impl(
    vec_parts, samp_t_parts, samp_r_parts, wr_count_parts, *, r_years,
    reduced,
):
    """Merge-phase reduction of a chunked run: vector statistics over the
    full concatenated vectors (exact), sample paths and per-year WR
    observation counts summed from the chunks' contributions. The band
    percentile tables are NOT computed here — they come from the exact
    additive-count search the caller drives (ops/chunked_quantiles.py).
    Takes the per-chunk parts as list pytrees and concatenates INSIDE the
    program — one executable, so its collectives are schedule-ordered (see
    :func:`_chunk_reduce_impl`) and the eager concat dispatches are gone.
    In raw mode the concatenated vectors are returned for the host fetch;
    reduced mode returns None there and never materialises them."""
    from ..ops.stats import serving_bins, vector_summary
    from .kernel import PathOutputs

    vecs = {
        k: jnp.concatenate([p[k] for p in vec_parts])
        for k in vec_parts[0]
    }
    samples = sum(samp_t_parts[1:], samp_t_parts[0])
    samples_real = sum(samp_r_parts[1:], samp_r_parts[0])
    wr_counts = sum(wr_count_parts[1:], wr_count_parts[0])
    success = vecs["success"] > 0.5
    (success_prob, median_start, median_final, swr,
     final_pcts) = vector_summary(
        success, vecs["final_balance"], vecs["start_balance"],
        vecs["first_year_real_gross"],
    )
    scalars = (success_prob, median_start, median_final, swr, final_pcts)
    bins = None
    if reduced:
        outs_vec = PathOutputs(
            success=success,
            final_balance=vecs["final_balance"],
            start_balance=vecs["start_balance"],
            years_to_ruin=vecs["years_to_ruin"],
            first_year_gross=vecs["first_year_gross"],
            first_year_real_gross=vecs["first_year_real_gross"],
            inflation_at_retirement=vecs["inflation_at_retirement"],
            trajectory=None, price_levels=None, withdrawal_rates=None,
        )
        bins = serving_bins(outs_vec, r_years=r_years)
    return (scalars, samples, samples_real, wr_counts, bins,
            None if reduced else vecs)


_chunked_summary_jit = jax.jit(
    _chunked_summary_impl, static_argnames=("r_years", "reduced")
)

"""Multi-device path-parallel tests on the virtual 8-CPU-device mesh."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import stream_keys
from monte_carlo_retirement_tpu.parallel.mesh import (
    make_mesh,
    pad_to_devices,
    paths_sharding,
)
from tests.conftest import make_config


def test_virtual_mesh_has_eight_devices():
    assert len(jax.devices()) == 8


def test_sharded_run_matches_single_device():
    """Sharding the paths axis over 8 devices must not change any statistic:
    the kernel is elementwise over paths and the reductions are collective."""
    cfg = make_config(retirement_years=5, seed=11)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, final_key = stream_keys(11)
    n = pad_to_devices(64, 8)

    kwargs = dict(
        n_paths=n, t_scan=120, retirement_years=5, traj_len=11, dtype=jnp.float64
    )
    outs_single = simulate_paths(params, jnp.int32(24), final_key, **kwargs)

    mesh = make_mesh()
    sharding = paths_sharding(mesh)

    @jax.jit
    def sharded(params, w, key):
        outs = simulate_paths(params, w, key, **kwargs)
        outs = jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(x, sharding), outs
        )
        return outs

    outs_sharded = sharded(params, jnp.int32(24), final_key)
    np.testing.assert_allclose(
        np.asarray(outs_single.final_balance),
        np.asarray(outs_sharded.final_balance),
        rtol=1e-12,
    )
    np.testing.assert_array_equal(
        np.asarray(outs_single.success), np.asarray(outs_sharded.success)
    )
    assert len(outs_sharded.final_balance.sharding.device_set) == 8


def test_sharded_reduction_collectives():
    """Success-rate reduction over a sharded batch lowers to collectives and
    matches the replicated result."""
    cfg = make_config(retirement_years=5, seed=13)
    params = SimParams.from_config(cfg, dtype=jnp.float64)
    _, final_key = stream_keys(13)
    mesh = make_mesh()
    sharding = paths_sharding(mesh)

    @jax.jit
    def success_rate(params, w, key):
        outs = simulate_paths(
            params, w, key,
            n_paths=128, t_scan=120, retirement_years=5, traj_len=0,
            dtype=jnp.float64,
        )
        shard = jax.lax.with_sharding_constraint(outs.success, sharding)
        return jnp.mean(shard.astype(jnp.float64)) * 100.0

    rate = float(success_rate(params, jnp.int32(24), final_key))
    outs = simulate_paths(
        params, jnp.int32(24), final_key,
        n_paths=128, t_scan=120, retirement_years=5, traj_len=0,
        dtype=jnp.float64,
    )
    assert rate == pytest.approx(float(np.mean(np.asarray(outs.success))) * 100.0)


def test_probe_backend_resolution(monkeypatch):
    """Auto backend policy: the kernel on a bare GPU, its sharded form on a
    meshed GPU, the scan on the CPU or at float64, and an error on any
    other platform (no hidden fallback)."""
    import jax as _jax
    import jax.numpy as _jnp

    from monte_carlo_retirement_tpu.engine.runner import Engine
    from tests.conftest import make_config

    eng = Engine(make_config(), dtype=_jnp.float32)
    # CPU (the test platform): always scan regardless of mesh
    assert eng._resolve_probe_backend(None) == "scan"
    assert eng._resolve_run_backend(None) == "scan"

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    assert eng._resolve_probe_backend(None) == "pallas"
    assert eng._resolve_run_backend(None) == "pallas"

    eng_mesh = Engine(make_config(), dtype=_jnp.float32, mesh=make_mesh())
    assert eng_mesh._resolve_probe_backend(None) == "pallas_sharded"
    assert eng_mesh._resolve_run_backend(None) == "pallas_sharded"

    eng64 = Engine(make_config(), dtype=_jnp.float64)
    assert eng64._resolve_probe_backend(None) == "scan"

    # explicit override always wins
    assert eng._resolve_probe_backend("scan") == "scan"
    monkeypatch.setenv("MCRT_RUN_BACKEND", "scan")
    assert eng._resolve_run_backend(None) == "scan"

    monkeypatch.setattr(_jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        eng._resolve_probe_backend(None)


def test_extreme_horizon_falls_back_to_scan():
    """The kernel has no horizon limit any more (each recorded year is one
    row store in device memory), so an extreme working horizon keeps the
    kernel: its trajectory width covers the horizon and the kernel at that
    width records the final year like the scan does."""
    import jax.numpy as _jnp
    import numpy as _np

    from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        BLOCK_PATHS,
        pallas_simulate_full,
    )
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.timing import expected_trajectory_length
    from tests.conftest import make_config

    eng = Engine(make_config(retirement_years=2), dtype=_jnp.float32)
    months = 266 * 12  # wider than any on-chip series buffer would hold
    traj_len = eng._pallas_traj_len(months)
    L = expected_trajectory_length(months, 2)
    assert traj_len >= L
    full = pallas_simulate_full(
        eng.params, months, eng._key("final"), n_paths=BLOCK_PATHS,
        retirement_years=2, n_streams=eng.params.n_streams,
        statics=eng.statics, traj_len=traj_len, interpret=True,
    )
    outs = simulate_paths(
        eng.params, _jnp.int32(months), eng._key("final"),
        n_paths=BLOCK_PATHS, t_scan=months + 24, retirement_years=2,
        traj_len=L, dtype=_jnp.float32,
    )
    traj_k = _np.asarray(full["trajectory"])[:BLOCK_PATHS, :L]
    traj_s = _np.asarray(outs.trajectory)
    assert _np.isfinite(traj_k).all()
    _np.testing.assert_allclose(traj_k[:, -1], traj_s[:, -1], rtol=1e-3)

    # A huge SEARCH CAP sizes one width for the scenario; overrides in the
    # same 10-year step share one width.
    eng2 = Engine(
        make_config(retirement_years=2, starting_working_months_search=30_000),
        dtype=_jnp.float32,
    )
    assert eng2._pallas_traj_len(12) >= expected_trajectory_length(12, 2)
    assert eng2._pallas_traj_len(1_210) == eng2._pallas_traj_len(1_310)


@pytest.mark.parametrize("n_devices", [16, 32])
def test_dryrun_multichip_wide_meshes(n_devices):
    """Run the full multi-chip dryrun at 16 and 32 virtual devices.

    The in-process suite is pinned at the conftest's 8-device mesh, so the
    global-block / block-offset arithmetic in the sharded Pallas entry
    points (each shard's draws keyed by GLOBAL path index)
    had only ever been exercised at n=8 — exactly the regime where an
    off-by-one in block-offset math hides. A clean subprocess forces a
    fresh CPU platform with n virtual devices and asserts n-shard ==
    1-device exactness across all four Pallas entry points plus the XLA
    run/probe paths (see __graft_entry__.dryrun_multichip)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["MCRT_WARMUP"] = "0"
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            f"import __graft_entry__ as g; g.dryrun_multichip({n_devices})",
        ],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=540,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]

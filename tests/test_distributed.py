"""Multi-host (DCN) tests: TWO REAL OS PROCESSES over gloo collectives.

The virtual-mesh tests (test_sharding, test_pallas_parity) prove sharding
correctness across devices *within* one process. These tests prove the
multi-controller story across processes — the thing a multi-host deployment
actually runs: ``jax.distributed.initialize`` forms a global runtime, the
'paths' mesh spans both processes' devices, the engine executes one SPMD
program, and cross-process collectives reduce the summary.

Pinned invariants:
  * both processes compute the IDENTICAL replicated summary;
  * the union of the processes' addressable per-path shards reproduces a
    single-process run bit-for-bit (device-count-invariant RNG + kernel);
  * the cross-process collective reductions agree with the local ones.

Reference analog: none — the reference's widest scale-out is a
single-host multiprocessing.Pool (backend/simulation.py:982-1010).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_pair():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            MCRT_COORDINATOR=f"127.0.0.1:{port}",
            MCRT_NUM_PROCESSES="2",
            MCRT_PROCESS_ID=str(pid),
            MCRT_LOCAL_DEVICE_COUNT="2",
            MCRT_WARMUP="0",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=REPO,
            )
        )
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=540)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
            assert lines, f"no RESULT line:\n{out[-1000:]}\n{err[-2000:]}"
            results.append(json.loads(lines[0][len("RESULT "):]))
    finally:
        # One worker failing must not strand its peer: an unreaped worker
        # keeps spinning on collectives and poisons every later run on
        # this machine (observed: a stranded pair from a failed run made
        # the next invocation hang for its full timeout).
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)
    return results


@pytest.fixture(scope="module")
def pair_results():
    return _launch_pair()


def _single_process_reference(n_paths: int):
    """The same tiny workload the workers run, unsharded in this process."""
    from monte_carlo_retirement_tpu.config import Config, load_config_from_json
    from monte_carlo_retirement_tpu.engine.runner import _run_jit
    from monte_carlo_retirement_tpu.models.retirement import SimParams
    from monte_carlo_retirement_tpu.ops.shocks import stream_keys

    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["retirement_years"] = 5
    raw["seed"] = 1234
    raw["initial_balance"] = 120_000.0
    raw["monthly_expenses"] = 5_000.0
    config = Config(**raw)
    params = SimParams.from_config(config, dtype=jnp.float64)
    _, final_key = stream_keys(int(config.seed))
    return _run_jit(
        params,
        jnp.asarray(24, dtype=jnp.int32),
        final_key,
        jnp.arange(5, dtype=jnp.int32),
        n_paths=n_paths,
        t_scan=120,
        retirement_years=5,
        traj_len=11,
        dtype=jnp.float64,
        mesh=None,
    )


def test_two_process_global_mesh_formed(pair_results):
    r0, r1 = sorted(pair_results, key=lambda r: r["process"])
    assert r0["num_processes"] == r1["num_processes"] == 2
    assert r0["global_devices"] == r1["global_devices"] == 4
    assert r0["coordinator"] and not r1["coordinator"]
    # Each process holds only its half of the global paths axis, and the
    # halves are disjoint: the work was actually split across processes.
    starts0 = {s["start"] for s in r0["shards"]}
    starts1 = {s["start"] for s in r1["shards"]}
    assert starts0 == {0, 16} and starts1 == {32, 48}


def test_replicated_summary_identical_across_processes(pair_results):
    r0, r1 = pair_results
    assert json.dumps(r0["summary"], sort_keys=True) == json.dumps(
        r1["summary"], sort_keys=True
    )


def test_cross_process_run_matches_single_process(pair_results):
    """(H x D) mesh == 1 process, bit-for-bit per path, exact reductions."""
    n_paths = pair_results[0]["n_paths"]
    outs, summary = _single_process_reference(n_paths)

    # Reassemble the global final-balance vector from both processes'
    # addressable shards; every element must match the unsharded run.
    got = np.full((n_paths,), np.nan)
    for r in pair_results:
        for s in r["shards"]:
            vals = np.asarray(s["final_balance"])
            got[s["start"]: s["start"] + len(vals)] = vals
    assert not np.isnan(got).any()
    np.testing.assert_allclose(
        got, np.asarray(outs.final_balance), rtol=1e-12, atol=0
    )

    # The gloo-reduced summary agrees with the local reduction. Success is
    # a 0/1 sum (exact in f64 regardless of reduction order); quantile
    # bisection counts are integral too, so the tables are exact.
    s0 = pair_results[0]["summary"]
    assert s0["success_probability"] == pytest.approx(
        float(summary.success_probability), abs=1e-9
    )
    # A mixed outcome (some ruins, some survivals) so the reductions are
    # non-degenerate — guard against the scenario drifting trivial.
    assert 0.0 < s0["success_probability"] < 100.0
    np.testing.assert_allclose(
        np.asarray(s0["final_balance_percentiles"], dtype=np.float64),
        np.asarray(summary.final_balance_percentiles),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(s0["trajectory_percentiles"], dtype=np.float64),
        np.asarray(summary.trajectory_percentiles),
        rtol=1e-12,
    )
    wr_got = np.asarray(
        [[np.nan if v is None else v for v in row]
         for row in s0["wr_percentiles"]],
        dtype=np.float64,
    )
    wr_ref = np.asarray(summary.wr_percentiles)
    np.testing.assert_allclose(wr_got, wr_ref, rtol=1e-12, equal_nan=True)


def test_multihost_reduced_serving_matches_single_process(pair_results):
    """Engine.run(reduced=True) — the serving fast path — works under a
    cross-process mesh (it fetches only replicated reduced tables) and
    reproduces the single-process result exactly."""
    from monte_carlo_retirement_tpu.config import Config, load_config_from_json
    from monte_carlo_retirement_tpu.engine.runner import Engine

    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["retirement_years"] = 5
    raw["seed"] = 1234
    raw["initial_balance"] = 120_000.0
    raw["monthly_expenses"] = 5_000.0
    n_paths = pair_results[0]["n_paths"]
    rr = Engine(Config(**raw), dtype=jnp.float64).run(
        24, n_paths, stream="final", reduced=True
    )

    for r in pair_results:
        red = r["reduced"]
        assert red["success_probability"] == pytest.approx(
            rr.success_probability, abs=1e-9
        )
        assert red["swr"] == pytest.approx(rr.swr, rel=1e-12)
        np.testing.assert_allclose(
            np.asarray(red["final_balance_percentiles"]),
            rr.final_balance_percentiles,
            rtol=1e-12,
        )
        np.testing.assert_array_equal(
            np.asarray(red["finals_hist_counts"]), rr.bins.finals_hist_counts
        )
        np.testing.assert_array_equal(
            np.asarray(red["ruin_counts"]), rr.bins.ruin_counts
        )


def test_multihost_chunked_run_matches_single_process(pair_results):
    """HBM chunking COMPOSED with the cross-process mesh: the workers split
    an oversized run into two mesh-sized chunks over the (2 proc x 2 dev)
    global mesh; the reduced tables must equal this process's SINGLE-device
    UNCHUNKED run bit for bit. The block_offset bookkeeping at chunk
    boundaries (runner.py _run_chunked) is exactly where a multi-controller
    off-by-one would hide."""
    from monte_carlo_retirement_tpu.config import Config, load_config_from_json
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.ops.quantiles import exact_quantiles

    r0, r1 = pair_results
    # Both processes report the identical replicated chunked tables.
    assert json.dumps(r0["chunked"], sort_keys=True) == json.dumps(
        r1["chunked"], sort_keys=True
    )
    ch = r0["chunked"]

    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw["retirement_years"] = 2
    raw["seed"] = 1234
    raw["initial_balance"] = 120_000.0
    raw["monthly_expenses"] = 6_600.0  # mixed outcomes (~66% success)
    eng = Engine(Config(**raw), dtype=jnp.float32)  # mesh-less, unchunked
    from monte_carlo_retirement_tpu.engine.pallas_kernel import (
        pallas_simulate_full,
    )

    n, w = ch["n_paths"], ch["working_months"]
    traj_len = eng._pallas_traj_len(w)
    full = pallas_simulate_full(
        eng.params, jnp.asarray(w, jnp.int32), eng._key("final"),
        n_paths=n, retirement_years=eng.retirement_years,
        n_streams=eng.params.n_streams, statics=eng.statics,
        traj_len=traj_len, interpret=True,
    )
    succ = np.asarray(full["success"][:n]) > 0.5
    assert ch["success_probability"] == pytest.approx(
        succ.mean() * 100.0, abs=1e-9
    )
    assert 0.0 < ch["success_probability"] < 100.0  # non-degenerate
    want_traj = np.asarray(exact_quantiles(
        jnp.asarray(full["trajectory"][:n]),
        jnp.asarray([0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95], jnp.float32),
    ))
    got_traj = np.asarray(ch["trajectory_percentiles"], dtype=np.float32)
    np.testing.assert_array_equal(
        got_traj, want_traj[:, : got_traj.shape[1]]
    )
    np.testing.assert_array_equal(
        np.asarray(ch["wr_observation_counts"]),
        (~np.isnan(np.asarray(full["withdrawal_rates"][:n]))).sum(axis=0),
    )
    want_finals = np.asarray(exact_quantiles(
        jnp.asarray(full["final_balance"][:n]).reshape(-1, 1),
        jnp.asarray([0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99],
                    jnp.float32),
    )).ravel()
    np.testing.assert_array_equal(
        np.asarray(ch["final_balance_percentiles"], dtype=np.float32),
        want_finals,
    )


def test_cross_process_search_matches_single_process(pair_results):
    """find_minimum_working_months driven END-TO-END across two processes:
    every probe batch is one SPMD dispatch over the global mesh, the
    replicated success reductions feed the host-side ladder->verify loop,
    and both processes must walk the IDENTICAL search (a divergent probe
    result would desynchronize the next collective). The answer, final
    probability, and full search curve must equal a single-process
    mesh-less run exactly — success counts are integral sums, so sharding
    cannot perturb them even in the last bit.

    Reference analog: backend/simulation.py:1138-1343 (the flagship host
    algorithm), which only ever ran single-process."""
    from monte_carlo_retirement_tpu.config import Config, load_config_from_json
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from monte_carlo_retirement_tpu.search.driver import (
        find_minimum_working_months as search_months,
    )

    r0, r1 = pair_results
    assert r0["search"] == r1["search"]
    got = r0["search"]

    # Same scenario the workers search (keep in sync with dist_worker.py).
    raw = load_config_from_json(os.path.join(REPO, "config.json"))
    raw.update(
        retirement_years=3,
        seed=1234,
        initial_balance=120_000.0,
        monthly_expenses=8_000.0,
        num_simulations_search=64,
        target_probability=90.0,
        starting_working_months_search=0,
    )
    eng = Engine(Config(**raw), dtype=jnp.float64)  # mesh-less
    months, prob, curve = search_months(
        lambda ms: eng.probe(list(ms), 64, stream="search",
                             horizon_months=396),
        starting_working_months=0,
        target_probability_pct=90.0,
        sim_count=64,
        scenario_name="dist-search",
        verbose=False,
    )
    assert got["months"] == months
    assert got["probability"] == prob
    assert 0.0 < prob < 100.0  # mixed outcomes: the pin is non-degenerate
    assert got["curve"] == curve
    # The search actually exercised both phases (ladder + verify sweep).
    probed = [pt["working_months"] for pt in curve]
    assert any(m % 12 for m in probed), "verification sweep never ran"


def test_initialize_from_env_requires_complete_triplet(monkeypatch):
    from monte_carlo_retirement_tpu.parallel import distributed

    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.delenv(distributed.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(distributed.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError, match="all three are required"):
        distributed.initialize_from_env()


def test_initialize_from_env_noop_when_unset(monkeypatch):
    from monte_carlo_retirement_tpu.parallel import distributed

    monkeypatch.delenv(distributed.ENV_COORDINATOR, raising=False)
    assert distributed.initialize_from_env() is False


def test_coordinator_helpers_single_process():
    from monte_carlo_retirement_tpu.parallel import distributed

    assert distributed.is_distributed() is False
    assert distributed.is_coordinator() is True
    assert jax.process_count() == 1


def test_engine_mesh_auto_env(monkeypatch):
    """MCRT_MESH=auto opts a mesh-less Engine into all local devices —
    the no-code-change scale-out knob for multi-chip serving hosts."""
    from monte_carlo_retirement_tpu.engine.runner import Engine
    from tests.conftest import make_config

    monkeypatch.setenv("MCRT_MESH", "auto")
    eng = Engine(make_config(retirement_years=5), dtype=jnp.float64)
    assert eng.mesh is not None
    assert eng.mesh.devices.size == 8
    outs = eng.run(12, 16, stream="final")
    assert np.isfinite(np.asarray(outs.final_balance)).all()

    monkeypatch.delenv("MCRT_MESH")
    assert Engine(make_config(), dtype=jnp.float64).mesh is None


def _payloads_close(a, b, path="$"):
    """Recursive payload equality: floats to 1e-9 relative, rest exact."""
    if isinstance(a, float) and isinstance(b, float):
        if a != a and b != b:  # NaN == NaN for payload purposes
            return
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _payloads_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _payloads_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_mesh_auto_serving_payload_matches_meshless(monkeypatch):
    """The full API payload (pandas assembly) must be invariant to
    MCRT_MESH=auto sharding the engine over the 8-device mesh."""
    from monte_carlo_retirement_tpu.engine.simulator import (
        RetirementMonteCarloSimulator,
    )
    from monte_carlo_retirement_tpu.hosts.payload import build_result
    from monte_carlo_retirement_tpu.hosts.schemas import SimulationResponse
    from tests.conftest import make_config

    config = make_config(
        num_simulations_main=48, retirement_years=3, seed=77
    )

    def payload():
        sim = RetirementMonteCarloSimulator(config)
        return build_result(config, sim, required_w_months=24, search_curve=[])

    monkeypatch.delenv("MCRT_MESH", raising=False)
    base = payload()
    monkeypatch.setenv("MCRT_MESH", "auto")
    meshed = payload()
    SimulationResponse.model_validate(meshed)
    _payloads_close(base, meshed)


def test_force_local_device_count_replaces_flag(monkeypatch):
    from monte_carlo_retirement_tpu.parallel import distributed

    monkeypatch.setenv(
        "XLA_FLAGS", "--foo=1 --xla_force_host_platform_device_count=8"
    )
    distributed.force_local_device_count(2)
    flags = os.environ["XLA_FLAGS"]
    assert flags.count("xla_force_host_platform_device_count") == 1
    assert "--xla_force_host_platform_device_count=2" in flags
    assert "--foo=1" in flags

"""Path-parallel scaling demonstration on a virtual device mesh.

Runs the same 128k-path batch over 1/2/4/8 devices of an
--xla_force_host_platform_device_count mesh and reports wall-clock scaling.
(On a multi-GPU host the same code spans the cards; this demo uses
virtual CPU devices, so absolute times are meaningless — the point is that
the kernel + reductions shard transparently and scale.)

Run: PYTHONPATH=. python scripts/scaling_demo.py   (forces CPU internally)
"""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from monte_carlo_retirement_tpu.config import Config, load_config_from_json
from monte_carlo_retirement_tpu.engine.kernel import simulate_paths
from monte_carlo_retirement_tpu.models.retirement import SimParams
from monte_carlo_retirement_tpu.ops.shocks import stream_keys
from monte_carlo_retirement_tpu.parallel.mesh import PATHS_AXIS

raw = load_config_from_json(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config.json"))
raw["retirement_years"] = 10
config = Config(**raw)
params = SimParams.from_config(config, dtype=jnp.float32)
_, key = stream_keys(7)
N = 128 * 1024
T = 120

results = []
for n_dev in (1, 2, 4, 8):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), (PATHS_AXIS,))
    sharding = NamedSharding(mesh, P(PATHS_AXIS))

    @jax.jit
    def run(w):
        outs = simulate_paths(
            params, w, key, n_paths=N, t_scan=T, retirement_years=10,
            traj_len=0, dtype=jnp.float32,
        )
        succ = jax.lax.with_sharding_constraint(outs.success, sharding)
        return jnp.mean(succ.astype(jnp.float32)) * 100.0

    rate = float(run(jnp.int32(0)))  # compile + correctness
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        float(run(jnp.int32(rep)))
        times.append(time.perf_counter() - t0)
    best = min(times)
    results.append((n_dev, best, rate))
    base = results[0][1]
    print(f"{n_dev} device(s): {best*1000:8.1f} ms   speedup {base/best:4.2f}x   "
          f"success {rate:.2f}%")

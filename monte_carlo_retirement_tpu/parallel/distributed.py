"""Multi-host runtime initialization — ``jax.distributed`` glue.

The reference has no distributed execution at all: its widest scale-out is
a single-host ``multiprocessing.Pool`` over Monte-Carlo paths (reference:
backend/simulation.py:982-1010). This framework's multi-host story is the
standard JAX multi-controller SPMD pattern:

  * every host runs the SAME program;
  * :func:`initialize` (or :func:`initialize_from_env`) forms the global
    distributed runtime before any JAX computation;
  * ``parallel.mesh.make_mesh()`` then spans every device in the job,
    because ``jax.devices()`` is global after initialization. JAX orders
    global devices by process, so same-host devices stay mesh-adjacent:
    path-axis collectives run mostly within a host and only the final
    KB-scale reduced tables cross the network between hosts;
  * the kernels need NO changes — the scan kernel's per-path counter RNG
    and the Pallas kernel's global-path keying are device-count
    invariant, so an (H hosts x D devices/host) mesh reproduces the
    single-process run bit-for-bit.

That last claim is *executed*, not just documented: tests/test_distributed.py
boots two real OS processes on the gloo-backed CPU collectives runtime,
runs the sharded engine over the cross-process global mesh, and pins the
per-path outputs and reduced summary against a single-process run.

Side effects (plots, result files, HTTP responses) belong to the
coordinator only — gate them on :func:`is_coordinator`.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

logger = logging.getLogger("mcrt.distributed")

_initialized = False

ENV_COORDINATOR = "MCRT_COORDINATOR"
ENV_NUM_PROCESSES = "MCRT_NUM_PROCESSES"
ENV_PROCESS_ID = "MCRT_PROCESS_ID"
ENV_LOCAL_DEVICES = "MCRT_LOCAL_DEVICE_COUNT"

_DEVICE_COUNT_FLAG = re.compile(
    r"--xla_force_host_platform_device_count=\d+\s*"
)


def force_local_device_count(n: int) -> None:
    """Expose ``n`` virtual CPU devices in this process (test/demo rigs).

    Must run before the JAX backend initializes. Replaces (never stacks)
    any device-count flag already present in ``XLA_FLAGS`` — the flag
    parser honors the last occurrence, but a replaced value reads
    unambiguously in logs and child environments.
    """
    flags = _DEVICE_COUNT_FLAG.sub("", os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={int(n)}".strip()
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or form) the multi-host runtime. Idempotent.

    With no arguments, defers to JAX's cluster auto-detection (SLURM,
    Open MPI, etc.); on a plain single host that detection raises
    and this returns False — single-process mode, nothing changes.

    Returns True iff the process is part of a multi-process runtime after
    the call.
    """
    global _initialized
    import jax

    # NOTE: nothing here may touch jax.devices()/process_count() before
    # jax.distributed.initialize — those calls initialize the local backend
    # and global device discovery would be forfeited.
    if _initialized:
        return True
    if jax.config.jax_platforms and "cpu" in jax.config.jax_platforms:
        # XLA:CPU's async dispatch runs independent executables on a thread
        # pool, so two multi-controller processes can enter gloo collectives
        # from INDEPENDENT programs in different orders — gloo matches
        # messages per TCP pair in arrival order and aborts the process with
        # "Received data size doesn't match expected size" (observed: 268 vs
        # 4 whenever warm-cache runs overlapped dispatches; cold compiles
        # serialize execution and mask it). Inline dispatch restores the
        # per-process program order the collective matching assumes. GPU
        # runs don't take this branch.
        jax.config.update("jax_cpu_enable_async_dispatch", False)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:
        if "already initialized" in str(exc).lower():
            _initialized = True
            return jax.process_count() > 1
        raise
    except Exception as exc:  # noqa: BLE001 — surface, then stay local
        if coordinator_address is not None:
            raise  # an explicit request to distribute must not be dropped
        logger.debug("single-process mode (auto-detect found no cluster: %s)", exc)
        return False
    _initialized = True
    logger.info(
        "distributed runtime up: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )
    # Auto-detection may legitimately come up as a 1-process runtime
    # (e.g. a single-host pod slice); the contract is "multi-process?".
    return jax.process_count() > 1


def initialize_from_env() -> bool:
    """Initialize from ``MCRT_COORDINATOR`` / ``MCRT_NUM_PROCESSES`` /
    ``MCRT_PROCESS_ID`` (all three required together);
    ``MCRT_LOCAL_DEVICE_COUNT`` optionally forces virtual CPU devices
    first (test/demo rigs). No-op returning False when unset."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    nproc = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)
    if nproc is None or pid is None:
        raise ValueError(
            f"{ENV_COORDINATOR} is set but {ENV_NUM_PROCESSES}/"
            f"{ENV_PROCESS_ID} are not — all three are required"
        )
    local = os.environ.get(ENV_LOCAL_DEVICES)
    if local:
        force_local_device_count(int(local))
    return initialize(coord, int(nproc), int(pid))


def is_distributed() -> bool:
    import jax

    return jax.process_count() > 1


def is_coordinator() -> bool:
    """True on the process that should perform side effects (plots, files,
    responses). Always True single-process."""
    import jax

    return jax.process_index() == 0

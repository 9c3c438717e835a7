"""Tracing & profiling utilities.

The reference had no profiling infrastructure (SURVEY §5); this build
provides: jax.profiler trace capture, per-phase device-time logging, and a
compile-awareness helper that distinguishes compile time from run time (the
first call through a jit boundary pays compilation; steady-state numbers are
what serving sees).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, Optional

import jax

log = logging.getLogger("mcrt.profiling")

# Accumulated wall time per phase name for the current process.
_PHASE_TOTALS: Dict[str, float] = {}
_PHASE_COUNTS: Dict[str, int] = {}


class _PhaseHandle:
    """Mutable handle yielded by ``device_timer``: assign the block's output
    to ``handle.result`` so the timer can block on it at exit — a value
    passed at context ENTRY could only ever be an input, which returns from
    block_until_ready immediately and under-reports device time."""

    result = None


@contextlib.contextmanager
def device_timer(phase: str, result=None) -> Iterator[_PhaseHandle]:
    """Time a device-bound phase.

    Usage::

        with device_timer("final_run") as t:
            t.result = engine_step(...)   # timer blocks on this at exit

    ``result`` may also be passed at entry for pre-existing arrays. Logs the
    elapsed wall time and accumulates per-phase totals retrievable with
    ``phase_timings()``. The first occurrence of a phase usually includes
    XLA compilation; the log flags it.
    """
    first = phase not in _PHASE_TOTALS
    handle = _PhaseHandle()
    handle.result = result
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        if handle.result is not None:
            jax.block_until_ready(handle.result)
        dt = time.perf_counter() - t0
        _PHASE_TOTALS[phase] = _PHASE_TOTALS.get(phase, 0.0) + dt
        _PHASE_COUNTS[phase] = _PHASE_COUNTS.get(phase, 0) + 1
        log.info(
            "phase '%s': %.1f ms%s",
            phase,
            dt * 1000,
            " (first call — includes compile)" if first else "",
        )


def phase_timings() -> Dict[str, Dict[str, float]]:
    """Per-phase totals: {phase: {total_s, calls, mean_ms}}."""
    return {
        phase: {
            "total_s": total,
            "calls": _PHASE_COUNTS[phase],
            "mean_ms": total / _PHASE_COUNTS[phase] * 1000.0,
        }
        for phase, total in _PHASE_TOTALS.items()
    }


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace (TensorBoard format) around a block.

    No-op when ``log_dir`` is falsy, so call sites can be left in place and
    enabled via a flag/env var.
    """
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", log_dir)

"""Profiling / tracing / throughput counters.

The reference's performance tooling is four ``cpu_time`` checkpoints
(``set3d.f90:52,271-273,314-316,652-654``).  The equivalents here, per
SURVEY.md §5: ``jax.profiler`` traces viewable in Perfetto/XProf, plus
cell-updates/s counters timed to completion: JAX dispatch is
asynchronous, so every timed region ends in ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from .logging import log_event


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (Perfetto/XProf) around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log_event("profiler", logdir=logdir)


def time_to_completion(fn: Callable, *args) -> Tuple[float, object]:
    """(seconds, result) for one completed execution of ``fn(*args)``.
    The first call compiles; call once before timing."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def measure_cell_updates_per_sec(step_scan: Callable[[int], Callable],
                                 phi0, *, warmup_steps: int = 5,
                                 bench_steps: int = 40) -> dict:
    """The BASELINE metric: cell-updates/sec for a grid-stepping solver.

    ``step_scan(n)`` must return a callable running n fused steps on phi.
    Fixed overhead (dispatch) is removed by differencing two step counts
    — the same protocol as bench.py.
    """
    cells = 1
    for d in phi0.shape:
        cells *= d
    small = jax.jit(step_scan(warmup_steps))
    big = jax.jit(step_scan(bench_steps))
    jax.block_until_ready(small(phi0))     # compile
    jax.block_until_ready(big(phi0))
    t0 = time.perf_counter()
    jax.block_until_ready(small(phi0))
    t1 = time.perf_counter()
    jax.block_until_ready(big(phi0))
    t2 = time.perf_counter()
    per_step = max(((t2 - t1) - (t1 - t0)) / (bench_steps - warmup_steps),
                   1e-9)
    out = {"cell_updates_per_sec": cells / per_step,
           "seconds_per_step": per_step, "cells": cells}
    log_event("throughput", **out)
    return out

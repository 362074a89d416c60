"""Resumable solver loops: chunked pseudo-time integration with periodic
orbax checkpoints and divergence detection.

The reference's only failure handling is STOP-on-NaN (``subs.f90:926``,
``set3d.f90:458``).  Per SURVEY.md §5 the descendants here are (a) periodic
checkpoints of phi + iteration counter so a preempted run resumes,
and (b) convergence-divergence detection — RMS rising across chunks — as
the logical extension of the NaN tripwire.

Design: the inner solver (``reinit``/``minmax_flow``) stays a fully fused
``lax.while_loop``; resumability lives OUTSIDE jit as a host-level loop over
chunks of iterations.  Only one scalar fetch (iterations, rms) happens per
chunk, so checkpoint cadence — not step count — sets the host-sync cost.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp

from ..utils.checkpoint import FieldCheckpointer
from ..utils.logging import log_event
from .minmax_flow import minmax_flow
from .reinit import reinit


@dataclasses.dataclass
class ResumableResult:
    phi: jnp.ndarray
    iterations: int
    final_rms: float
    converged: bool
    diverged: bool
    resumed_from: Optional[int]     # step resumed from, None if fresh


def _run_chunked(run_chunk: Callable, phi0, total_iters: int, tol: float,
                 ckpt: Optional[FieldCheckpointer], chunk: int,
                 stage: str, divergence_patience: int = 2,
                 divergence_growth: float = 1.0) -> ResumableResult:
    """Shared chunked driver.  ``run_chunk(phi, iters) -> (phi, n, rms)``."""
    phi = phi0
    done_iters = 0
    resumed_from = None
    if ckpt is not None:
        state = ckpt.restore(like=phi0)
        if state is not None:
            phi = jnp.asarray(state["phi"], phi0.dtype)
            done_iters = int(state["extra"].get("iterations", state["step"]))
            resumed_from = state["step"]
            log_event(stage, event="resume", step=state["step"],
                      iterations=done_iters)

    prev_rms = float("inf")
    rising = 0
    rms = float("nan")
    converged = diverged = False
    while done_iters < total_iters:
        n_iters = min(chunk, total_iters - done_iters)
        phi, n, rms_a = run_chunk(phi, n_iters)
        n, rms = int(n), float(rms_a)
        done_iters += n
        if ckpt is not None:
            ckpt.save(done_iters, phi, extra={"iterations": done_iters,
                                              "rms": rms, "stage": stage})
        log_event(stage, event="chunk", iterations=done_iters, rms=rms)
        if jnp.isnan(rms):
            diverged = True
            break
        if rms < tol:
            converged = True
            break
        # divergence detection: RMS rising across consecutive chunks
        if rms > prev_rms * divergence_growth:
            rising += 1
            if rising >= divergence_patience:
                diverged = True
                log_event(stage, event="divergence_detected", rms=rms,
                          prev_rms=prev_rms)
                break
        else:
            rising = 0
        prev_rms = rms
    if ckpt is not None:
        ckpt.wait()
    return ResumableResult(phi=phi, iterations=done_iters, final_rms=rms,
                           converged=converged, diverged=diverged,
                           resumed_from=resumed_from)


def reinit_resumable(phi0, dx, h, iters: int, tol: float, *,
                     ckpt: Optional[FieldCheckpointer] = None,
                     chunk: int = 200, **reinit_kw) -> ResumableResult:
    """Eikonal reinitialization with periodic checkpoint/resume.

    Every chunk freezes the sign source at the ORIGINAL ``phi0``
    (``sign_src=phi0``, mirroring the reference's phiS frozen at solver
    entry, subs.f90:731), so a resumed trajectory is step-for-step identical
    to an uninterrupted run — chunk boundaries are invisible.  ``phi0`` must
    therefore be the same original field on resume (the pipeline recomputes
    it deterministically from the input mesh).
    """
    def run_chunk(phi, n_iters):
        r = reinit(phi, dx, h, n_iters, tol, sign_src=phi0, **reinit_kw)
        return r.phi, r.iterations, r.final_rms

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "reinit")


def minmax_resumable(phi0, dx, h1, iters: int, tol: float, *,
                     ckpt: Optional[FieldCheckpointer] = None,
                     chunk: int = 500, **minmax_kw) -> ResumableResult:
    """Min/max smoothing flow with periodic checkpoint/resume."""
    def run_chunk(phi, n_iters):
        m = minmax_flow(phi, dx, h1, n_iters, tol, **minmax_kw)
        return m.phi, m.iterations, m.final_rms

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "minmax")


def reinit_resumable_sharded(solver, phi0, h, iters: int, tol: float, *,
                             ckpt: Optional[FieldCheckpointer] = None,
                             chunk: int = 200) -> ResumableResult:
    """Checkpoint/resume COMPOSED with domain decomposition (the
    pipeline used to XOR the two strategies, so no product
    path performed a preemption-safe multi-device solve — the scenario
    SURVEY §5 invented checkpointing for).

    ``solver`` is a :class:`~..parallel.sharded.ShardedLevelSet`;
    ``phi0`` a sharded device array (``solver.device_put``).  Chunks stay
    fully fused sharded while_loops; orbax saves/restores the sharded
    array in place (restore uses ``like=phi0``'s sharding, so the field
    never gathers to one device).  Sign source frozen at the original
    phi0, so a resumed trajectory is step-for-step an uninterrupted run.
    """
    def run_chunk(phi, n_iters):
        return solver.reinit(phi, h, n_iters, tol, sign_src=phi0)

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "reinit")


def minmax_resumable_sharded(solver, phi0, h1, iters: int, tol: float, *,
                             ckpt: Optional[FieldCheckpointer] = None,
                             chunk: int = 500, band_radius: float = 4.1,
                             threshold: float = 0.0) -> ResumableResult:
    """Sharded min/max flow with periodic checkpoint/resume (see
    :func:`reinit_resumable_sharded`)."""
    def run_chunk(phi, n_iters):
        return solver.minmax_flow(phi, h1, n_iters, tol,
                                  band_radius=band_radius,
                                  threshold=threshold)

    return _run_chunked(run_chunk, phi0, iters, tol, ckpt, chunk, "minmax")

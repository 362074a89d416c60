"""Per-iteration metrics stream from inside fused solver loops.

The reference's only live observability is the ``Iteration / RMS Error``
line it prints every pseudo-time step of both hot loops (``subs.f90:923``,
``set3d.f90:456``).  The solvers here run those loops as fused
``lax.while_loop`` programs — without this module a 10,000-iteration solve
is a black box until it exits.  SURVEY.md §5 translates the reference's
prints to "structured per-iteration metrics (RMS, cells/s) from host
callbacks, only from process 0"; this is that stream.

Design:
- ``emit_iteration`` is called inside the loop body.  With ``every == 0``
  (the default) it compiles to NOTHING — zero overhead when disabled.
- Enabled, it gates a ``jax.debug.callback`` behind ``n % every == 0``
  (``lax.cond``).  The callback is unordered/async: it does not fence the
  device pipeline, and each event carries its own iteration number so the
  host can reorder.  Only process 0 emits (trace-time guard).
- The host sink timestamps arrivals and derives cells/s from consecutive
  events of the same stage; events are kept in a ring buffer and mirrored
  to the structured log (:mod:`.logging`) as ``{"stage": "iteration", ...}``
  lines — the modern form of the reference's print.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import jax
import jax.numpy as jnp


class MetricsStream:
    """Host-side sink for in-loop iteration events."""

    def __init__(self, max_events: int = 4096, log: bool = True):
        self.events = collections.deque(maxlen=max_events)
        self.log = log
        self._lock = threading.Lock()
        self._last: dict = {}          # stage -> (iter, wall time)

    def record(self, stage: str, n: int, rms: float, cells: int) -> None:
        now = time.perf_counter()
        cells_per_s = None
        with self._lock:
            last = self._last.get(stage)
            if last is not None and n > last[0] and now > last[1]:
                cells_per_s = (n - last[0]) * cells / (now - last[1])
            self._last[stage] = (n, now)
            ev = {"stage_name": stage, "iteration": n, "rms": rms,
                  "t": now}
            if cells_per_s is not None:
                ev["cells_per_s"] = cells_per_s
            self.events.append(ev)
        if self.log:
            from .logging import log_event
            log_event("iteration", **ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._last.clear()


_stream = MetricsStream()


def get_stream() -> MetricsStream:
    return _stream


def set_stream(stream: MetricsStream) -> MetricsStream:
    global _stream
    _stream = stream
    return stream


def emit_iteration(stage: str, every: int, n, rms,
                   cells: Optional[int] = None):
    """Emit one {iter, rms} event every ``every`` iterations.

    Call inside a jitted loop body.  ``every`` is STATIC: 0 disables and
    traces to nothing.  ``n``/``rms`` are traced scalars; ``cells`` the
    static grid-cell count used for host-side cells/s.
    """
    if not every:
        return
    if jax.process_index() != 0:       # only process 0 (SURVEY §5)
        return
    cells_i = int(cells or 0)

    def _tap(n_, rms_):
        _stream.record(stage, int(n_), float(rms_), cells_i)

    n = jnp.asarray(n)
    rms_a = jnp.asarray(rms)

    def _emit():
        jax.debug.callback(_tap, n, rms_a)

    jax.lax.cond((n % jnp.asarray(every, n.dtype)) == 0, _emit,
                 lambda: None)

"""Structured metrics/logging.

Reference observability is unstructured ``PRINT*`` lines (stage banners at
``set3d.f90:189-194,291,323,542``, per-iteration RMS at ``subs.f90:923`` /
``set3d.f90:456``).  The equivalent here, per SURVEY.md §5: structured
per-stage/per-iteration records, emitted only from process 0 on multi-host
runs.
"""

from __future__ import annotations

import json
import logging
import sys
import time

import jax

logger = logging.getLogger("levelsetfortran_jax")


def is_primary() -> bool:
    return jax.process_index() == 0


def log_event(stage: str, **fields) -> None:
    """One structured JSON record per event, process-0 only."""
    if not is_primary():
        return
    rec = {"stage": stage, "t": time.time(), **fields}
    logger.info(json.dumps(rec, default=float))


def configure(level=logging.INFO, stream=sys.stderr) -> None:
    h = logging.StreamHandler(stream)
    h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(h)
    logger.setLevel(level)


class StageTimer:
    """Wall-clock stage timing — the structured descendant of the
    reference's four cpu_time checkpoints (set3d.f90:52,271,314,652)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = {}

    def mark(self, name: str):
        self.marks[name] = time.perf_counter() - self.t0
        log_event("timer", name=name, seconds=self.marks[name])
        return self.marks[name]

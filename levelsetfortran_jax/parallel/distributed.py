"""Multi-process process-group initialization.

The reference is single-process (``README.md:19``).  A multi-process run
calls ``jax.distributed.initialize`` once per process before any device
query; afterwards ``jax.devices()`` spans every process and the 3D mesh of
:mod:`.mesh` shards grids across them (SURVEY.md §5 "Distributed
communication backend").

Nothing is discovered from the environment: a multi-process run names its
coordinator (``host:port``), process count and process id explicitly.
"""

from __future__ import annotations

from typing import Optional

import jax

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Idempotent ``jax.distributed.initialize``.

    With no arguments this is a single-process run: nothing is initialized
    and the result is False.  With arguments, all three must be given, and
    a failure to join the group raises — a run that meant to span several
    processes never continues on one.  Returns True once a multi-process
    group is active.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        return False
    if any(a is None for a in args):
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id together")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that should write outputs/checkpoint metadata."""
    return jax.process_index() == 0

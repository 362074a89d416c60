"""Checkpoint / resume of solver state (orbax/tensorstore).

The reference has no checkpointing; its two mid-pipeline ``.vti`` dumps
(``set3d.f90:336-351,553-569``) are de-facto stage checkpoints of the field.
The equivalent here, per SURVEY.md §5: periodic checkpoints of the (possibly
sharded) phi array plus the iteration counter, so a preempted run resumes
instead of restarting; orbax handles per-shard tensorstore IO and restores
into any device layout via an abstract target.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "checkpoint/resume (--checkpoint-dir) needs the "
            "orbax-checkpoint package, which is not installed "
            "(pip install 'levelsetfortran-jax[checkpoint]')") from e
    return ocp


class FieldCheckpointer:
    """Thin orbax CheckpointManager wrapper for {phi, json-metadata} states.

    The array goes through orbax's tensorstore path (sharded-aware); the
    metadata (iteration counter, stage name, rms) is a JSON item.

    Usage::

        ckpt = FieldCheckpointer("/path/ckpt", max_to_keep=3)
        ckpt.save(step, phi, extra={"rms": 1e-3, "stage": "reinit"})
        step = ckpt.latest_step()          # None if no checkpoint
        state = ckpt.restore(like=phi)     # {"phi", "extra", "step"}
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        ocp = _ocp()
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
                create=True))

    def save(self, step: int, phi, extra: Optional[dict] = None,
             *, wait: bool = False) -> bool:
        ocp = _ocp()
        saved = self._mgr.save(int(step), args=ocp.args.Composite(
            state=ocp.args.StandardSave({"phi": phi}),
            meta=ocp.args.JsonSave(dict(extra or {}))))
        if wait:
            self._mgr.wait_until_finished()
        return bool(saved)

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore(self, step: Optional[int] = None, *, like=None
                ) -> Optional[dict]:
        """Restore a checkpoint.  ``like`` (an array or ShapeDtypeStruct
        carrying a sharding) directs orbax to load phi directly into that
        layout — required to restore a sharded array onto a device mesh."""
        ocp = _ocp()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        if like is not None:
            abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, like)
            state_arg = ocp.args.StandardRestore({"phi": abstract})
        else:
            state_arg = ocp.args.StandardRestore()
        restored = self._mgr.restore(step, args=ocp.args.Composite(
            state=state_arg, meta=ocp.args.JsonRestore()))
        return {"phi": restored["state"]["phi"],
                "extra": dict(restored["meta"] or {}),
                "step": int(step)}

    def wait(self):
        self._mgr.wait_until_finished()

    def close(self):
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()


def save_stage_field(path: str, phi, grid=None) -> None:
    """Stage-boundary export kept for interchange/visualization: the ``.vti``
    dump role of the reference, while orbax owns resume state."""
    from ..io.vti import write_vti
    if grid is None:
        np.save(path, np.asarray(jax.device_get(phi)))
    else:
        write_vti(path, np.asarray(jax.device_get(phi), np.float64), grid)

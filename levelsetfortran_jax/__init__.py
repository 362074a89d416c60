"""levelsetfortran_jax — a differentiable level-set engine in JAX.

Brand-new JAX/XLA implementation of the capabilities of
musheen/LevelSetFortran (serial Fortran 90 reference): STL -> signed-distance
initialization -> WENO5/Godunov eikonal reinitialization -> min/max
curvature-flow smoothing -> surface-node advection -> .vti/.s3d outputs,
plus sharded multi-device execution and a differentiable SDF renderer that the
reference never had.
"""

from .config import LevelSetConfig, QuirkConfig, REFERENCE_PARITY
from .grid.grid import Grid3D, from_bbox, from_surface
from .io.stl import SurfaceMesh, read_stl, write_stl
from .io.vti import read_vti, write_vti
from .io.s3d import read_s3d, write_s3d

__version__ = "0.1.0"


def __getattr__(name):
    # Heavy entry points are lazy so `import levelsetfortran_jax` stays
    # cheap (no jax trace-time imports) for IO-only users.
    if name == "run":
        from .pipeline.run import run
        return run
    if name == "run_batch":
        from .pipeline.batch import run_batch
        return run_batch
    if name == "render_from_vertices":
        from .pipeline.differentiable import render_from_vertices
        return render_from_vertices
    if name == "reinit":
        from .solvers.reinit import reinit
        return reinit
    if name == "minmax_flow":
        from .solvers.minmax_flow import minmax_flow
        return minmax_flow
    if name == "advect_nodes":
        from .solvers.advect import advect_nodes
        return advect_nodes
    if name == "ShardedLevelSet":
        from .parallel.sharded import ShardedLevelSet
        return ShardedLevelSet
    raise AttributeError(name)

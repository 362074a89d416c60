"""Configuration schema for the level-set engine.

The reference (musheen/LevelSetFortran) hardcodes every solver knob as a
literal in the main program (see reference ``set3d.f90``: dx at :140,
pad cells at :148, reinit CFL/iters at :298-305, min/max CFL/iters at
:390-392, advect iters at :489, final reinit at :576-580) and band radii in
``subs.f90:194,199``.  Here every one of those literals becomes a typed,
documented config field, which is the config layer the reference README
promises ("Working on adding a namelist for inputs") but never shipped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class QuirkConfig:
    """Switches replicating reference-as-written behaviors that differ from
    the intended math.  Defaults implement the *correct* math; flip a flag to
    reproduce the reference bit pattern for parity studies.

    Each flag cites the reference line it models.
    """

    #: ``subs.f90:576``: y-direction WENO eps scaling uses p5 = 0
    #: (``phi(i,j+3,k) - phi(i,j+3,k)``) instead of the j+3/j+2 difference.
    weno_y_p5_zero: bool = False

    #: ``subs.f90:346``: order-8 first derivative y-stencil uses ``jp1``
    #: where symmetry requires ``jp2``.
    deriv8_y_jp1: bool = False

    #: ``subs.f90:227,233,239``: order-1 upwind branch adds instead of
    #: subtracting the neighbor.
    deriv1_plus_sign: bool = False


@dataclasses.dataclass(frozen=True)
class LevelSetConfig:
    """All solver hyper-parameters, mirroring reference literals.

    Stage structure follows ``set3d.f90``: grid setup -> inside/outside init
    -> reinit -> narrow band -> min/max flow -> node advection -> final
    reinit.
    """

    # --- grid (reference set3d.f90:140-157) ---
    dx: float = 0.05                    # set3d.f90:140
    pad_cells: int = 10                 # set3d.f90:148 ("dd")

    #: "distance" (default): exact point-triangle signed distance init —
    #: already |grad|=1, so Jacobi reinit converges in O(100) steps.
    #: "reference": the reference's smeared ±1 nearest-centroid field
    #: (set3d.f90:196-268) — needs O(domain/h) Jacobi steps to grow the
    #: far field (the reference's Gauss-Seidel sweeps hide this).
    init_mode: str = "distance"
    #: Spatial candidate culling for the "distance" init ("auto"/"off"):
    #: per-grid-block candidate triangle lists from conservative distance
    #: bounds (ops.init_sign.build_init_culling) — the sharpened form of
    #: the reference's bbox±3 subbox restriction (set3d.f90:180-186).
    init_culling: str = "auto"
    #: Grid-points-per-side of a culling block.
    init_cull_block: int = 16

    # --- narrow band radii in units of dx (subs.f90:194,199) ---
    band_radius: float = 4.1            # active band  |phi| < 4.1*dx
    stencil_band_radius: float = 8.1    # stencil band |phi| < 8.1*dx

    # --- initial reinitialization (set3d.f90:298-305) ---
    reinit_iters: int = 10000
    reinit_cfl: float = 0.1
    reinit_tol: float = 1e-5            # subs.f90:915

    # --- min/max curvature flow (set3d.f90:390-392, 448) ---
    minmax_iters: int = 10000
    minmax_cfl: float = 0.01
    minmax_tol: float = 1e-7
    minmax_threshold: float = 0.0       # subs.f90:471 ("thresh")
    minmax_avg_halfwidth: int = 1       # subs.f90:467 ("h")

    # --- node advection (set3d.f90:489) ---
    advect_iters: int = 1000
    advect_grad_order: int = 8          # set3d.f90:470
    advect_eps: float = 1e-13           # set3d.f90:493

    # --- final reinitialization (set3d.f90:576-580) ---
    final_reinit_iters: int = 2000
    final_reinit_cfl: float = 0.001

    # --- numerics ---
    dtype: jnp.dtype = jnp.float32      # f64 for reference parity
    weno_eps_scale: float = 1e-6        # subs.f90:533
    weno_eps_floor: float = 1e-99       # subs.f90:533 (clamped to dtype tiny)
    #: ``subs.f90:156`` declares ``eps = 1.E-13`` in phiSign but never reads
    #: it (dead literal); carried here for the record, not wired anywhere.
    sign_eps: float = 1e-13

    # --- execution strategy (no reference counterpart) ---
    #: Stream {iteration, rms, band_tiles, cells/s} events from inside the
    #: solver loops every N iterations (0 = off) — the structured form of
    #: the reference's per-iteration prints (subs.f90:923, set3d.f90:456).
    metrics_every: int = 0

    # --- sharding (absent in reference; SURVEY.md §2 rows 21-22) ---
    #: (mx, my, mz) over (x, y, z); "auto" factors all visible devices
    #: into the surface-minimising shape (parallel.mesh.factor3);
    #: None = single device.
    mesh_shape: Union[None, str, Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("x", "y", "z")
    halo_width: int = 4                 # WENO5 needs 3, order-8 derivs need 4
    steps_per_exchange: int = 1         # halo-deep pipelining depth (k)
    #: Overlap the halo exchange with interior compute (k=1 only): the
    #: interior stencil pass is independent of the ppermutes, so XLA can
    #: run them concurrently; shard-face shells are recomputed after
    #: arrival (parallel.sharded.reinit_step_local_overlap).
    overlap: bool = False

    #: Gather the full fields to host numpy in PipelineResult (default).
    #: False keeps them as (possibly sharded) device arrays — at multi-device scale
    #: the O(grid) fields then never leave the mesh (outputs stream
    #: z-slabs; scalars and advected nodes are O(1)/O(n_nodes)).
    gather_results: bool = True

    # --- checkpoint/resume (absent in reference; SURVEY.md §5) ---
    checkpoint_dir: Optional[str] = None
    checkpoint_chunk: int = 500         # iterations between checkpoints

    quirks: QuirkConfig = dataclasses.field(default_factory=QuirkConfig)

    def __post_init__(self):
        if self.init_culling not in ("auto", "off"):
            raise ValueError("init_culling must be 'auto' or 'off'; "
                             f"got {self.init_culling!r}")

    def replace(self, **kw) -> "LevelSetConfig":
        return dataclasses.replace(self, **kw)

    @property
    def eps_floor(self) -> float:
        """WENO epsilon floor clamped so its square stays normal in dtype
        (see ops.weno.default_eps_floor)."""
        if self.dtype == jnp.float64:
            return self.weno_eps_floor
        # (1e-99)^2 — and even (1e-30)^2 — underflows f32/bf16.
        return 1e-18


#: Configuration that reproduces the reference program's exact behavior
#: (all quirks on, float64) for bit-level parity studies on CPU.
#: Culling is off: the culled init's per-block candidate order reassociates
#: the pseudonormal tie sum, which can flip the sign of points lying ON the
#: surface (|phi| ~ 1e-4; measured 2/462k on twoCube10) — parity goldens
#: pin the dense scan's exact bit pattern.
REFERENCE_PARITY = LevelSetConfig(
    dtype=jnp.float64,
    init_culling="off",
    quirks=QuirkConfig(
        weno_y_p5_zero=True,
        deriv8_y_jp1=True,
        deriv1_plus_sign=True,
    ),
)

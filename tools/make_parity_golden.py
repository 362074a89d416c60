"""Produce committed reference-parity golden fields (SURVEY.md §7, last
bullet; BASELINE configs 1-2) on the generated fixtures
(levelsetfortran_jax.models.fixtures).

No gfortran exists in this environment, so the REFERENCE_PARITY
configuration (float64, all reference quirks on — config.py) IS the
stand-in for the reference binary's output; this script pins its converged
fields so future numerics changes are gated by an allclose regression test
(tests/test_parity_golden.py) instead of only "quirks change something".

Also records the per-quirk impact table SURVEY §7 asks for: for each quirk
flag, the max|delta phi| of the converged field when that single quirk is
toggled off — written to PARITY_QUIRKS.md.

Usage (CPU, x64):
    python tools/make_parity_golden.py [--icosphere]

twoCube10 (24 triangles) runs in ~1 min; --icosphere adds the SDF-only
golden of the 20,480-triangle seeded icosphere (the cube40-class body).
"""

import argparse
import hashlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from levelsetfortran_jax.models import fixtures  # noqa: E402
from levelsetfortran_jax.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)

configure_compile_cache()
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")

#: SDF-only parity of the icosphere body (the cube40-class fixture) at
#: dx=0.2 (22^3 grid) with the culled init: the dense scan over 20,480
#: triangles takes minutes on a CPU, and no grid point lies on the surface
ICOSPHERE_SDF = dict(dx=0.2, minmax_iters=0, advect_iters=0,
                     final_reinit_iters=0, init_culling="auto")

# quirk -> reference citation (for the impact table)
QUIRKS = {
    "weno_y_p5_zero": "subs.f90:576 (y-WENO eps scaling, p5 = 0)",
    "deriv8_y_jp1": "subs.f90:346 (order-8 y-stencil jp1 for jp2)",
    "deriv1_plus_sign": "subs.f90:227,233,239 (order-1 upwind + for -)",
}


def run_parity(stl, cfg):
    from levelsetfortran_jax.pipeline.run import run
    return run(stl, cfg, write_outputs=False)


def field_stats(phi):
    return dict(shape=list(phi.shape),
                min=float(phi.min()), max=float(phi.max()),
                mean=float(phi.mean()),
                sha256_f32=hashlib.sha256(
                    np.ascontiguousarray(phi.astype(np.float32))
                    .tobytes()).hexdigest())


def make_golden(name, stl, cfg, quirk_deltas=False):
    import dataclasses
    print(f"== {name}: running parity config ==", flush=True)
    res = run_parity(stl, cfg)
    out = {
        "phi_init": res.phi_init.astype(np.float32),
        "phi_smoothed": res.phi_smoothed.astype(np.float32),
        "advected": res.advected.astype(np.float64),
        "asymptotic_error": np.float64(res.asymptotic_error),
        "reinit_iters": np.int64(res.reinit_iters),
        "minmax_iters": np.int64(res.minmax_iters),
    }
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"parity_{name}.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    print("  init:", field_stats(res.phi_init))
    print("  smoothed:", field_stats(res.phi_smoothed))
    print(f"  reinit_iters={res.reinit_iters} minmax_iters={res.minmax_iters}"
          f" asym={res.asymptotic_error:.6e}")

    rows = []
    if quirk_deltas:
        for q, cite in QUIRKS.items():
            q_off = dataclasses.replace(cfg.quirks, **{q: False})
            res_off = run_parity(stl, cfg.replace(quirks=q_off))
            d_init = float(np.max(np.abs(res_off.phi_init - res.phi_init)))
            d_sm = float(np.max(np.abs(res_off.phi_smoothed
                                       - res.phi_smoothed)))
            d_adv = float(np.max(np.abs(res_off.advected - res.advected)))
            rows.append((q, cite, d_init, d_sm, d_adv))
            print(f"  quirk {q} off: d_init={d_init:.3e} "
                  f"d_smoothed={d_sm:.3e} d_advected={d_adv:.3e}")
    return rows


def save_rows(fixture, rows):
    """Persist one fixture's quirk rows so partial runs (e.g. only the slow
    cube40 pass) regenerate the combined table without losing the other
    fixture's measurements."""
    import json
    path = os.path.join(GOLDEN_DIR, f"quirk_rows_{fixture}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")


def load_rows(fixture):
    import json
    path = os.path.join(GOLDEN_DIR, f"quirk_rows_{fixture}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_quirk_md():
    md = os.path.join(os.path.dirname(__file__), "..", "PARITY_QUIRKS.md")
    with open(md, "w") as f:
        f.write("# Per-quirk impact on the converged parity field\n\n")
        f.write("Measured on the reference's fixtures (`README.md:5`) at full "
                "reference settings (REFERENCE_PARITY: float64, all quirks "
                "on, full pipeline incl. smoothing + advection), toggling "
                "each quirk OFF individually; values are max|delta| of the "
                "converged fields vs the all-quirks-on run "
                "(tools/make_parity_golden.py).\n")
        for fixture, stl in (("twocube10", "twoCube10.stl"),
                             ("cube40", "cube40.stl")):
            rows = load_rows(fixture)
            if rows is None:
                continue
            f.write(f"\n## `{stl}`\n\n")
            f.write("| quirk | reference site | max d(init SDF) | "
                    "max d(smoothed) | max d(advected nodes) | verdict |\n")
            f.write("|---|---|---|---|---|---|\n")
            for q, cite, d_init, d_sm, d_adv in rows:
                moved = max(d_init, d_sm, d_adv)
                verdict = ("measurably moves the converged field — keep "
                           "the flag for parity runs" if moved > 1e-5 else
                           "below the 1e-5 convergence tolerance — parity "
                           "flag optional")
                f.write(f"| `{q}` | {cite} | {d_init:.3e} | {d_sm:.3e} | "
                        f"{d_adv:.3e} | {verdict} |\n")
        f.write("\nDecision: the default configuration implements the "
                "*intended* math (all quirk flags False); the "
                "`REFERENCE_PARITY` preset keeps all flags True so the "
                "pinned goldens reproduce the reference-as-written "
                "behavior (SURVEY.md §2 quirks 1-3).\n")
    print(f"wrote {md}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--icosphere", action="store_true",
                    help="also produce the icosphere SDF-only golden")
    ap.add_argument("--skip-twocube", action="store_true",
                    help="skip the twocube10 golden + quirk pass")
    args = ap.parse_args()

    from levelsetfortran_jax.config import REFERENCE_PARITY

    out = tempfile.mkdtemp()
    if not args.skip_twocube:
        rows = make_golden("twocube10", fixtures.write_twocube10(out),
                           REFERENCE_PARITY, quirk_deltas=True)
        save_rows("twocube10", rows)

    if args.icosphere:
        make_golden("icosphere5_sdf", fixtures.write_icosphere(out, seed=0),
                    REFERENCE_PARITY.replace(**ICOSPHERE_SDF))

    write_quirk_md()


if __name__ == "__main__":
    main()

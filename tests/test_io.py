"""IO round-trip and reference-format tests (STL, VTI, S3D)."""

import numpy as np
import pytest

from levelsetfortran_jax.grid.grid import Grid3D
from levelsetfortran_jax.io.s3d import read_s3d, write_s3d
from levelsetfortran_jax.io.stl import read_stl, write_stl
from levelsetfortran_jax.io.vti import read_vti, write_vti
from levelsetfortran_jax.models import fixtures
from levelsetfortran_jax.models.analytic import box_mesh, two_cubes_mesh


class TestStl:
    def test_read_reference_twocube(self, twocube10_stl):
        mesh = read_stl(twocube10_stl)
        # 24 triangles = 2 cubes x 6 faces x 2 tris (SURVEY.md scale-check)
        assert mesh.n_elems == 24
        # 2 cubes x 8 corners after dedup
        assert mesh.n_nodes == 16
        lo, hi = mesh.bbox()
        np.testing.assert_allclose(lo, [0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(hi, [12, 1, 1], atol=1e-6)

    def test_read_reference_cube40(self, icosphere_stl):
        """The cube40-class body (the reference's cube40.stl is not
        bundled): the seeded 20,480-triangle icosphere, exact counts."""
        mesh = read_stl(icosphere_stl)
        assert mesh.n_elems == fixtures.ICOSPHERE_TRIANGLES == 20480
        assert mesh.n_nodes == fixtures.ICOSPHERE_NODES == 10242
        r = np.linalg.norm(mesh.vertices, axis=1)
        np.testing.assert_allclose(r, 1.0, atol=1e-6)
        # every element references valid deduped nodes
        assert mesh.elements.min() == 0
        assert mesh.elements.max() == mesh.n_nodes - 1

    def test_dedup_preserves_triangles(self, twocube10_stl):
        mesh = read_stl(twocube10_stl)
        # Re-expanding through the element table must reproduce exact coords
        tri = mesh.vertices[mesh.elements]
        assert tri.shape == (24, 3, 3)
        # all triangles non-degenerate
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        areas = np.linalg.norm(np.cross(e1, e2), axis=1)
        assert np.all(areas > 1e-8)

    def test_write_read_roundtrip(self, tmp_path):
        mesh = two_cubes_mesh()
        p = str(tmp_path / "two.stl")
        write_stl(p, mesh)
        again = read_stl(p)
        assert again.n_elems == mesh.n_elems
        np.testing.assert_allclose(
            np.sort(again.vertices, axis=0), np.sort(mesh.vertices, axis=0),
            atol=1e-6)

    def test_ascii_stl(self, tmp_path):
        p = tmp_path / "tri.stl"
        p.write_text(
            "solid t\n facet normal 0 0 1\n  outer loop\n"
            "   vertex 0 0 0\n   vertex 1 0 0\n   vertex 0 1 0\n"
            "  endloop\n endfacet\nendsolid t\n")
        mesh = read_stl(str(p))
        assert mesh.n_elems == 1 and mesh.n_nodes == 3


class TestVti:
    def test_roundtrip(self, tmp_path):
        grid = Grid3D(shape=(7, 5, 6), origin=(-1.0, 0.0, 2.0), dx=0.1)
        rng = np.random.default_rng(0)
        phi = rng.normal(size=grid.shape)
        p = str(tmp_path / "f.vti")
        write_vti(p, phi, grid)
        back, g2 = read_vti(p)
        np.testing.assert_allclose(back, phi)
        assert g2.shape == grid.shape
        np.testing.assert_allclose(g2.origin, grid.origin, atol=1e-7)
        assert abs(g2.dx - grid.dx) < 1e-9

    def test_ref_compat_quirk_byte_count(self, tmp_path):
        """ref_compat reproduces the (nx+1)**3*24 count (set3d.f90:330);
        the reader must still parse it correctly."""
        grid = Grid3D(shape=(4, 4, 4), origin=(0, 0, 0), dx=1.0)
        phi = np.arange(64, dtype=np.float64).reshape(4, 4, 4)
        p = str(tmp_path / "q.vti")
        write_vti(p, phi, grid, ref_compat=True)
        back, _ = read_vti(p)
        np.testing.assert_allclose(back, phi)
        raw = open(p, "rb").read()
        idx = raw.index(b"_", raw.index(b"AppendedData")) + 1
        declared = int.from_bytes(raw[idx:idx + 4], "little", signed=True)
        assert declared == 4 ** 3 * 24   # the quirk value

    def test_payload_is_x_fastest(self, tmp_path):
        grid = Grid3D(shape=(3, 2, 2), origin=(0, 0, 0), dx=1.0)
        phi = np.arange(12, dtype=np.float64).reshape(3, 2, 2)
        p = str(tmp_path / "x.vti")
        write_vti(p, phi, grid)
        raw = open(p, "rb").read()
        idx = raw.index(b"_", raw.index(b"AppendedData")) + 5
        payload = np.frombuffer(raw, "<f8", count=12, offset=idx)
        # x-fastest: first 3 entries are phi[:,0,0]
        np.testing.assert_allclose(payload[:3], phi[:, 0, 0])


class TestS3d:
    def test_roundtrip(self, tmp_path):
        mesh = box_mesh()
        p = str(tmp_path / "m.s3d")
        coords = mesh.vertices + 0.125
        write_s3d(p, mesh, coords)
        back = read_s3d(p)
        assert back.n_elems == mesh.n_elems
        assert back.n_nodes == mesh.n_nodes
        np.testing.assert_array_equal(back.elements, mesh.elements)
        np.testing.assert_allclose(back.vertices, coords)

    def test_header_counts(self, tmp_path):
        mesh = box_mesh()
        p = str(tmp_path / "m.s3d")
        write_s3d(p, mesh)
        header = open(p).readline().split()
        assert [int(v) for v in header] == [
            mesh.n_elems, mesh.n_nodes, 0, 1]


def test_pipeline_accepts_s3d_input(tmp_path, twocube10_stl):
    """The reference's s3dRead is a stub that STOPs (subs.f90:127-147);
    here .s3d round-trips back into the pipeline as a real input."""
    import jax.numpy as jnp

    from levelsetfortran_jax.config import LevelSetConfig
    from levelsetfortran_jax.io.s3d import read_s3d, write_s3d
    from levelsetfortran_jax.io.stl import read_stl
    from levelsetfortran_jax.pipeline.run import run

    mesh = read_stl(twocube10_stl)
    path = str(tmp_path / "roundtrip.s3d")
    write_s3d(path, mesh, mesh.vertices)
    mesh2 = read_s3d(path)
    assert mesh2.n_nodes == mesh.n_nodes
    cfg = LevelSetConfig(dx=0.2, pad_cells=4, reinit_iters=5,
                         minmax_iters=0, advect_iters=1,
                         final_reinit_iters=0, dtype=jnp.float32)
    res = run(path, cfg, write_outputs=False)
    assert res.phi_init.shape == res.grid.shape


def test_init_distributed_single_process():
    from levelsetfortran_jax.parallel.distributed import (init_distributed,
                                                          is_primary)
    assert init_distributed() is False      # no coordinator: single-process
    assert is_primary()


def test_init_distributed_needs_all_three_arguments():
    from levelsetfortran_jax.parallel.distributed import init_distributed
    with pytest.raises(ValueError, match="together"):
        init_distributed("localhost:1234", num_processes=2)


def test_init_distributed_raises_when_join_fails(monkeypatch):
    """A failure to join the process group propagates: a run meant for
    several processes never continues on one."""
    import jax

    from levelsetfortran_jax.parallel import distributed

    def fail(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fail)
    monkeypatch.setattr(distributed, "_initialized", False)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.init_distributed("localhost:1234", 2, 0)
    assert distributed._initialized is False


def test_generated_twocube10_matches_reference_geometry():
    """The generated twoCube10 is the reference fixture's documented
    geometry: two unit cubes 10 apart along x (SURVEY.md scale check)."""
    mesh = fixtures.twocube10_mesh()
    assert mesh.n_elems == fixtures.TWOCUBE10_TRIANGLES
    assert mesh.n_nodes == fixtures.TWOCUBE10_NODES
    corners = {tuple(v) for v in mesh.vertices}
    for x0 in (0.0, 11.0):
        for dx in (0.0, 1.0):
            for y in (0.0, 1.0):
                for z in (0.0, 1.0):
                    assert (x0 + dx, y, z) in corners


def test_icosphere_rotation_is_seeded():
    a = fixtures.icosphere_body(seed=3, subdiv=1)
    b = fixtures.icosphere_body(seed=3, subdiv=1)
    c = fixtures.icosphere_body(seed=4, subdiv=1)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    assert not np.allclose(a.vertices, c.vertices)
    q = fixtures.random_rotation(3)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(q) > 0


def test_procedural_meshes_match_analytic_sdf():
    """Procedural generators: pipeline SDF vs analytic distance."""
    import jax.numpy as jnp

    from levelsetfortran_jax.config import LevelSetConfig
    from levelsetfortran_jax.models.analytic import sdf_box, sdf_sphere
    from levelsetfortran_jax.models.analytic import box_mesh, icosphere_mesh
    from levelsetfortran_jax.pipeline.run import run_mesh

    # reinit_iters=0: validate the generators + exact-distance init alone
    # (reinit's WENO steady state deviates O(dx) from exact distance at the
    # box's gradient kinks — a discretization property, tested elsewhere)
    cfg = LevelSetConfig(dx=0.1, pad_cells=4, reinit_iters=0,
                         minmax_iters=0, advect_iters=1,
                         final_reinit_iters=0, dtype=jnp.float32)

    # tolerances: box is exact; icosphere is a polyhedral approximation
    # (chord sagitta at subdivision 3 ~ 2e-3)
    for mesh, sdf, tol in [
        (box_mesh(half_extent=(0.5, 0.5, 0.5), subdivisions=2),
         lambda p: sdf_box(p, (0.0, 0.0, 0.0), (0.5, 0.5, 0.5)), 1e-5),
        (icosphere_mesh(radius=0.6, subdivisions=3),
         lambda p: sdf_sphere(p, (0.0, 0.0, 0.0), 0.6), 5e-3),
    ]:
        res = run_mesh(mesh, cfg)
        grid = res.grid
        import numpy as _np
        xs = [grid.origin[a] + grid.dx * _np.arange(grid.shape[a])
              for a in range(3)]
        gx, gy, gz = _np.meshgrid(*xs, indexing="ij")
        pts = jnp.asarray(_np.stack([gx, gy, gz], -1).reshape(-1, 3),
                          jnp.float32)
        truth = _np.asarray(sdf(pts)).reshape(grid.shape)
        err = _np.abs(res.phi_init - truth)
        assert err.max() < tol, err.max()
        assert (_np.sign(res.phi_init) == _np.sign(truth))[
            _np.abs(truth) > 1e-3].all()


def test_cli_exposes_every_reference_literal():
    """Every hardcoded reference literal (SURVEY.md §2 quirk 9) has a CLI
    flag, including tolerances, band radii, threshold, init mode, advection
    gradient order, and the parity quirk flags."""
    from levelsetfortran_jax.pipeline.cli import build_parser, config_from_args

    p = build_parser()
    args = p.parse_args([
        "mesh.stl", "--dx", "0.1", "--pad-cells", "4",
        "--init-mode", "reference", "--reinit-iters", "7",
        "--reinit-cfl", "0.2", "--reinit-tol", "1e-4",
        "--minmax-iters", "9", "--minmax-cfl", "0.02",
        "--minmax-tol", "1e-6", "--minmax-threshold", "0.5",
        "--band-radius", "3.1", "--stencil-band-radius", "6.1",
        "--advect-iters", "11", "--advect-grad-order", "2",
        "--final-reinit-iters", "13", "--quirks", "weno_y_p5_zero",
    ])
    cfg = config_from_args(args)
    assert cfg.dx == 0.1 and cfg.pad_cells == 4
    assert cfg.init_mode == "reference"
    assert cfg.reinit_iters == 7 and cfg.reinit_cfl == 0.2
    assert cfg.reinit_tol == 1e-4
    assert cfg.minmax_iters == 9 and cfg.minmax_cfl == 0.02
    assert cfg.minmax_tol == 1e-6 and cfg.minmax_threshold == 0.5
    assert cfg.band_radius == 3.1 and cfg.stencil_band_radius == 6.1
    assert cfg.advect_iters == 11 and cfg.advect_grad_order == 2
    assert cfg.final_reinit_iters == 13
    assert cfg.quirks.weno_y_p5_zero and not cfg.quirks.deriv8_y_jp1

    args_all = p.parse_args(["m.stl", "--quirks", "all"])
    q = config_from_args(args_all).quirks
    assert q.weno_y_p5_zero and q.deriv8_y_jp1 and q.deriv1_plus_sign


def test_cli_config_field_parity():
    """Machine-checked CLI <-> config parity: every LevelSetConfig dataclass
    field either has the same-named flag (with a matching default) or is on
    the documented exemption list — so "every literal a flag" cannot
    drift."""
    import dataclasses
    from levelsetfortran_jax.config import LevelSetConfig
    from levelsetfortran_jax.pipeline.cli import build_parser

    # Fields with no one-to-one simple flag, each with its reason:
    exempt = {
        "dtype": "exposed as --dtype with string choices",
        "quirks": "exposed as --quirks comma-list",
        "mesh_shape": "exposed as --mesh-shape comma-string",
        "mesh_axis_names": "internal mesh axis labels, not a knob",
        "halo_width": "structural constant (max stencil radius 4), "
                      "derived from the operator set, not tunable",
        "sign_eps": "mirrors a DEAD reference literal (subs.f90:156 "
                    "declares eps and never reads it)",
    }
    p = build_parser()
    # argparse stores per-action dest/default; map dest -> default
    actions = {a.dest: a for a in p._actions}
    d = LevelSetConfig()
    missing, bad_default = [], []
    for f in dataclasses.fields(LevelSetConfig):
        if f.name in exempt:
            # exempt-but-flagged would mean the exemption list is stale
            if f.name in ("dtype", "quirks", "mesh_shape"):
                assert f.name in actions, f"--{f.name} flag disappeared"
            continue
        if f.name not in actions:
            missing.append(f.name)
            continue
        if actions[f.name].default != getattr(d, f.name):
            bad_default.append(
                (f.name, actions[f.name].default, getattr(d, f.name)))
    assert not missing, f"config fields without CLI flags: {missing}"
    assert not bad_default, f"flag defaults diverge from config: {bad_default}"

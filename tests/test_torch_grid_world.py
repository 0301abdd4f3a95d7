"""The port's voxel worlds against the JAX package: GridSDF (packed corner
table, trilinear sample), CompositeWorld, the EDT builders and the
occupancy-to-boxes decomposition, with both sides fed the same numpy
values.

Tolerances: grids, occupancies and box lists are equal (max |Δ| 0 over the
cases below, float32 grids built in float64 on both sides); trilinear
samples atol 1e-6 (same float32 arithmetic in the same order; measured
max |Δ| 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpustomp.world import decompose as jdec
from tpustomp.world import edt as jedt
from tpustomp.world import sdf as jsdf
from tpustomp_torch import convert
from tpustomp_torch.world import decompose as tdec
from tpustomp_torch.world import edt as tedt
from tpustomp_torch.world import native_edt
from tpustomp_torch.world import sdf as tsdf

_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),       # table
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]  # bottle
_SPHERE = [((0.35, 0.3, 0.55), 0.12)]
_ORIGIN, _SHAPE, _RES = (-0.2, -1.0, 0.0), (32, 40, 24), 0.05


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _occ():
    world = jsdf.AnalyticWorld.make(boxes=_BOXES)
    return jedt.occupancy_from_analytic(world, _ORIGIN, _SHAPE, _RES)


def _grids(pack=True):
    """(JAX GridSDF, port GridSDF) of the signed EDT of the tabletop."""
    jg = jedt.signed_edt(_occ(), _RES, _ORIGIN)
    if not pack:
        jg = jg.replace(packed=None)
    return jg, convert.grid_from_numpy(_fields(jg))


def _points(seed=0):
    """Points inside the grid, outside it on every side, on voxel faces
    and corners, and exactly at the grid's far corner."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(_ORIGIN)
    hi = lo + _RES * (np.asarray(_SHAPE) - 1)
    inside = rng.uniform(lo, hi, (40, 3))
    outside = rng.uniform(lo - 0.4, hi + 0.4, (40, 3))
    lattice = lo + _RES * rng.integers(0, _SHAPE, (20, 3))
    faces = lattice.copy()
    faces[:, 0] += 0.5 * _RES * rng.integers(0, 2, 20)
    return np.concatenate([inside, outside, lattice, faces, [hi], [lo]]
                          ).astype(np.float32)


@pytest.mark.parametrize("pack", [True, False])
def test_grid_make_matches_jax(pack):
    """GridSDF.make: grid, origin, resolution and the [X·Y·Z, 8] packed
    corner table equal the JAX package's."""
    g = np.random.default_rng(1).normal(size=(5, 6, 4)).astype(np.float32)
    ref = jsdf.GridSDF.make(g, (0.1, -0.2, 0.3), 0.04, pack=pack)
    got = tsdf.GridSDF.make(g, (0.1, -0.2, 0.3), 0.04, pack=pack)
    for name in ("grid", "origin", "resolution"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert b.dtype == np.float32 and b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    if pack:
        assert got.packed.shape == (5 * 6 * 4, 8)
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(ref.packed))
    else:
        assert got.packed is None and ref.packed is None


@pytest.mark.parametrize("kind", ["grid", "grid_unpacked", "composite"])
def test_sdf_matches_jax(kind):
    jg, tg = _grids(pack=kind != "grid_unpacked")
    if kind == "composite":
        jw = jsdf.CompositeWorld.make(jg, spheres=_SPHERE, boxes=_BOXES[1:])
        tw = convert.composite_from_numpy(_fields(jw.grid),
                                          _fields(jw.overlay))
    else:
        jw, tw = jg, tg
    p = _points()
    want = np.asarray(jsdf.sdf(jw, jnp.asarray(p)))
    got = tsdf.sdf(tw, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # leading batch axes
    got2 = tsdf.sdf(tw, torch.from_numpy(p[:120].reshape(4, 30, 3)))
    np.testing.assert_array_equal(got2.numpy().reshape(-1), got[:120])


def test_grid_clip_hi_is_float32_like_jax():
    for shape in ((64, 80, 48), (2, 3, 1000), (5, 6, 4)):
        want = np.asarray(jnp.asarray(shape, jnp.float32) - 1.000001)
        np.testing.assert_array_equal(tsdf.grid_clip_hi(shape), want)


def test_occupancy_and_grid_from_analytic_match_jax():
    jw = jsdf.AnalyticWorld.make(spheres=_SPHERE, boxes=_BOXES)
    tw = tsdf.AnalyticWorld.make(spheres=_SPHERE, boxes=_BOXES)
    occ = tedt.occupancy_from_analytic(tw, _ORIGIN, _SHAPE, _RES)
    np.testing.assert_array_equal(
        occ, jedt.occupancy_from_analytic(jw, _ORIGIN, _SHAPE, _RES))
    assert 0 < occ.sum() < occ.size
    ref = jedt.grid_from_analytic(jw, _ORIGIN, _SHAPE, _RES)
    got = tedt.grid_from_analytic(tw, _ORIGIN, _SHAPE, _RES)
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(ref.grid))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))


def test_voxelize_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 1.8, (500, 3))
    np.testing.assert_array_equal(
        tedt.voxelize(pts, _ORIGIN, _SHAPE, _RES),
        jedt.voxelize(pts, _ORIGIN, _SHAPE, _RES))


@pytest.mark.parametrize("route", ["native", "scipy"])
def test_signed_edt_matches_jax(route, monkeypatch):
    """Both of the port's exact routes give the JAX package's grid."""
    if route == "native":
        assert native_edt.available(), "g++ should build native/edt.cpp"
    else:
        monkeypatch.setattr(tedt.native_edt, "available", lambda: False)
    occ = _occ()
    ref = jedt.signed_edt(occ, _RES, _ORIGIN)
    got = tedt.signed_edt(occ, _RES, _ORIGIN)
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(ref.grid))
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(ref.origin))
    # no seed on one side: ±1e6, as the reference
    full = tedt.signed_edt(np.ones((3, 4, 5), bool), 0.1, (0, 0, 0))
    assert bool((full.grid == -1e6).all())


def test_edt_routes_agree():
    """native == scipy == brute force (exact EDT; squared distances are
    integers, so the routes agree to the last bit after the sqrt)."""
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(3)
    seed = rng.random((9, 11, 7)) < 0.05
    native = np.sqrt(native_edt.edt_sq(seed))
    np.testing.assert_array_equal(native, distance_transform_edt(~seed))
    np.testing.assert_allclose(native, tedt._edt_brute(seed), rtol=0,
                               atol=1e-12)
    assert np.isinf(tedt.edt_voxels(np.zeros((3, 3, 3), bool))).all()


def test_analytic_from_occupancy_matches_jax():
    occ = _occ()
    assert tdec.boxes_from_occupancy(occ) == jdec.boxes_from_occupancy(occ)
    for inflate in (0.0, _RES / 2):
        ref = jdec.analytic_from_occupancy(occ, _RES, _ORIGIN, inflate)
        got = tdec.analytic_from_occupancy(occ, _RES, _ORIGIN, inflate)
        assert got.box_half.shape == (2, 3)      # the tabletop: 2 boxes
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)))
    with pytest.raises(ValueError, match="max_boxes"):
        tdec.analytic_from_occupancy(occ, _RES, _ORIGIN, max_boxes=1)


def test_worlds_move_with_fields():
    jg, tg = _grids()
    comp = tsdf.CompositeWorld.make(tg, spheres=_SPHERE)
    moved = comp.to("cpu")
    assert isinstance(moved.grid, tsdf.GridSDF)
    torch.testing.assert_close(moved.grid.packed, tg.packed, rtol=0, atol=0)
    assert tsdf.GridSDF.make(np.zeros((2, 2, 2)), (0, 0, 0), 0.1,
                             pack=False).to("cpu").packed is None


def test_per_candidate_overlay_raises():
    """A CompositeWorld whose overlay has a row axis (one set of spheres
    per scenario; the grid shared): sdf over points [R, ..., 3] equals the
    JAX package's vmap(sdf) over the overlay rows (_grid_finish :821-829),
    and points without the matching row axis raise."""
    jg, tg = _grids()
    rng = np.random.default_rng(4)
    R = 4
    centers = rng.uniform(-0.2, 0.8, (R, 2, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.2, (R, 2)).astype(np.float32)
    box_c = rng.uniform(0.0, 0.6, (R, 1, 3)).astype(np.float32)
    box_h = rng.uniform(0.05, 0.2, (R, 1, 3)).astype(np.float32)
    pts = np.stack([_points(s) for s in range(R)])
    jover = jsdf.AnalyticWorld(
        sphere_center=jnp.asarray(centers), sphere_radius=jnp.asarray(radii),
        box_center=jnp.asarray(box_c), box_half=jnp.asarray(box_h))
    ref = jsdf.sdf(jg, jnp.asarray(pts))
    ref = jnp.minimum(ref, jax.vmap(jsdf.sdf)(jover, jnp.asarray(pts)))
    over = tsdf.AnalyticWorld(
        sphere_center=torch.from_numpy(centers),
        sphere_radius=torch.from_numpy(radii),
        box_center=torch.from_numpy(box_c), box_half=torch.from_numpy(box_h))
    world = tsdf.CompositeWorld(grid=tg, overlay=over)
    assert tsdf.world_rows(world) == R
    got = tsdf.sdf(world, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="4 rows"):
        tsdf.sdf(world, torch.zeros(3, 3))

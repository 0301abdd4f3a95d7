"""Grid SDF builders (port of ``tpustomp/world/edt.py``): analytic primitives
→ grid, occupancy → signed EDT. Offline host work in numpy; the device only
ever sees the finished [X, Y, Z] float32 grid (world/sdf.GridSDF).

  - `grid_from_analytic`: exact SDF of a sphere/box union at voxel centers.
  - `signed_edt`: exact signed Euclidean distance transform of a boolean
    occupancy grid. Routes, in order: the native C++ kernel
    (native/edt.cpp through world/native_edt.py), scipy, brute force. Every
    route is exact.
  - `occupancy_from_analytic`, `voxelize`: rasterize primitives or a point
    cloud into occupancy.

``IncrementalSDF`` is not ported yet.
"""

from __future__ import annotations

import numpy as np

from tpustomp_torch.world import native_edt
from tpustomp_torch.world.sdf import AnalyticWorld, GridSDF


def _voxel_centers(origin, shape, resolution):
    ax = [origin[i] + resolution * np.arange(shape[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1)  # [X,Y,Z,3]


def _analytic_sdf_np(world: AnalyticWorld, pts: np.ndarray) -> np.ndarray:
    """float64 numpy twin of world/sdf._analytic_sdf for grid building."""
    d = np.full(pts.shape[:-1], 1e6, np.float64)
    sc = world.sphere_center.cpu().numpy()
    sr = world.sphere_radius.cpu().numpy()
    if sr.shape[0]:
        rel = pts[..., None, :] - sc
        ds = np.linalg.norm(rel, axis=-1) - sr
        d = np.minimum(d, ds.min(axis=-1))
    bc = world.box_center.cpu().numpy()
    bh = world.box_half.cpu().numpy()
    if bh.shape[0]:
        q = np.abs(pts[..., None, :] - bc) - bh
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(q.max(axis=-1), 0.0)
        d = np.minimum(d, (outside + inside).min(axis=-1))
    return d


def grid_from_analytic(world: AnalyticWorld, origin, shape,
                       resolution: float) -> GridSDF:
    """Exact SDF grid of a primitive world (voxel centers sampled)."""
    pts = _voxel_centers(np.asarray(origin, np.float64), shape, resolution)
    grid = _analytic_sdf_np(world, pts).astype(np.float32)
    return GridSDF.make(grid, origin, resolution)


def occupancy_from_analytic(world: AnalyticWorld, origin, shape,
                            resolution: float) -> np.ndarray:
    """Boolean occupancy grid: voxel center inside any primitive."""
    pts = _voxel_centers(np.asarray(origin, np.float64), shape, resolution)
    return _analytic_sdf_np(world, pts) <= 0.0


def voxelize(points: np.ndarray, origin, shape,
             resolution: float) -> np.ndarray:
    """Rasterize a point cloud [P, 3] into occupancy."""
    occ = np.zeros(shape, bool)
    idx = np.floor((points - np.asarray(origin)) / resolution
                   + 0.5).astype(int)
    ok = np.all((idx >= 0) & (idx < np.asarray(shape)), axis=1)
    idx = idx[ok]
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return occ


def _edt_brute(seed: np.ndarray) -> np.ndarray:
    """Brute-force exact EDT (tiny grids only; last route)."""
    pts = np.argwhere(seed)
    idx = np.indices(seed.shape).reshape(3, -1).T
    d = np.sqrt(((idx[:, None, :] - pts[None, :, :]) ** 2).sum(-1)).min(1)
    return d.reshape(seed.shape)


def edt_voxels(seed: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (in voxel units) to the nearest seed voxel:
    the native kernel when it builds, else scipy, else brute force."""
    if not seed.any():
        return np.full(seed.shape, np.inf)
    if native_edt.available():
        return np.sqrt(native_edt.edt_sq(seed))
    try:
        from scipy.ndimage import distance_transform_edt
    except ImportError:  # pragma: no cover
        return _edt_brute(seed)
    return distance_transform_edt(~seed)


def signed_edt(occ: np.ndarray, resolution: float, origin) -> GridSDF:
    """Signed EDT grid: positive outside (distance to the nearest occupied
    voxel), negative inside (minus the distance to the nearest free voxel);
    a grid with no seed on one side holds ±1e6 there."""
    occ = np.asarray(occ, bool)
    d_out = edt_voxels(occ)
    d_in = edt_voxels(~occ)
    signed = np.where(occ, -d_in, d_out) * resolution
    signed = np.where(np.isfinite(signed), signed,
                      np.sign(signed) * 1e6).astype(np.float32)
    return GridSDF.make(signed, origin, resolution)

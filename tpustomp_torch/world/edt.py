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
  - `IncrementalSDF`: a clamped signed EDT that structural edits patch in
    place of a rebuild (bounded re-propagation, host numpy), with only the
    changed region copied to the device.

A field's build is a span, `world.sdf` (utils/tracing.py; attributes
`voxels`, `occupied`, `packed`), over its two EDT passes (`world.edt`) and
the corner table (`world.pack`, in GridSDF.make).
"""

from __future__ import annotations

import numpy as np
import torch

from tpustomp_torch.utils import tracing
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
    a grid with no seed on one side holds ±1e6 there. With the packed
    corner table (GridSDF.make)."""
    occ = np.asarray(occ, bool)
    with tracing.span("world.sdf") as s:
        if s is not tracing.OFF:        # a count costs a pass over occ
            s.set(voxels=int(occ.size), occupied=int(np.count_nonzero(occ)),
                  packed=True)
        with tracing.span("world.edt"):
            d_out = edt_voxels(occ)
            d_in = edt_voxels(~occ)
        signed = np.where(occ, -d_in, d_out) * resolution
        signed = np.where(np.isfinite(signed), signed,
                          np.sign(signed) * 1e6).astype(np.float32)
        return GridSDF.make(signed, origin, resolution)


class IncrementalSDF:
    """Dynamically updatable voxel SDF with bounded re-propagation (the
    JAX package's ``IncrementalSDF``, tpustomp/world/edt.py:122-245; the
    reference's ``distance_field::PropagationDistanceField``).

    The stored field is the signed EDT clamped to ±max_distance, so a change
    at cell c can only move values within max_distance of c. An update
    recomputes the changed AABB dilated by max_distance (seeded from a
    second dilation) with the exact EDT on the host (`edt_voxels`) and
    copies only that slice of the grid, and the packed corner-table rows
    whose corners it touches, to the device: host work and host-to-device
    traffic are O(changed region), not O(grid).

    Value semantics, as the JAX package's ``.at[].set``: an update clones
    the device grid and table and writes the patch into the clones, so a
    world returned earlier by `as_world()` never changes (a solve running
    on another stream, or an MPC loop holding a composite, never reads a
    half-written field). The copy is device to device.

    For per-control-tick dynamics use world/sdf.CompositeWorld (moving
    spheres over a static grid, no EDT); this class is for structural
    edits to the static scene between planning calls.
    """

    def __init__(self, occ: np.ndarray, origin, resolution: float,
                 max_distance: float = 0.5, device="cuda"):
        from tpustomp_torch.api.plan import _resolve_device

        occ = np.asarray(occ, bool)
        self.origin = np.asarray(origin, np.float64)
        self.resolution = float(resolution)
        self.max_distance = float(max_distance)
        self.max_vox = max(1, int(np.ceil(max_distance / resolution)))
        self.occ = occ.copy()
        self.device = _resolve_device(device)
        self._grid_np = self._signed_clamped(occ)
        # a copy: on the CPU the world's grid would alias the host mirror
        # that every update writes into
        self._sdf = GridSDF.make(self._grid_np.copy(), origin,
                                 resolution).to(self.device)

    def _signed_clamped(self, occ: np.ndarray) -> np.ndarray:
        d_out = np.minimum(edt_voxels(occ), self.max_vox + 1.0)
        d_in = np.minimum(edt_voxels(~occ), self.max_vox + 1.0)
        signed = np.where(occ, -d_in, d_out) * self.resolution
        return np.clip(signed, -self.max_distance,
                       self.max_distance).astype(np.float32)

    def as_world(self) -> GridSDF:
        """The current field as a GridSDF on the device (query-ready)."""
        return self._sdf

    def set_cells(self, indices: np.ndarray, occupied: bool) -> None:
        """Mark voxel cells [M, 3] occupied/free and re-propagate locally."""
        idx = np.atleast_2d(np.asarray(indices, np.int64))
        cur = self.occ[idx[:, 0], idx[:, 1], idx[:, 2]]
        changed = idx[cur != occupied]
        if changed.shape[0] == 0:
            return
        self.occ[changed[:, 0], changed[:, 1], changed[:, 2]] = occupied
        self._repropagate(changed.min(axis=0), changed.max(axis=0) + 1)

    def set_box(self, lo_idx, hi_idx, occupied: bool) -> None:
        """Set the half-open voxel box [lo, hi) occupied/free (e.g. a new
        cuboid obstacle)."""
        lo = np.maximum(np.asarray(lo_idx, np.int64), 0)
        hi = np.minimum(np.asarray(hi_idx, np.int64), self.occ.shape)
        if np.any(hi <= lo):
            return
        region = self.occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        if np.all(region == occupied):
            return
        region[...] = occupied
        self._repropagate(lo, hi)

    def add_points(self, points: np.ndarray) -> None:
        """Voxelize world-frame points [P, 3] as new obstacles (a sensor
        frame's collision-map points, incremental form)."""
        idx = np.floor((np.asarray(points) - self.origin) / self.resolution
                       + 0.5).astype(np.int64)
        ok = np.all((idx >= 0) & (idx < np.asarray(self.occ.shape)), axis=1)
        if idx[ok].shape[0]:
            self.set_cells(idx[ok], True)

    def _repropagate(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Exact re-propagation of the changed AABB [lo, hi).

        R = AABB ± max_vox is where values can change; its EDT needs seeds
        up to max_vox further out, so the transform runs on S = R ± max_vox
        and only the R slice is written back. Chebyshev dilation ⊇ the
        Euclidean max_distance ball, and clamping makes farther seeds
        irrelevant, so the patch equals a full rebuild exactly."""
        shape = np.asarray(self.occ.shape)
        r_lo = np.maximum(lo - self.max_vox, 0)
        r_hi = np.minimum(hi + self.max_vox, shape)
        s_lo = np.maximum(r_lo - self.max_vox, 0)
        s_hi = np.minimum(r_hi + self.max_vox, shape)
        sub = self.occ[s_lo[0]:s_hi[0], s_lo[1]:s_hi[1], s_lo[2]:s_hi[2]]
        patch_s = self._signed_clamped(sub)
        off = r_lo - s_lo
        ext = r_hi - r_lo
        patch = patch_s[off[0]:off[0] + ext[0], off[1]:off[1] + ext[1],
                        off[2]:off[2] + ext[2]]
        self._grid_np[r_lo[0]:r_hi[0], r_lo[1]:r_hi[1],
                      r_lo[2]:r_hi[2]] = patch
        dev = self.device
        grid = self._sdf.grid.clone()
        grid[r_lo[0]:r_hi[0], r_lo[1]:r_hi[1], r_lo[2]:r_hi[2]] = (
            torch.from_numpy(np.ascontiguousarray(patch)).to(dev))
        packed = self._sdf.packed
        if packed is not None:
            # corner-table rows touched: cells whose 8-corner window
            # intersects R, i.e. R grown by 1 on the low side (and clipped
            # to the sample-cell range [0, dim-2] the gather reads)
            p_lo = np.maximum(r_lo - 1, 0)
            p_hi = np.minimum(r_hi, shape - 1)
            _, Y, Z = self.occ.shape
            g = self._grid_np
            rows = np.stack(
                [g[p_lo[0] + dx:p_hi[0] + dx, p_lo[1] + dy:p_hi[1] + dy,
                   p_lo[2] + dz:p_hi[2] + dz]
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                axis=-1).reshape(-1, 8)
            ix, iy, iz = np.meshgrid(np.arange(p_lo[0], p_hi[0]),
                                     np.arange(p_lo[1], p_hi[1]),
                                     np.arange(p_lo[2], p_hi[2]),
                                     indexing="ij")
            flat = ((ix * Y + iy) * Z + iz).reshape(-1)
            packed = packed.clone().index_copy_(
                0, torch.from_numpy(flat).to(dev),
                torch.from_numpy(rows).to(dev))
        self._sdf = GridSDF(grid=grid, origin=self._sdf.origin,
                            resolution=self._sdf.resolution, packed=packed)

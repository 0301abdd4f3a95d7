"""Signed-distance worlds (port of ``tpustomp/world/sdf.py``, distance part).

- `AnalyticWorld`: a union of spheres and axis-aligned boxes with a
  closed-form, min-composed SDF.
- `GridSDF`: a dense [X, Y, Z] float32 voxel grid, sampled trilinearly
  (world/edt.py builds these).
- `CompositeWorld`: a static grid plus an analytic overlay, min-composed.

`sdf(world, p)` takes any of the three. The gradient (``sdf_grad``) is not
ported yet; it lands with CHOMP.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpustomp_torch._tensors import to_device


def _f32(x, shape=None) -> torch.Tensor:
    a = np.asarray(x, np.float32)
    return torch.as_tensor(a if shape is None else a.reshape(shape))


@dataclass(frozen=True)
class AnalyticWorld:
    """Union of spheres and axis-aligned boxes (min-composed SDF)."""

    sphere_center: torch.Tensor  # [S, 3]
    sphere_radius: torch.Tensor  # [S]
    box_center: torch.Tensor     # [X, 3]
    box_half: torch.Tensor       # [X, 3]

    @staticmethod
    def make(spheres=(), boxes=()) -> "AnalyticWorld":
        """spheres: iterable of (center xyz, radius); boxes: (center,
        half-extents). Returns CPU tensors; move with ``world.to(device)``."""
        spheres, boxes = list(spheres), list(boxes)
        return AnalyticWorld(
            sphere_center=_f32([s[0] for s in spheres], (-1, 3)),
            sphere_radius=_f32([s[1] for s in spheres], (-1,)),
            box_center=_f32([b[0] for b in boxes], (-1, 3)),
            box_half=_f32([b[1] for b in boxes], (-1, 3)))

    def to(self, device) -> "AnalyticWorld":
        return to_device(self, device)


@dataclass(frozen=True)
class GridSDF:
    """Dense voxel signed-distance grid.

    `packed` is an optional [X*Y*Z, 8] corner table: row i holds the 8
    corners G[x+dx, y+dy, z+dz] of flat cell i (dx, dy, dz in 0/1, dz
    fastest), the JAX package's layout. The plain sampler reads one row per
    sample when it is present; the CUDA kernel reads the dense grid.
    """

    grid: torch.Tensor                 # [X, Y, Z] float32 signed distance (m)
    origin: torch.Tensor               # [3] world position of voxel (0,0,0)
    resolution: torch.Tensor           # [] meters per voxel
    packed: torch.Tensor | None = None  # [X*Y*Z, 8] corner table

    @staticmethod
    def make(grid, origin, resolution, pack: bool = True) -> "GridSDF":
        """Build from a [X, Y, Z] array (CPU tensors), with the packed corner
        table unless pack=False."""
        g = np.asarray(grid, np.float32)
        packed = None
        if pack:
            # roll wraps at the far edges, but sample cells are clipped to
            # [0, dim-2], so wrapped rows are never read
            packed = torch.as_tensor(np.stack(
                [np.roll(g, (-dx, -dy, -dz), (0, 1, 2))
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                axis=-1).reshape(-1, 8))
        return GridSDF(grid=torch.as_tensor(g), origin=_f32(origin, (3,)),
                       resolution=_f32(resolution, ()), packed=packed)

    def to(self, device) -> "GridSDF":
        return to_device(self, device)


@dataclass(frozen=True)
class CompositeWorld:
    """A static voxel grid plus an analytic overlay, min-composed (exact for
    unions). The overlay is the part that changes per control tick (MPC);
    its leaves are shared by every candidate. A leading candidate axis on
    the overlay (the JAX package's MPC form) is not ported yet."""

    grid: GridSDF
    overlay: AnalyticWorld

    @staticmethod
    def make(grid: GridSDF, spheres=(), boxes=()) -> "CompositeWorld":
        return CompositeWorld(grid=grid,
                              overlay=AnalyticWorld.make(spheres, boxes))

    def to(self, device) -> "CompositeWorld":
        return to_device(self, device)


def check_shared_overlay(world: CompositeWorld) -> None:
    """Refuse a per-candidate overlay (sphere_center [C, S, 3])."""
    if world.overlay.sphere_center.dim() == 3:
        raise NotImplementedError(
            "CompositeWorld with a per-candidate overlay (the MPC form) is "
            "not ported yet; it lands with the MPC slice")


_BIG = 1e6


def safe_norm(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """‖x‖ along `dim`; forward values equal the JAX reference's safe_norm
    (0 at x = 0, NaN stays NaN)."""
    sq = torch.sum(x * x, dim=dim)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), sq * 0.0)


def _analytic_sdf(world: AnalyticWorld, p: torch.Tensor) -> torch.Tensor:
    """p: [..., 3] -> signed distance [...]."""
    d = torch.full(p.shape[:-1], _BIG, dtype=p.dtype, device=p.device)
    if world.sphere_radius.shape[0]:
        rel = p[..., None, :] - world.sphere_center           # [..., S, 3]
        ds = safe_norm(rel) - world.sphere_radius
        d = torch.minimum(d, ds.amin(dim=-1))
    if world.box_half.shape[0]:
        q = torch.abs(p[..., None, :] - world.box_center) - world.box_half
        outside = safe_norm(torch.clamp(q, min=0.0))
        inside = torch.clamp(q.amax(dim=-1), max=0.0)
        d = torch.minimum(d, (outside + inside).amin(dim=-1))
    return d


def grid_clip_hi(shape) -> np.ndarray:
    """Upper clip of the grid coordinate, shape - 1.000001 in float32 as the
    reference computes it (for the 64x80x48 tabletop it rounds to shape-1)."""
    return np.asarray(shape, np.float32) - np.float32(1.000001)


def _grid_sample(world: GridSDF, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample, distance only. p: [..., 3] -> [...].

    The float32 arithmetic follows the reference step by step: a true
    division into grid units, the clip, the cell index clipped to
    [0, dim-2], and interpolation along z, then y, then x."""
    shape = world.grid.shape
    g = (p - world.origin) / world.resolution
    hi = torch.as_tensor(grid_clip_hi(shape), device=p.device)
    g = torch.minimum(torch.clamp(g, min=0.0), hi)
    i0 = torch.minimum(torch.clamp(torch.floor(g).to(torch.int64), min=0),
                       torch.as_tensor(shape, device=p.device) - 2)
    f = g - i0.to(p.dtype)
    X, Y, Z = shape
    base = (i0[..., 0] * Y + i0[..., 1]) * Z + i0[..., 2]
    if world.packed is not None:
        rows = world.packed[base]                                # [..., 8]
        c000, c001, c010, c011, c100, c101, c110, c111 = rows.unbind(-1)
    else:
        flat = world.grid.reshape(-1)

        def corner(dx, dy, dz):
            return flat[base + (dx * Y + dy) * Z + dz]

        c000, c001 = corner(0, 0, 0), corner(0, 0, 1)
        c010, c011 = corner(0, 1, 0), corner(0, 1, 1)
        c100, c101 = corner(1, 0, 0), corner(1, 0, 1)
        c110, c111 = corner(1, 1, 0), corner(1, 1, 1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def sdf(world, p: torch.Tensor) -> torch.Tensor:
    """Signed distance at world points p [..., 3] (any world kind)."""
    if isinstance(world, AnalyticWorld):
        return _analytic_sdf(world, p)
    if isinstance(world, GridSDF):
        return _grid_sample(world, p)
    if isinstance(world, CompositeWorld):
        check_shared_overlay(world)
        return torch.minimum(_grid_sample(world.grid, p),
                             _analytic_sdf(world.overlay, p))
    raise NotImplementedError(
        f"{type(world).__name__}: the port takes AnalyticWorld, GridSDF or "
        "CompositeWorld")

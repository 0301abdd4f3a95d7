"""Signed-distance worlds (port of ``tpustomp/world/sdf.py``).

- `AnalyticWorld`: a union of spheres and axis-aligned boxes with a
  closed-form, min-composed SDF.
- `GridSDF`: a dense [X, Y, Z] float32 voxel grid, sampled trilinearly
  (world/edt.py builds these).
- `CompositeWorld`: a static grid plus an analytic overlay, min-composed.

`sdf(world, p)` takes any of the three. An AnalyticWorld (or a composite's
overlay) may carry a leading row axis on every leaf — one set of spheres
and boxes per row, the per-scenario worlds of batched MPC — and then
`p` carries the same leading axis (`world_rows`). `sdf_grad(world, p)`
adds the gradient (CHOMP), for worlds shared by every point.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpustomp_torch._tensors import to_device
from tpustomp_torch.utils import tracing


def _f32(x, shape=None) -> torch.Tensor:
    a = np.asarray(x, np.float32)
    return torch.as_tensor(a if shape is None else a.reshape(shape))


@dataclass(frozen=True)
class AnalyticWorld:
    """Union of spheres and axis-aligned boxes (min-composed SDF). Every
    leaf may carry a leading row axis [R, ...]: one world per row."""

    sphere_center: torch.Tensor  # [S, 3] or [R, S, 3]
    sphere_radius: torch.Tensor  # [S] or [R, S]
    box_center: torch.Tensor     # [X, 3] or [R, X, 3]
    box_half: torch.Tensor       # [X, 3] or [R, X, 3]

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
    fastest), the JAX package's layout. The plain sampler and the CUDA
    kernel read one row per sample when it is present, the dense grid
    otherwise.
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
            with tracing.span("world.pack", rows=g.size):
                packed = torch.as_tensor(np.stack(
                    [np.roll(g, (-dx, -dy, -dz), (0, 1, 2))
                     for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                    axis=-1).reshape(-1, 8))
        return GridSDF(grid=torch.as_tensor(g), origin=_f32(origin, (3,)),
                       resolution=_f32(resolution, ()), packed=packed)

    def to(self, device) -> "GridSDF":
        """The grid (and its corner table) on `device`, as a span
        `world.copy` (utils/tracing.py) with the bytes it holds."""
        with tracing.span("world.copy", to=str(device)) as s:
            if s is not tracing.OFF:
                s.set(bytes=sum(t.numel() * t.element_size() for t in (
                    self.grid, self.packed) if t is not None))
            return to_device(self, device)


@dataclass(frozen=True)
class CompositeWorld:
    """A static voxel grid plus an analytic overlay, min-composed (exact for
    unions). The overlay is the part that changes per control tick (MPC);
    it may carry a leading row axis (one overlay per scenario) while the
    grid stays shared."""

    grid: GridSDF
    overlay: AnalyticWorld

    @staticmethod
    def make(grid: GridSDF, spheres=(), boxes=()) -> "CompositeWorld":
        return CompositeWorld(grid=grid,
                              overlay=AnalyticWorld.make(spheres, boxes))

    def to(self, device) -> "CompositeWorld":
        return to_device(self, device)


def world_rows(world) -> int | None:
    """The leading row axis R of a world whose spheres and boxes (a
    composite's overlay) come one set per row — sphere_center [R, S, 3] —
    or None for a world shared by every point. Raises when the leaves
    disagree."""
    prims = world.overlay if isinstance(world, CompositeWorld) else world
    if not isinstance(prims, AnalyticWorld) or prims.sphere_center.dim() == 2:
        return None
    R = prims.sphere_center.shape[0]
    dims = (prims.sphere_center.dim(), prims.sphere_radius.dim(),
            prims.box_center.dim(), prims.box_half.dim())
    lead = {prims.sphere_center.shape[0], prims.sphere_radius.shape[0],
            prims.box_center.shape[0], prims.box_half.shape[0]}
    if dims != (3, 2, 3, 3) or lead != {R}:
        shapes = [tuple(getattr(prims, f).shape)
                  for f in AnalyticWorld.__dataclass_fields__]
        raise ValueError(
            "a world with a row axis needs sphere_center [R, S, 3], "
            "sphere_radius [R, S], box_center and box_half [R, X, 3]; got "
            f"{shapes}")
    return R


_BIG = 1e6


def safe_norm(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """‖x‖ along `dim`; forward values equal the JAX reference's safe_norm
    (0 at x = 0, NaN stays NaN)."""
    sq = torch.sum(x * x, dim=dim)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), sq * 0.0)


def _analytic_sdf(world: AnalyticWorld, p: torch.Tensor) -> torch.Tensor:
    """p: [..., 3] -> signed distance [...]; p: [R, ..., 3] for a world
    with R rows (row r's points against row r's primitives)."""
    rows = world_rows(world)
    if rows is not None and (p.dim() < 2 or p.shape[0] != rows):
        raise ValueError(f"a world with {rows} rows takes points "
                         f"[{rows}, ..., 3], got {tuple(p.shape)}")

    def lift(x):
        """Row leaves [R, n, ...] -> [R, 1, ..., 1, n, ...], broadcasting
        against p's middle axes."""
        if rows is None:
            return x
        return x.reshape(x.shape[:1] + (1,) * (p.dim() - 2) + x.shape[1:])

    d = torch.full(p.shape[:-1], _BIG, dtype=p.dtype, device=p.device)
    if world.sphere_radius.shape[-1]:
        rel = p[..., None, :] - lift(world.sphere_center)     # [..., S, 3]
        ds = safe_norm(rel) - lift(world.sphere_radius)
        d = torch.minimum(d, ds.amin(dim=-1))
    if world.box_half.shape[-2]:
        q = (torch.abs(p[..., None, :] - lift(world.box_center))
             - lift(world.box_half))
        outside = safe_norm(torch.clamp(q, min=0.0))
        inside = torch.clamp(q.amax(dim=-1), max=0.0)
        d = torch.minimum(d, (outside + inside).amin(dim=-1))
    return d


def grid_clip_hi(shape) -> np.ndarray:
    """Upper clip of the grid coordinate, shape - 1.000001 in float32 as the
    reference computes it (for the 64x80x48 tabletop it rounds to shape-1)."""
    return np.asarray(shape, np.float32) - np.float32(1.000001)


@functools.lru_cache(maxsize=64)
def _grid_bounds(shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid_clip_hi, shape - 2) of a grid on `device`, made once (no host
    copy per sample, none inside a captured graph)."""
    return (torch.as_tensor(grid_clip_hi(shape), device=device),
            torch.as_tensor(shape, device=device) - 2)


def _grid_sample(world: GridSDF, p: torch.Tensor, with_grad: bool = False):
    """Trilinear sample. p: [..., 3] -> d [...], or (d, grad [..., 3]) with
    with_grad=True (the interpolant's analytic gradient).

    The float32 arithmetic follows the reference step by step: a true
    division into grid units, the clip, the cell index clipped to
    [0, dim-2], and interpolation along z, then y, then x."""
    shape = world.grid.shape
    g = (p - world.origin) / world.resolution
    hi, i_hi = _grid_bounds(tuple(shape), p.device)
    g = torch.minimum(torch.clamp(g, min=0.0), hi)
    i0 = torch.minimum(torch.clamp(torch.floor(g).to(torch.int64), min=0),
                       i_hi)
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
    d = c0 * (1 - fx) + c1 * fx
    if not with_grad:
        return d
    inv_res = 1.0 / world.resolution
    gx = (c1 - c0) * inv_res
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) * inv_res
    gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
          + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx) * inv_res
    return d, torch.stack([gx, gy, gz], dim=-1)


def _analytic_sdf_grad(world: AnalyticWorld, p: torch.Tensor):
    """(distance, exact gradient) of the min-composed primitive SDF:
    sphere rel/‖rel‖; box outside (max(q,0) ⊙ sign(rel))/‖max(q,0)‖; box
    inside a unit step toward the least-deep face(s) (ties share it). The
    union takes the argmin primitive's gradient (the first on ties)."""
    tiny = 1e-12
    dists, grads = [], []
    if world.sphere_radius.shape[-1]:
        rel = p[..., None, :] - world.sphere_center           # [..., S, 3]
        norm = safe_norm(rel)
        dists.append(norm - world.sphere_radius)
        grads.append(rel / (norm + tiny)[..., None])
    if world.box_half.shape[-2]:
        rel = p[..., None, :] - world.box_center              # [..., X, 3]
        q = torch.abs(rel) - world.box_half
        qp = torch.clamp(q, min=0.0)
        outside = safe_norm(qp)
        q_max = q.amax(dim=-1, keepdim=True)
        dists.append(outside + torch.clamp(q_max[..., 0], max=0.0))
        sign = torch.sign(rel)
        g_out = qp * sign / (outside + tiny)[..., None]
        face = (q == q_max).to(p.dtype)
        face = face / torch.clamp(face.sum(dim=-1, keepdim=True), min=1.0)
        grads.append(torch.where((outside > 0.0)[..., None], g_out,
                                 face * sign))
    if not dists:
        return (torch.full(p.shape[:-1], _BIG, dtype=p.dtype,
                           device=p.device), torch.zeros_like(p))
    d_all = torch.cat(dists, dim=-1)                          # [..., P]
    g_all = torch.cat(grads, dim=-2)                          # [..., P, 3]
    idx = torch.argmin(d_all, dim=-1, keepdim=True)           # first on ties
    d = torch.gather(d_all, -1, idx)[..., 0]
    g = torch.gather(g_all, -2, idx[..., None].expand(
        idx.shape[:-1] + (1, 3)))[..., 0, :]
    return d, g


def sdf(world, p: torch.Tensor) -> torch.Tensor:
    """Signed distance at world points p [..., 3] (any world kind); for a
    world with R rows, p is [R, ..., 3]."""
    if isinstance(world, AnalyticWorld):
        return _analytic_sdf(world, p)
    if isinstance(world, GridSDF):
        return _grid_sample(world, p)
    if isinstance(world, CompositeWorld):
        return torch.minimum(_grid_sample(world.grid, p),
                             _analytic_sdf(world.overlay, p))
    raise NotImplementedError(
        f"{type(world).__name__}: the port takes AnalyticWorld, GridSDF or "
        "CompositeWorld")


def sdf_grad(world, p: torch.Tensor):
    """(distance [...], gradient [..., 3]) at world points p [..., 3], for
    a world shared by every point; a composite takes the grid's gradient
    where the grid is nearer or tied (dg <= da)."""
    if world_rows(world) is not None:
        raise NotImplementedError("sdf_grad takes a world shared by every "
                                  "point, not one with a row axis")
    if isinstance(world, AnalyticWorld):
        return _analytic_sdf_grad(world, p)
    if isinstance(world, GridSDF):
        return _grid_sample(world, p, with_grad=True)
    if isinstance(world, CompositeWorld):
        dg, gg = _grid_sample(world.grid, p, with_grad=True)
        da, ga = _analytic_sdf_grad(world.overlay, p)
        return (torch.minimum(dg, da),
                torch.where((dg <= da)[..., None], gg, ga))
    raise NotImplementedError(
        f"{type(world).__name__}: the port takes AnalyticWorld, GridSDF or "
        "CompositeWorld")

"""The plain reference of a voxelized world (world kind "voxel"), in plain
PyTorch: the field made from the configuration's boxes, its lookup, and the
checks that decide `correct` for plans made against it.

- Occupancy: a voxel is occupied when its centre, origin + resolution · i
  on each axis, lies inside a box by the box's own definition:
  |centre - c| <= h on every axis (the box's numbers rounded to float32,
  as the program holds them).
- Signed EDT: the exact squared distance to the nearest seed voxel, made
  separably: one brute-force 1-D min-plus pass per axis,
  f'(i) = min_j f(j) + (i - j)^2, over blocks of lines (every sum an
  exact integer). Then the square root and the sign: positive outside
  (the distance to the nearest occupied voxel), minus the distance to the
  nearest free voxel inside, times the resolution; a side with no seed
  holds +-1e6. This is a different algorithm from the program's lower
  envelope; both are exact.
- Lookup: trilinear, the grid coordinate (p - origin) / resolution (the
  origin and resolution rounded to float32, as the program holds them)
  clipped to [0, shape - 1.000001], the cell index to [0, dim - 2], then
  interpolation along z, y and x.

`VoxelWorld(world, dtype, device)` holds the field in `dtype` (float64 for
the reference; the control's float32 makes the field, the lookup and the
chain in float32) and offers `distance(p)`, so that reference/costs.py's
`total_cost` and `obstacle_rows` take it unchanged.

The checks are reference/verify.py's `check_plans` against the voxel world
(cost_gap, false_claims); box_intrusion: the deepest penetration, in m,
of any body of a row the program called solved into the exact boxes the
field was made from, which a field misplaced as a whole would show and a
comparison of the field with itself would not; and field_gap: the widest
distance, in m, between the field the program holds (its dense grid and
every corner of its corner table that a sample can read) and the float64
field.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.costs import World, total_cost
from benchmark.reference.kinematics import Chain
from benchmark.reference.precision import Precision
from benchmark.reference.verify import SLACK, wrap_goal

BIG = 1e6
# floats a min-plus block holds at most ([lines, n, n])
BLOCK_FLOATS = 1 << 25


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(x) -> np.ndarray:
    """x rounded to float32, as float64."""
    return np.asarray(x, np.float32).astype(np.float64)


def occupancy(boxes, origin, shape, resolution: float, device) -> torch.Tensor:
    """bool [X, Y, Z]: the voxels whose centre lies inside any box."""
    f64 = torch.float64
    centres = [torch.as_tensor(float(origin[k]), dtype=f64, device=device)
               + float(resolution) * torch.arange(int(shape[k]), dtype=f64,
                                                  device=device)
               for k in range(3)]
    occ = torch.zeros(tuple(int(n) for n in shape), dtype=torch.bool,
                      device=device)
    for c, h in boxes:
        c, h = _f32(c), _f32(h)
        x, y, z = ((centres[k] - c[k]).abs() <= h[k] for k in range(3))
        occ |= x[:, None, None] & y[None, :, None] & z[None, None, :]
    return occ


def _min_plus(f: torch.Tensor, axis: int) -> torch.Tensor:
    """f'(i) = min_j f(j) + (i - j)^2 along `axis`, by brute force over
    blocks of lines."""
    n = f.shape[axis]
    lines = f.movedim(axis, -1)
    shape = lines.shape
    lines = lines.reshape(-1, n)
    i = torch.arange(n, dtype=f.dtype, device=f.device)
    w = (i[:, None] - i[None, :]) ** 2                      # [i, j]
    out = torch.empty_like(lines)
    step = max(1, BLOCK_FLOATS // (n * n))
    for s in range(0, lines.shape[0], step):
        out[s:s + step] = (lines[s:s + step, None, :] + w).amin(dim=-1)
    return out.reshape(shape).movedim(-1, axis)


def squared_edt(seed: torch.Tensor, dtype) -> torch.Tensor:
    """The exact squared distance, in voxels^2, from every voxel to the
    nearest True voxel of `seed` (inf where there is none)."""
    f = torch.where(seed, torch.zeros((), dtype=dtype, device=seed.device),
                    torch.full((), float("inf"), dtype=dtype,
                               device=seed.device))
    for axis in range(3):
        f = _min_plus(f, axis)
    return f


def signed_edt(occ: torch.Tensor, resolution: float, dtype) -> torch.Tensor:
    """The signed field [X, Y, Z] in metres, in `dtype`."""
    d_out = torch.sqrt(squared_edt(occ, dtype))
    d_in = torch.sqrt(squared_edt(~occ, dtype))
    signed = torch.where(occ, -d_in, d_out) * resolution
    return torch.where(torch.isfinite(signed), signed,
                       torch.sign(signed) * BIG)


def lookup(field: torch.Tensor, origin, resolution, p: torch.Tensor):
    """Trilinear sample of `field` at points p [..., 3] (p's dtype)."""
    dt, dev = p.dtype, p.device
    shape = field.shape
    o = torch.as_tensor(_f32(origin), dtype=dt, device=dev)
    res = torch.as_tensor(_f32(resolution), dtype=dt, device=dev)
    hi = torch.as_tensor(np.asarray(shape, np.float64) - 1.000001,
                         dtype=dt, device=dev)
    g = torch.minimum(((p - o) / res).clamp(min=0.0), hi)
    top = torch.as_tensor(shape, device=dev) - 2
    i0 = torch.minimum(torch.floor(g).long().clamp(min=0), top)
    f = g - i0.to(dt)
    ix, iy, iz = i0.unbind(-1)
    fx, fy, fz = f.unbind(-1)

    def c(dx, dy, dz):
        return field[ix + dx, iy + dy, iz + dz]

    c00 = c(0, 0, 0) * (1 - fz) + c(0, 0, 1) * fz
    c01 = c(0, 1, 0) * (1 - fz) + c(0, 1, 1) * fz
    c10 = c(1, 0, 0) * (1 - fz) + c(1, 0, 1) * fz
    c11 = c(1, 1, 0) * (1 - fz) + c(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


class VoxelWorld:
    """The configuration's world (kind "voxel": boxes and a grid of origin,
    shape and resolution) voxelized, its field in `dtype` on `device`."""

    def __init__(self, world: dict, dtype, device):
        _no_tf32()
        g = world["grid"]
        self.origin, self.resolution = g["origin"], g["resolution"]
        self.occ = occupancy(world["boxes"], g["origin"], g["shape"],
                             g["resolution"], device)
        self.field = signed_edt(self.occ, float(g["resolution"]), dtype)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        """p [..., 3] -> signed distance [...]."""
        return lookup(self.field, self.origin, self.resolution, p)


def _t(x, dtype, device):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                           device=device)


def plan_costs(config: dict, traj: np.ndarray, prec: str, device,
               world: VoxelWorld, block: int = 4096):
    """(total cost, margin on the field, margin on the exact boxes) of full
    trajectories [M, T, d] in `prec`, in blocks of rows, as float64 numpy;
    `world` holds the field in `prec`'s dtype."""
    _no_tf32()
    prec = Precision(prec)
    chain = Chain(config["robot"]["geometry"], prec, device)
    boxes = World(config["world"]["boxes"], prec.dtype, device)
    out = ([], [], [])
    for i in range(0, len(traj), block):
        q = _t(traj[i:i + block], prec.dtype, device)
        c, m = total_cost(chain, world, q, config["planner"])
        exact = (boxes.distance(chain.bodies(q))
                 - chain.body_radius).amin(dim=(1, 2))
        for acc, v in zip(out, (c, m, exact)):
            acc.append(v.double().cpu().numpy())
    return tuple(np.concatenate(v) if v else np.zeros(0) for v in out)


def field_gap(ref: torch.Tensor, grid: torch.Tensor, packed=None) -> float:
    """The widest |program - reference| (m) over the program's dense grid
    [X, Y, Z] and, where it has one, its corner table [X·Y·Z, 8] (row i:
    the 8 corners of flat cell i, dz fastest) on the cells a sample reads,
    [0, dim - 2] on each axis."""
    grid = grid.to(ref.device, torch.float64)
    gap = (grid - ref).abs().max()
    if packed is not None:
        X, Y, Z = ref.shape
        table = packed.to(ref.device).reshape(X, Y, Z, 8)
        k = 0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    got = table[:X - 1, :Y - 1, :Z - 1, k].double()
                    want = ref[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
                    gap = torch.maximum(gap, (got - want).abs().max())
                    k += 1
    return float(gap)


def check_plans(config: dict, ans: dict, device, field=None) -> dict:
    """reference/verify.check_plans against the voxel world: ans holds
    trajectory [M, T, d], cost [M], success [M], iterations [M] and the
    queries q0 / qN [M, d]. Returns cost_gap and false_claims (as
    verify.check_plans defines them, the field in float64 in the boxes'
    place), box_intrusion (m): the deepest penetration into the exact
    boxes of a body of a row called solved, 0 where none enters, and, with
    field = (grid, corner table or None), field_gap (:func:`field_gap`)."""
    geo = config["robot"]["geometry"]
    traj = np.asarray(ans["trajectory"], np.float64)
    cost = np.asarray(ans["cost"], np.float64)
    success = np.asarray(ans["success"], bool)
    its = np.asarray(ans["iterations"])
    finite = np.isfinite(traj).all(axis=(1, 2)) & np.isfinite(cost)
    traj = np.where(finite[:, None, None], traj, 0.0)
    world = VoxelWorld(config["world"], torch.float64, device)
    ref_cost, ref_margin, box_margin = plan_costs(config, traj, "reference",
                                                  device, world)
    gap = np.abs(cost - ref_cost) / np.maximum(np.abs(ref_cost), 1e-6)
    lo, hi = _f32(geo["joint_lower"]), _f32(geo["joint_upper"])
    limited = np.asarray(geo["joint_limited"], bool)
    goal = wrap_goal(np.asarray(ans["q0"], np.float64),
                     np.asarray(ans["qN"], np.float64), limited)
    off_ends = np.maximum(np.abs(traj[:, 0] - ans["q0"]).max(axis=1),
                          np.abs(traj[:, -1] - goal).max(axis=1))
    excess = np.where(limited, np.maximum(lo - traj, traj - hi), 0.0).max(
        axis=(1, 2))
    max_it = config["planner"]["max_iterations"]
    false = (~finite | (off_ends > SLACK) | (excess > SLACK)
             | (its < 1) | (its > max_it) | (success & (ref_margin < -SLACK)))
    intrusion = np.where(success & finite, -box_margin, 0.0)
    out = {"cost_gap": float(np.where(finite, gap, 0.0).max(initial=0.0)),
           "false_claims": int(false.sum()),
           "box_intrusion": float(max(intrusion.max(initial=0.0), 0.0))}
    if field is not None:
        out["field_gap"] = field_gap(world.field, *field)
    return out


def control_plans(config: dict, ans: dict, device):
    """The control's answers and field: the reference in the program's
    place, in the control precision: each trajectory's cost and success
    worked out with the field, its lookup and the chain in float32 and
    TF32 matmul operands. Returns (answers, (field, None))."""
    world = VoxelWorld(config["world"], torch.float32, device)
    cost, margin, _ = plan_costs(config, np.asarray(ans["trajectory"]),
                                 "control", device, world)
    return dict(ans, cost=cost, success=margin > 0.0), (world.field, None)

"""Plain STOMP costs of given trajectories, from their definitions.

- World: the signed distance to a union of spheres and axis-aligned boxes,
  the least over every primitive (a box's exact distance: the norm of the
  outside part plus the largest inside component).
- Obstacle cost (CHOMP's potential, weighted by the body's speed): at each
  waypoint, for each body, the potential of its clearance d = distance -
  radius - eps (-d + eps/2 inside, (d - eps)^2 / (2 eps) up to eps, 0
  beyond), times the body's speed (central differences, one-sided at the
  ends), summed over bodies, times dt.
- Margin: the least distance - radius over every body and waypoint.
- Smoothness: 1/2 the sum over joints and waypoints of each weighted
  finite-difference derivative squared, the trajectory padded at either
  end with its endpoint (3-point stencils), taken as one product with the
  derivative operator.
"""

from __future__ import annotations

import numpy as np
import torch

# 3-point stencils: derivative order -> (coefficients, half width)
STENCILS = {1: ([-0.5, 0.0, 0.5], 1), 2: ([1.0, -2.0, 1.0], 1),
            3: ([-0.5, 1.0, 0.0, -1.0, 0.5], 2)}


class World:
    """Spheres [..., S, 3] / [..., S] and boxes [X, 3]; sphere leaves may
    carry a leading row axis (one set of moving spheres per scenario)."""

    def __init__(self, boxes, dtype, device, sphere_center=None,
                 sphere_radius=None):
        b = np.asarray([[*c, *h] for c, h in boxes], np.float32)
        b = torch.as_tensor(b.astype(np.float64).reshape(-1, 6), dtype=dtype,
                            device=device)
        self.box_center, self.box_half = b[:, :3], b[:, 3:]
        self.sphere_center, self.sphere_radius = sphere_center, sphere_radius

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        """p [..., 3] -> signed distance [...]. With a row axis, p is
        [R, ..., 3] and row r meets row r's spheres."""
        q = (p[..., None, :] - self.box_center).abs() - self.box_half
        outside = torch.linalg.vector_norm(q.clamp(min=0.0), dim=-1)
        inside = q.amax(dim=-1).clamp(max=0.0)
        d = (outside + inside).amin(dim=-1)
        if self.sphere_center is not None:
            c, r = self.sphere_center, self.sphere_radius
            lead = (1,) * (p.dim() - 1 - (c.dim() - 2))
            c = c.reshape(c.shape[:-2] + lead + c.shape[-2:])
            r = r.reshape(r.shape[:-1] + lead + r.shape[-1:])
            ds = torch.linalg.vector_norm(p[..., None, :] - c, dim=-1) - r
            d = torch.minimum(d, ds.amin(dim=-1))
        return d


def derivative_operator(N: int, dt: float, order: int):
    """(A [N+2, N], B [N+2, 2]): the order-th derivative at the N+2 true
    waypoints of [q0, theta_1..theta_N, qN] padded with its endpoints, as
    A @ theta + B @ [q0; qN] (float64, numpy)."""
    coeffs, r = STENCILS[order]
    A, B = np.zeros((N + 2, N)), np.zeros((N + 2, 2))
    for t in range(N + 2):
        for k, c in enumerate(coeffs):
            p = t + k - r
            if p <= 0:
                B[t, 0] += c
            elif p >= N + 1:
                B[t, 1] += c
            else:
                A[t, p - 1] += c
    return A / dt**order, B / dt**order


def smoothness_rows(prec, traj: torch.Tensor, dt: float,
                    weights) -> torch.Tensor:
    """traj [M, N+2, d] (endpoints included) -> the cost at each waypoint
    [M, N+2], in precision `prec`."""
    M, T, d = traj.shape
    N = T - 2
    rows = torch.zeros(M, T, dtype=traj.dtype, device=traj.device)
    for order, w in zip((1, 2, 3), weights):
        if w == 0.0:
            continue
        A, B = derivative_operator(N, dt, order)
        op = torch.as_tensor(np.concatenate([B[:, :1], A, B[:, 1:]], axis=1),
                             dtype=traj.dtype, device=traj.device)
        # one GEMM over every trajectory: [T, T] @ [T, M·d]
        cols = traj.permute(1, 0, 2).reshape(T, M * d)
        deriv = prec.matmul(op, cols).reshape(T, M, d)
        rows = rows + 0.5 * w * (deriv * deriv).sum(dim=2).t()
    return rows


def smoothness(prec, traj: torch.Tensor, dt: float, weights) -> torch.Tensor:
    """traj [M, N+2, d] (endpoints included) -> [M], in precision `prec`."""
    return smoothness_rows(prec, traj, dt, weights).sum(dim=1)


def potential(dist: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(dist < 0.0, -dist + 0.5 * eps,
                       torch.where(dist <= eps, (dist - eps) ** 2 / (2 * eps),
                                   torch.zeros_like(dist)))


def obstacle_rows(chain, world: World, traj: torch.Tensor, dt: float,
                  eps: float):
    """traj [M, T, d] -> (the obstacle cost at each waypoint [M, T], margin
    [M]); a world with a row axis takes M rows."""
    pos = chain.bodies(traj)                                  # [M, T, nb, 3]
    vel = torch.cat([(pos[:, 1:2] - pos[:, :1]) / dt,
                     (pos[:, 2:] - pos[:, :-2]) / (2 * dt),
                     (pos[:, -1:] - pos[:, -2:-1]) / dt], dim=1)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    clear = world.distance(pos) - chain.body_radius            # [M, T, nb]
    rows = (potential(clear - eps, eps) * speed).sum(dim=2) * dt
    return rows, clear.amin(dim=(1, 2))


def obstacle(chain, world: World, traj: torch.Tensor, dt: float, eps: float):
    """traj [M, T, d] -> (summed obstacle cost [M], margin [M]); a world
    with a row axis takes M rows."""
    rows, margin = obstacle_rows(chain, world, traj, dt, eps)
    return rows.sum(dim=1), margin


def total_cost(chain, world: World, traj: torch.Tensor, planner: dict):
    """(the solver's total cost [M], margin [M]) of full trajectories
    [M, T, d]: w_obstacle · obstacle + w_smoothness · smoothness."""
    T = traj.shape[1]
    dt = planner["duration"] / (T - 1)
    w = planner["weights"]
    sm = planner["smoothness"]
    obs, margin = obstacle(chain, world, traj, dt,
                           planner["collision_clearance"])
    ctrl = smoothness(chain.prec, traj, dt, (sm["weight_velocity"],
                                 sm["weight_acceleration"],
                                 sm["weight_jerk"]))
    return w["obstacle"] * obs + w["smoothness"] * ctrl, margin

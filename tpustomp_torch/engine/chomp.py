"""CHOMP gradients and the update direction (port of
``tpustomp/engine/chomp.py``; contract A.11).

Every function takes a leading scenario axis written out: theta [B, N, d],
q0/qN [B, d], full trajectories [B, T, d].

The JAX package computes these gradients in XLA, outside any Pallas kernel.
The port computes
- the functional gradient (A.11) from FK Jacobians (robot/fk.py) and the
  SDF gradient (world/sdf.py ``sdf_grad``), optionally mapped through the
  damped Jacobian pseudo-inverse (``_dls_solve3``, a closed-form 3×3 solve):
  in plain PyTorch here (:func:`obstacle_functional_gradient`, the CPU's
  route), and on the card in one kernel with the smoothness term added
  (kernels/chomp_grad.py, held to this version);
- the exact gradients, which differentiate the plain ``obstacle_cost``,
  ``constraint_cost`` and ``torque_cost`` with ``torch.autograd``, as the
  reference differentiates them with ``jax.grad``. No evaluator kernel has
  a backward pass in either package, so this is the one place where the
  evaluator's plain twin runs on the card.
"""

from __future__ import annotations

import torch

from tpustomp_torch.costs.constraints import as_tuple, constraint_cost
from tpustomp_torch.costs.obstacle import (obstacle_cost, potential,
                                           potential_deriv,
                                           workspace_velocity)
from tpustomp_torch.costs.smoothness import smoothness_gradient
from tpustomp_torch.costs.torque import torque_cost
from tpustomp_torch.engine.trajectory import full_trajectory
from tpustomp_torch.kernels import chomp_grad
from tpustomp_torch.robot.fk import body_pos_jac_traj
from tpustomp_torch.robot.model import RobotSpec
from tpustomp_torch.world.sdf import safe_norm, sdf_grad

_SPEED_EPS = 1e-6


def _dls_solve3(J: torch.Tensor, b: torch.Tensor,
                ridge: float) -> torch.Tensor:
    """(J Jᵀ + ridge·I)⁻¹ b for J [..., 3, d], b [..., 3] -> [..., 3]: the
    symmetric 3×3 system solved by its adjugate, in the reference's
    multiply-add order (a batched LU solve would round differently)."""
    G = torch.sum(J[..., :, None, :] * J[..., None, :, :], dim=-1)
    a = G[..., 0, 0] + ridge
    p = G[..., 0, 1]
    q = G[..., 0, 2]
    d = G[..., 1, 1] + ridge
    r = G[..., 1, 2]
    f = G[..., 2, 2] + ridge
    A = d * f - r * r
    B = q * r - p * f
    C = p * r - q * d
    D = a * f - q * q
    E = p * q - a * r
    F = a * d - p * p
    det = a * A + p * B + q * C
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(A * b0 + B * b1 + C * b2) / det,
                        (B * b0 + D * b1 + E * b2) / det,
                        (C * b0 + E * b1 + F * b2) / det], dim=-1)


def obstacle_functional_gradient(robot: RobotSpec, world,
                                 full_traj: torch.Tensor, dt: float,
                                 clearance: float,
                                 use_curvature: bool = True,
                                 use_pseudo_inverse: bool = False,
                                 pinv_ridge: float = 1e-4) -> torch.Tensor:
    """∇_θ q_obs at the interior waypoints (A.11): full_traj [..., T, d] ->
    [..., N, d]. With use_pseudo_inverse each body's workspace term goes
    through Jᵀ(JJᵀ + ridge·I)⁻¹ instead of Jᵀ."""
    x, J = body_pos_jac_traj(robot, full_traj)       # [.., T, B, 3], [.., 3, d]
    vel = workspace_velocity(x, dt)
    speed = safe_norm(vel)                                     # [..., T, B]
    dist, grad_d = sdf_grad(world, x)
    d_sig = dist - robot.body_radius - clearance
    pd = potential_deriv(d_sig, clearance)
    if use_curvature:
        xhat = vel / (speed[..., None] + _SPEED_EPS)

        def proj(v):
            return v - xhat * torch.sum(xhat * v, dim=-1, keepdim=True)

        accel = workspace_velocity(vel, dt)
        kappa = proj(accel) / (speed[..., None] ** 2 + _SPEED_EPS)
        pot = potential(d_sig, clearance)
        ws = speed[..., None] * (proj(pd[..., None] * grad_d)
                                 - pot[..., None] * kappa) * dt
    else:
        ws = pd[..., None] * grad_d * speed[..., None] * dt
    if use_pseudo_inverse:
        ws = _dls_solve3(J, ws, pinv_ridge)
    g = torch.sum(ws[..., None] * J, dim=(-3, -2))             # [..., T, d]
    return g[..., 1:-1, :]


def _grad_of(cost_fn, theta: torch.Tensor) -> torch.Tensor:
    """∇ of Σ cost_fn(θ) over every scenario: the scenarios are independent,
    so row b of the result is scenario b's own gradient."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(cost_fn(th), th)
    return g


def exact_obstacle_gradient(robot: RobotSpec, world, theta: torch.Tensor,
                            q0: torch.Tensor, qN: torch.Tensor, dt: float,
                            clearance: float) -> torch.Tensor:
    """∇_θ Σ_t q_obs(t) of the discretized cost the solver monitors, by
    autograd through the plain obstacle_cost."""
    def cost(th):
        q, _ = obstacle_cost(robot, world, full_trajectory(th, q0, qN), dt,
                             clearance)
        return torch.sum(q)

    return _grad_of(cost, theta)


def exact_extra_gradient(robot: RobotSpec, theta: torch.Tensor,
                         q0: torch.Tensor, qN: torch.Tensor, dt: float,
                         constraints, w_constraint: float,
                         w_torque: float) -> torch.Tensor:
    """∇_θ of the constraint (+ torque) cost terms by autograd; both are in
    CHOMP's gradient since the reference's round-5 fix."""
    cons = as_tuple(constraints)

    def cost(th):
        full = full_trajectory(th, q0, qN)
        c = torch.zeros((), dtype=th.dtype, device=th.device)
        if cons and w_constraint > 0.0:
            c = c + w_constraint * torch.sum(constraint_cost(robot, cons,
                                                             full))
        if w_torque > 0.0:
            c = c + w_torque * torch.sum(torque_cost(robot, full, dt))
        return c

    return _grad_of(cost, theta)


def chomp_gradient(ops, robot: RobotSpec, world, theta: torch.Tensor,
                   q0: torch.Tensor, qN: torch.Tensor, dt: float,
                   clearance: float,
                   w_obstacle: float, w_smoothness: float,
                   use_curvature: bool = True,
                   use_pseudo_inverse: bool = False,
                   pinv_ridge: float = 1e-4,
                   gradient_mode: str = "functional", constraints=None,
                   w_constraint: float = 0.0,
                   w_torque: float = 0.0) -> torch.Tensor:
    """∇U = w_o ∇q_obs + w_s (Rθ + R_bias q) [+ w_c ∇q_con + w_τ ∇q_τ]:
    [B, N, d]. Shared by the CHOMP update and HMC's leapfrog force.
    gradient_mode "exact" differentiates the discretized obstacle cost and
    ignores use_pseudo_inverse; the constraint and torque terms are always
    exact. The functional mode's first two terms are one kernel on CUDA
    tensors (kernels/chomp_grad.py ``functional_gradient``, held to this
    module's plain version) and that plain version on the CPU."""
    smooth = smoothness_gradient(ops, theta, q0, qN)
    if gradient_mode != "exact" and theta.device.type == "cuda":
        g = chomp_grad.functional_gradient(
            robot, world, theta, q0, qN, smooth, dt, clearance, w_obstacle,
            w_smoothness, use_curvature, use_pseudo_inverse, pinv_ridge)
    else:
        if gradient_mode == "exact":
            g_obs = exact_obstacle_gradient(robot, world, theta, q0, qN, dt,
                                            clearance)
        else:
            g_obs = obstacle_functional_gradient(
                robot, world, full_trajectory(theta, q0, qN), dt, clearance,
                use_curvature, use_pseudo_inverse, pinv_ridge)
        g = w_obstacle * g_obs + w_smoothness * smooth
    if (as_tuple(constraints) and w_constraint > 0.0) or w_torque > 0.0:
        g = g + exact_extra_gradient(robot, theta, q0, qN, dt, constraints,
                                     w_constraint, w_torque)
    return g


def chomp_delta(ops, robot: RobotSpec, world, theta: torch.Tensor,
                q0: torch.Tensor, qN: torch.Tensor,
                dt: float, clearance: float, w_obstacle: float,
                w_smoothness: float, learning_rate: float,
                use_curvature: bool = True,
                use_pseudo_inverse: bool = False, pinv_ridge: float = 1e-4,
                gradient_mode: str = "functional", constraints=None,
                w_constraint: float = 0.0,
                w_torque: float = 0.0) -> torch.Tensor:
    """One CHOMP update direction, −η·R⁻¹·∇U [B, N, d]. R⁻¹ makes the
    smoothness part an exact Newton step, a cancellation that needs true
    fp32 matmuls (the solver refuses TF32 on CUDA)."""
    grad = chomp_gradient(ops, robot, world, theta, q0, qN, dt,
                          clearance, w_obstacle, w_smoothness, use_curvature,
                          use_pseudo_inverse, pinv_ridge, gradient_mode,
                          constraints, w_constraint, w_torque)
    return -learning_rate * (ops.Rinv @ grad)

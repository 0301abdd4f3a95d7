"""Torque cost through recursive Newton-Euler inverse dynamics (port of
``tpustomp/costs/torque.py``; A.8: q_torque(t) = Σ_j |τ_j(t)| · dt).

The world-frame recursion runs down and back up the chain as two Python
loops over the d joints, each step elementwise over every leading axis
(waypoints, candidates, scenarios): plain tensors, no per-waypoint loop.
Joint velocities and accelerations are central differences, zero at the
two endpoints.
"""

from __future__ import annotations

import functools

import torch

from tpustomp_torch.robot.fk import _mat_mul, _mat_vec, cross, fk_frames
from tpustomp_torch.robot.model import PRISMATIC, RobotSpec, joint_types

GRAVITY = (0.0, 0.0, -9.81)


@functools.lru_cache(maxsize=16)
def _base_accel(gravity: tuple, dtype, device) -> torch.Tensor:
    """-gravity on the device, made once (no host copy per call, none
    inside a captured graph)."""
    return -torch.as_tensor(gravity, dtype=dtype, device=device)


def rne_torques(robot: RobotSpec, q: torch.Tensor, qd: torch.Tensor,
                qdd: torch.Tensor, gravity=GRAVITY) -> torch.Tensor:
    """Joint torques: q, qd, qdd [..., d] -> tau [..., d]."""
    d = robot.num_joints
    dt_ = q.dtype
    pos, rot, axis_w = fk_frames(robot, q)
    prism = [t == PRISMATIC for t in joint_types(robot)]

    # forward pass: angular velocity/acceleration and origin acceleration of
    # each joint frame; gravity enters as a base accelerating at -g
    zero = torch.zeros_like(pos[..., 0, :])
    om_p, al_p = zero, zero
    a_p = _base_accel(tuple(gravity), dt_, q.device).expand_as(zero)
    p_p = robot.base_pos.to(dt_).expand_as(zero)
    omega, alpha, acc = [], [], []
    for i in range(d):
        w = axis_w[..., i, :]
        r = pos[..., i, :] - p_p
        a_o = a_p + cross(al_p, r) + cross(om_p, cross(om_p, r))
        w_qd = w * qd[..., i, None]
        if prism[i]:
            om, al = om_p, al_p
            a = a_o + w * qdd[..., i, None] + 2.0 * cross(om_p, w_qd)
        else:
            om = om_p + w_qd
            al = al_p + (w * qdd[..., i, None] + cross(om_p, w_qd))
            a = a_o
        omega.append(om)
        alpha.append(al)
        acc.append(a)
        om_p, al_p, a_p, p_p = om, al, a, pos[..., i, :]
    omega = torch.stack(omega, dim=-2)
    alpha = torch.stack(alpha, dim=-2)
    acc = torch.stack(acc, dim=-2)                               # [..., d, 3]

    # link wrenches about each joint origin
    com_w = pos + _mat_vec(rot, robot.link_com.to(dt_))
    rc = com_w - pos
    a_com = acc + cross(alpha, rc) + cross(omega, cross(omega, rc))
    F = robot.link_mass.to(dt_)[:, None] * a_com
    I_w = _mat_mul(_mat_mul(rot, robot.link_inertia.to(dt_)),
                   rot.transpose(-1, -2))
    Nm = _mat_vec(I_w, alpha) + cross(omega, _mat_vec(I_w, omega))

    # backward pass: accumulate the child wrenches toward the base
    f_c, n_c, p_c = zero, zero, pos[..., d - 1, :]
    tau = [None] * d
    for i in range(d - 1, -1, -1):
        p_i, F_i = pos[..., i, :], F[..., i, :]
        f = F_i + f_c
        n = (Nm[..., i, :] + n_c + cross(com_w[..., i, :] - p_i, F_i)
             + cross(p_c - p_i, f_c))
        tau[i] = torch.sum(axis_w[..., i, :] * (f if prism[i] else n),
                           dim=-1)
        f_c, n_c, p_c = f, n, p_i
    return torch.stack(tau, dim=-1)


def joint_derivatives(full_traj: torch.Tensor, dt: float):
    """Central-difference q̇, q̈ at the true waypoints, zero at both ends:
    [..., T, d] -> ([..., T, d], [..., T, d])."""
    end = torch.zeros_like(full_traj[..., :1, :])
    qd = (full_traj[..., 2:, :] - full_traj[..., :-2, :]) / (2.0 * dt)
    qdd = (full_traj[..., 2:, :] - 2.0 * full_traj[..., 1:-1, :]
           + full_traj[..., :-2, :]) / dt ** 2
    return (torch.cat([end, qd, end], dim=-2),
            torch.cat([end, qdd, end], dim=-2))


def torque_cost(robot: RobotSpec, full_traj: torch.Tensor, dt: float,
                gravity=GRAVITY) -> torch.Tensor:
    """Per-waypoint torque cost rows: [..., T, d] -> [..., T]
    (Σ_j |τ_j(t)| · dt, A.8)."""
    qd, qdd = joint_derivatives(full_traj, dt)
    tau = rne_torques(robot, full_traj, qd, qdd, gravity)
    return torch.sum(torch.abs(tau), dim=-1) * dt

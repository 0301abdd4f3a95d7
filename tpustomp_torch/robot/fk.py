"""Batched forward kinematics and point Jacobians for serial chains (port
of ``tpustomp/robot/fk.py``).

Every function takes configurations q [..., d] with any leading batch axes
(waypoints, candidates, scenarios) written out — there is no vmap. The 3x3
algebra is explicit elementwise multiply-add, in the same order as the JAX
reference, so the two agree to float32 rounding.
"""

from __future__ import annotations

import torch

from tpustomp_torch.robot.model import PRISMATIC, RobotSpec, joint_types


def _mat_mul(a, b):
    """[..., 3, 3] @ [..., 3, 3] as multiply-add."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mat_vec(R, v):
    """[..., 3, 3] @ [..., 3] as multiply-add."""
    return torch.sum(R * v[..., None, :], dim=-1)


def cross(a, b):
    """a × b over the last axis [..., 3], in jnp.cross's arithmetic."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation about unit `axis` [3] by `angle` [...] -> [..., 3, 3]."""
    x, y, z = axis[0], axis[1], axis[2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y]),
        torch.stack([z, zero, -x]),
        torch.stack([-y, x, zero]),
    ])
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * _mat_mul(K, K)


def fk_frames(robot: RobotSpec, q: torch.Tensor):
    """All joint frames for configurations q [..., d].

    Returns (pos [..., d, 3] post-joint-motion origins, rot [..., d, 3, 3]
    post-joint rotations, axis_w [..., d, 3] joint axes in world frame).
    """
    batch = q.shape[:-1]
    p = robot.base_pos.to(q.dtype).expand(*batch, 3)
    R = robot.base_rot.to(q.dtype).expand(*batch, 3, 3)
    jtype = joint_types(robot)
    pos, rot, axis_w = [], [], []
    for j in range(robot.num_joints):
        axis = robot.joint_axis[j].to(q.dtype)
        p_j = p + _mat_vec(R, robot.joint_offset[j].to(q.dtype))
        R_mid = (R if robot.rot_fixed_identity
                 else _mat_mul(R, robot.joint_rot[j].to(q.dtype)))
        aw = _mat_vec(R_mid, axis)
        qj = q[..., j]
        if jtype[j] == PRISMATIC:
            R, p = R_mid, p_j + aw * qj[..., None]
        else:
            R, p = _mat_mul(R_mid, rodrigues(axis, qj)), p_j
        pos.append(p)
        rot.append(R)
        axis_w.append(aw)
    return (torch.stack(pos, dim=-2), torch.stack(rot, dim=-3),
            torch.stack(axis_w, dim=-2))


def body_positions(robot: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """World positions of the sphere bodies: q [..., d] -> [..., B, 3]."""
    pos, rot, _ = fk_frames(robot, q)
    link = robot.body_link.long()
    link_p = pos[..., link, :]                         # [..., B, 3]
    link_R = rot[..., link, :, :]                      # [..., B, 3, 3]
    return link_p + _mat_vec(link_R, robot.body_offset.to(q.dtype))


def body_positions_traj(robot: RobotSpec, traj: torch.Tensor) -> torch.Tensor:
    """Body positions along trajectories: traj [..., T, d] -> [..., T, B, 3]
    (the waypoint axis is one more batch axis)."""
    return body_positions(robot, traj)


def body_positions_and_jacobians(robot: RobotSpec, q: torch.Tensor):
    """Sphere positions x [..., B, 3] and point Jacobians J [..., B, 3, d]
    (CHOMP, A.11). Joint i moves body b iff i <= body_link[b]: revolute
    column w_i × (x_b − p_i), prismatic column w_i."""
    pos, rot, axis_w = fk_frames(robot, q)
    link = robot.body_link.long()
    x = pos[..., link, :] + _mat_vec(rot[..., link, :, :],
                                     robot.body_offset.to(q.dtype))
    rel = x[..., :, None, :] - pos[..., None, :, :]            # [..., B, d, 3]
    aw = axis_w[..., None, :, :].expand_as(rel)
    prism = (robot.joint_type == PRISMATIC)[:, None]           # [d, 1]
    cols = torch.where(prism, aw, cross(aw, rel))
    d = robot.num_joints
    mask = (torch.arange(d, device=q.device)[None, :]
            <= robot.body_link[:, None])[:, :, None]           # [B, d, 1]
    J = torch.where(mask, cols, torch.zeros_like(cols))
    return x, J.transpose(-1, -2)


def body_pos_jac_traj(robot: RobotSpec, traj: torch.Tensor):
    """Along trajectories: traj [..., T, d] -> (x [..., T, B, 3],
    J [..., T, B, 3, d])."""
    return body_positions_and_jacobians(robot, traj)

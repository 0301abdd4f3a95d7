"""Robot model: kinematic chain spec + sphere collision bodies, as tensors
(port of ``tpustomp/robot/model.py``).

A planning group is a serial chain flattened to stacked tensors (axes, fixed
offsets/rotations, limits) plus a sphere set (attach link index, offset in
link frame, radius). Built-in models: `planar_2r` (BASELINE config 1) and
`arm_7dof` (BASELINE configs 2 and 4). Builders return CPU tensors; move a
spec with ``robot.to(device)``.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from tpustomp_torch._tensors import host_mirror, to_device

REVOLUTE = 0
PRISMATIC = 1


@dataclass(frozen=True)
class RobotSpec:
    """Serial-chain robot + sphere bodies. d joints, B bodies.

    Frame convention: joint i's frame is
        T_i = T_{i-1} · Trans(offset_i) · RotFixed_i · Joint(axis_i, q_i)
    with T_{-1} = (base_rot, base_pos).
    """

    joint_type: torch.Tensor     # [d] int32 (REVOLUTE | PRISMATIC)
    joint_axis: torch.Tensor     # [d, 3] unit axes in joint frame
    joint_offset: torch.Tensor   # [d, 3]
    joint_rot: torch.Tensor      # [d, 3, 3] fixed rotations
    joint_lower: torch.Tensor    # [d]
    joint_upper: torch.Tensor    # [d]
    joint_limited: torch.Tensor  # [d] bool (False = continuous joint)
    base_pos: torch.Tensor       # [3]
    base_rot: torch.Tensor       # [3, 3]
    ee_offset: torch.Tensor      # [3] tool point in the last joint's frame
    body_link: torch.Tensor      # [B] int32 — joint index the sphere rides on
    body_offset: torch.Tensor    # [B, 3] position in that joint's frame
    body_radius: torch.Tensor    # [B]
    link_mass: torch.Tensor      # [d] kg
    link_com: torch.Tensor       # [d, 3]
    link_inertia: torch.Tensor   # [d, 3, 3]
    # every joint_rot is exactly identity (FK may skip R @ rot_fixed)
    rot_fixed_identity: bool = False
    # bodies per joint, with the body arrays link-sorted (enforced by _spec);
    # the evaluator kernel walks one contiguous run of bodies per joint
    body_counts: tuple | None = None
    # per-joint (type, ax, ay, az) as Python numbers, mirroring the JAX
    # spec: with body_counts, the evaluator kernels compile this chain in
    # (kernels/rollout.py chain_of); it must agree with joint_type /
    # joint_axis (check_joint_static)
    joint_static: tuple | None = None

    @property
    def num_joints(self) -> int:
        return self.joint_axis.shape[0]

    @property
    def num_bodies(self) -> int:
        return self.body_radius.shape[0]

    def to(self, device) -> "RobotSpec":
        return to_device(self, device)


def joint_types(robot: RobotSpec) -> list[int]:
    """The joint types as Python ints, for code that branches on them (FK,
    RNE): from joint_static when it is set (check_joint_static holds it to
    joint_type at every public call), else from joint_type's host copy
    (_tensors.host_mirror) or joint_type itself on the CPU, else one read
    of the device (engine/graph.py runs such a robot in the eager loop)."""
    if robot.joint_static is not None:
        return [int(s[0]) for s in robot.joint_static]
    mirror = host_mirror(robot.joint_type)
    return (robot.joint_type if mirror is None else mirror).tolist()


def joint_types_on_host(robot: RobotSpec) -> bool:
    """joint_types reads nothing from the device."""
    return (robot.joint_static is not None
            or robot.joint_type.device.type == "cpu"
            or host_mirror(robot.joint_type) is not None)


def check_joint_static(robot: RobotSpec) -> RobotSpec:
    """Drop a stale joint_static (and warn) if it contradicts joint_type /
    joint_axis (the JAX package's _check_joint_static,
    kernels/rollout_pallas.py:865-890): guards ``dataclasses.replace(robot,
    joint_axis=...)`` without a matching joint_static, which the compiled
    chain would otherwise plan with the old kinematics. The public entry
    points call it once per call; it reads the joint arrays on the host."""
    static = robot.joint_static
    if static is None:
        return robot
    types = [int(t) for t, _, _, _ in static]
    axes = np.asarray([[a, b, c] for _, a, b, c in static], np.float32)
    if (np.array_equal(robot.joint_type.cpu().numpy(), types)
            and np.array_equal(robot.joint_axis.cpu().numpy(), axes)):
        return robot
    warnings.warn(
        "RobotSpec.joint_static disagrees with joint_type/joint_axis "
        "(stale dataclasses.replace?); disabling kernel FK specialization "
        "for this call", stacklevel=3)
    return dataclasses.replace(robot, joint_static=None)


def _spec(joint_axis, joint_offset, joint_rot, lower, upper, limited,
          body_link, body_offset, body_radius, joint_type=None,
          base_pos=None, base_rot=None, link_mass=None, link_com=None,
          link_inertia=None, ee_offset=None) -> RobotSpec:
    d = len(joint_axis)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    # link-sort the bodies (stable) so the evaluator can consume them as
    # one contiguous run per joint; cost order is irrelevant (sums/mins)
    body_link = np.asarray(body_link, np.int32).reshape(-1)
    body_offset = np.asarray(body_offset, np.float32).reshape(-1, 3)
    body_radius = np.asarray(body_radius, np.float32).reshape(-1)
    if body_link.size:
        order = np.argsort(body_link, kind="stable")
        body_link = body_link[order]
        body_offset = body_offset[order]
        body_radius = body_radius[order]
    counts = tuple(int(np.sum(body_link == j)) for j in range(d))
    jtype = np.asarray(joint_type if joint_type is not None
                       else [REVOLUTE] * d, np.int32)
    return RobotSpec(
        joint_type=torch.as_tensor(jtype),
        joint_axis=f32(joint_axis),
        joint_offset=f32(joint_offset),
        joint_rot=f32(joint_rot),
        joint_lower=f32(lower),
        joint_upper=f32(upper),
        joint_limited=torch.as_tensor(np.asarray(limited, bool)),
        base_pos=f32(base_pos if base_pos is not None else [0, 0, 0]),
        base_rot=f32(base_rot if base_rot is not None else np.eye(3)),
        ee_offset=f32(ee_offset if ee_offset is not None else [0, 0, 0]),
        body_link=torch.as_tensor(body_link),
        body_offset=f32(body_offset),
        body_radius=f32(body_radius),
        link_mass=f32(link_mass if link_mass is not None else np.zeros(d)),
        link_com=f32(link_com if link_com is not None else np.zeros((d, 3))),
        link_inertia=f32(link_inertia if link_inertia is not None
                         else np.zeros((d, 3, 3))),
        rot_fixed_identity=bool(
            np.allclose(np.asarray(joint_rot, np.float64),
                        np.broadcast_to(np.eye(3), (d, 3, 3)), atol=0.0)),
        body_counts=counts,
        joint_static=tuple(
            (int(t), float(np.float32(a[0])), float(np.float32(a[1])),
             float(np.float32(a[2])))
            for t, a in zip(jtype, np.asarray(joint_axis, np.float32))),
    )


def _eye(d):
    return np.broadcast_to(np.eye(3), (d, 3, 3)).copy()


def planar_2r(link_lengths=(1.0, 1.0), body_radius=0.05,
              bodies_per_link: int = 1, masses=(0.0, 0.0)) -> RobotSpec:
    """Planar 2R arm in the z=0 plane (BASELINE config 1)."""
    l1, l2 = link_lengths
    axes = [[0, 0, 1], [0, 0, 1]]
    offsets = [[0, 0, 0], [l1, 0, 0]]
    lower, upper = [-np.pi, -np.pi], [np.pi, np.pi]
    body_link, body_offset, body_radius_l = [], [], []
    for s in range(bodies_per_link):
        frac = (s + 1) / bodies_per_link
        body_link.append(0)
        body_offset.append([l1 * frac, 0.0, 0.0])
        body_radius_l.append(body_radius)
    for s in range(bodies_per_link):
        frac = (s + 1) / bodies_per_link
        body_link.append(1)
        body_offset.append([l2 * frac, 0.0, 0.0])
        body_radius_l.append(body_radius)
    return _spec(axes, offsets, _eye(2), lower, upper, [False, False],
                 body_link, body_offset, body_radius_l,
                 link_mass=list(masses),
                 link_com=[[l1, 0, 0], [l2, 0, 0]],
                 ee_offset=[l2, 0, 0])


def arm_7dof(spheres_per_link: int = 4) -> RobotSpec:
    """Mobile-manipulator-style 7-DOF arm (BASELINE configs 2 and 4): pan,
    lift, upper-arm roll, elbow flex, forearm roll, wrist flex, wrist roll, with
    `spheres_per_link` spheres on each of the three long links."""
    upper_arm, forearm, hand = 0.40, 0.32, 0.16
    axes = [
        [0, 0, 1],   # shoulder pan
        [0, 1, 0],   # shoulder lift
        [1, 0, 0],   # upper-arm roll
        [0, 1, 0],   # elbow flex
        [1, 0, 0],   # forearm roll
        [0, 1, 0],   # wrist flex
        [1, 0, 0],   # wrist roll
    ]
    offsets = [
        [0.0, 0.0, 0.8],          # base -> shoulder (torso height)
        [0.1, 0.0, 0.0],          # pan -> lift
        [0.0, 0.0, 0.0],          # lift -> roll (coincident)
        [upper_arm, 0.0, 0.0],    # roll -> elbow
        [0.0, 0.0, 0.0],          # elbow -> forearm roll
        [forearm, 0.0, 0.0],      # forearm roll -> wrist flex
        [0.0, 0.0, 0.0],          # wrist flex -> wrist roll
    ]
    lower = [-2.28, -0.52, -3.9, -2.32, -np.pi, -2.18, -np.pi]
    upper = [0.71, 1.39, 0.8, 0.0, np.pi, 0.0, np.pi]
    limited = [True, True, True, True, False, True, False]

    # each link's spheres ride the joint frame at its proximal end
    segments = [(2, upper_arm, 0.06), (4, forearm, 0.05), (6, hand, 0.04)]
    body_link, body_offset, body_radius = [], [], []
    for link, span, rad in segments:
        for s in range(spheres_per_link):
            frac = (s + 1) / spheres_per_link
            body_link.append(link)
            body_offset.append([span * frac, 0.0, 0.0])
            body_radius.append(rad)
    masses = [2.5, 2.5, 2.0, 1.6, 1.0, 0.6, 0.4]
    coms = [[0.05, 0, 0], [0, 0, 0], [upper_arm / 2, 0, 0], [0, 0, 0],
            [forearm / 2, 0, 0], [0, 0, 0], [hand / 2, 0, 0]]
    inertias = [np.eye(3) * v for v in
                (0.01, 0.01, 0.02, 0.008, 0.01, 0.003, 0.001)]
    return _spec(axes, offsets, _eye(7), lower, upper, limited,
                 body_link, body_offset, body_radius,
                 link_mass=masses, link_com=coms, link_inertia=inertias,
                 ee_offset=[hand, 0, 0])

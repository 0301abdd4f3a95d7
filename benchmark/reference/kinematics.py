"""Plain forward kinematics of a serial chain with sphere bodies.

Written from the chain's own arrays in a configuration file
(`robot.geometry`): joint i's frame is the previous frame, moved by the
fixed offset_i, then turned about axis_i by q_i (a revolute joint) or slid
along it (a prismatic one). A body rides on its joint's frame at a fixed
offset. Frames are composed with matmuls (reference/precision.py), so
the precision of the check's matmuls is the precision of the chain.
"""

from __future__ import annotations

import numpy as np
import torch



class Chain:
    """A robot's chain and bodies in precision `prec` (reference/
    precision.py) on `device`. Every number is first rounded to float32, as
    the program under test holds it."""

    def __init__(self, geometry: dict, prec, device):
        def t(key):
            a = np.asarray(geometry[key], np.float32).astype(np.float64)
            return torch.as_tensor(a, dtype=prec.dtype, device=device)

        self.prec, self.dtype, self.device = prec, prec.dtype, device
        self.axis = t("joint_axis")                    # [d, 3]
        self.offset = t("joint_offset")                # [d, 3]
        self.prismatic = [bool(k) for k in geometry["joint_prismatic"]]
        self.lower, self.upper = t("joint_lower"), t("joint_upper")
        self.limited = torch.as_tensor(geometry["joint_limited"],
                                       device=device)
        self.base_pos, self.base_rot = t("base_pos"), t("base_rot")
        self.body_link = [int(k) for k in geometry["body_link"]]
        self.body_offset = t("body_offset")            # [nb, 3]
        self.body_radius = t("body_radius")            # [nb]
        self.d = len(self.prismatic)

    def rotation(self, j: int, q: torch.Tensor) -> torch.Tensor:
        """Rodrigues' rotation about axis j by q [...] -> [..., 3, 3]."""
        x, y, z = self.axis[j].tolist()
        K = torch.tensor([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]],
                         dtype=self.dtype, device=self.device)
        s = torch.sin(q)[..., None, None]
        c = torch.cos(q)[..., None, None]
        eye = torch.eye(3, dtype=self.dtype, device=self.device)
        return eye + s * K + (1.0 - c) * self.prec.matmul(K, K)

    def bodies(self, q: torch.Tensor) -> torch.Tensor:
        """World positions of the sphere bodies: q [..., d] -> [..., nb, 3]."""
        batch = q.shape[:-1]
        p = self.base_pos.expand(*batch, 3)
        R = self.base_rot.expand(*batch, 3, 3)
        frames = []
        for j in range(self.d):
            p = p + self.prec.matmul(R, self.offset[j])
            if self.prismatic[j]:
                p = p + self.prec.matmul(R, self.axis[j]) * q[..., j, None]
            else:
                R = self.prec.matmul(R, self.rotation(j, q[..., j]))
            frames.append((p, R))
        mm = self.prec.matmul
        out = [frames[k][0] + mm(frames[k][1], self.body_offset[b])
               for b, k in enumerate(self.body_link)]
        return torch.stack(out, dim=-2)

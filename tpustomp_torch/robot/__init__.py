"""Robots: the chain spec and its built-ins (model), forward kinematics
(fk), and URDF loading (urdf_lite)."""

from tpustomp_torch.robot.urdf_lite import (load_urdf, load_urdf_file,
                                            load_urdf_group)

__all__ = ["load_urdf", "load_urdf_file", "load_urdf_group"]

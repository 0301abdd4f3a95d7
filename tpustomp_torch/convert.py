"""Build the port's state from the JAX package's, given as numpy arrays.

The parity tests construct one robot / world / operator bundle with the
JAX package, read its fields as numpy, and hand the same values to both
sides through these converters. Pass ``{f.name: getattr(obj, f.name) for f
in dataclasses.fields(obj)}``; any array-like (numpy, or anything with
``__array__``) is accepted, and static (non-array) fields are kept as they
are. Nothing here imports the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpustomp_torch.dynamics.device import DeviceOps
from tpustomp_torch.engine.mpc import MPCState
from tpustomp_torch.robot.model import RobotSpec
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld, GridSDF

_ROBOT_STATIC = ("rot_fixed_identity", "body_counts", "joint_static")
_INT_FIELDS = ("joint_type", "body_link")


def _tensor(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def robot_from_numpy(fields: Mapping, device="cpu") -> RobotSpec:
    """RobotSpec from the JAX RobotSpec's fields, static ones included
    (body_counts, joint_static, rot_fixed_identity)."""
    kw = {}
    for name in RobotSpec.__dataclass_fields__:
        v = fields[name]
        if name in _ROBOT_STATIC:
            kw[name] = v
        elif name in _INT_FIELDS:
            kw[name] = _tensor(v, torch.int32, device)
        elif name == "joint_limited":
            kw[name] = _tensor(v, torch.bool, device)
        else:
            kw[name] = _tensor(v, torch.float32, device)
    return RobotSpec(**kw)


def world_from_numpy(fields: Mapping, device="cpu") -> AnalyticWorld:
    """AnalyticWorld from the JAX AnalyticWorld's fields (a leading row
    axis, one world per scenario, is kept)."""
    return AnalyticWorld(**{
        name: _tensor(fields[name], torch.float32, device)
        for name in AnalyticWorld.__dataclass_fields__})


def grid_from_numpy(fields: Mapping, device="cpu") -> GridSDF:
    """GridSDF from the JAX GridSDF's fields (packed may be None)."""
    packed = fields.get("packed")
    return GridSDF(
        grid=_tensor(fields["grid"], torch.float32, device),
        origin=_tensor(fields["origin"], torch.float32, device),
        resolution=_tensor(fields["resolution"], torch.float32, device),
        packed=None if packed is None else _tensor(packed, torch.float32,
                                                   device))


def composite_from_numpy(grid_fields: Mapping, overlay_fields: Mapping,
                         device="cpu") -> CompositeWorld:
    """CompositeWorld from the fields of the JAX CompositeWorld's grid and
    overlay (the overlay's row axis, if any, is kept)."""
    return CompositeWorld(grid=grid_from_numpy(grid_fields, device),
                          overlay=world_from_numpy(overlay_fields, device))


def ops_from_numpy(fields: Mapping, device="cpu") -> DeviceOps:
    """DeviceOps from the JAX DeviceOps' fields (cov_scale kept a float)."""
    kw = {name: _tensor(fields[name], torch.float32, device)
          for name in DeviceOps.__dataclass_fields__ if name != "cov_scale"}
    return DeviceOps(cov_scale=float(fields["cov_scale"]), **kw)


_MPC_DTYPES = {"steps": torch.int32, "reached_tick": torch.int32,
               "collided": torch.bool}


def mpc_state_from_numpy(fields: Mapping, device="cpu") -> MPCState:
    """MPCState from the JAX MPCState's fields (its PRNG key is dropped: the
    port takes noise as an argument)."""
    return MPCState(**{
        name: _tensor(fields[name], _MPC_DTYPES.get(name, torch.float32),
                      device)
        for name in MPCState.__dataclass_fields__})

"""CHOMP's functional gradient ∇U in one kernel (``csrc/chomp_grad.cu``).

From θ ``[B, N, d]``, Q0 and QN ``[B, d]``, the shared world and the
smoothness term S = R θ + R_bias [q0; qN] ``[B, N, d]`` (costs/smoothness.py
``smoothness_gradient``, a matrix product outside the kernel) it writes

    w_obstacle · ∇q_obs + w_smoothness · S    [B, N, d]

with ∇q_obs engine/chomp.py ``obstacle_functional_gradient`` (A.11) of the
full trajectory (Q0, θ, QN): the point Jacobians, the SDF gradient, the
curvature term and the damped pseudo-inverse, summed over the bodies, for
the interior waypoints. That plain PyTorch is the kernel's specification
and the CPU's route; engine/chomp.py ``chomp_gradient`` chooses between
them. :func:`functional_gradient` takes CUDA tensors and raises on
anything else. The world may be an AnalyticWorld, a GridSDF (dense or
packed) or a CompositeWorld, shared by every row, as world/sdf.py
``sdf_grad`` takes them.

The library is built by nvcc from the checkout at first use, one per joint
chain as the evaluators' (kernels/rollout.py ``build``, ``chain_of``) and
per world kind and primitive counts (:func:`_definitions`), with a plain C
interface called through ctypes; the robot and the world travel as the
evaluators' parameters (kernels/rollout.py ``_launch_params``), and a
launch captured in a CUDA graph is recorded for engine/graph.py's
parameter rewrites (kernels/graph_node.py) as theirs is.

``LAUNCHES`` counts the kernel's launches, ``chomp_grad`` on a robot's
static chain and ``chomp_grad:runtime`` on the runtime chain
(engine/graph.py moves a capture's count to the graph's replays;
``rollout.reset_launches()`` zeroes it with the others).
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpustomp_torch.kernels import graph_node, rollout
from tpustomp_torch.world.sdf import (AnalyticWorld, CompositeWorld, GridSDF,
                                      grid_clip_hi, world_rows)

LAUNCHES = {"chomp_grad": 0, "chomp_grad:runtime": 0}

# csrc/chomp_grad.cu kRuntimeJoints: the runtime chain's most joints
_RUNTIME_JOINTS = 32
# csrc/chomp_grad.cu kAnalyticFloats, kOverlayFloats: a world's primitives
# (4 floats a sphere, 6 a box) within these are compiled in
_ANALYTIC_FLOATS, _OVERLAY_FLOATS = 16, 4
_WORLD_KINDS = {AnalyticWorld: 0, GridSDF: 1, CompositeWorld: 2}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# chomp_grad_launch: theta, q0, qn, smooth, out; their strides; params,
# n_params, host_params; the grid; B, N, d, nb, ns, nx, skip_rotf; the
# nine float32 constants; curvature, pinv; stream, resident
_ARGTYPES = ([_P] * 5 + [_L] * 7 + [_P, _I, _I]
             + [_P, _P, _I, _I, _I, _F, _F, _F, _I] + [_I] * 7 + [_F] * 9
             + [_I, _I, _P, _P])
_TYPED: set = set()       # ids of the libraries whose entry is typed
_LOADED: set = set()      # load()'s keys of the kernels loaded


def _definitions(world) -> tuple[str, ...]:
    """nvcc's definitions of the library that takes `world`: its kind
    (CHOMP_GRAD_GRID, 0 for an AnalyticWorld, 1 for a GridSDF or a
    CompositeWorld) and its sphere and box counts (CHOMP_GRAD_NS, _NX)
    where they fit the kernel's budget, else -1 (read at run time)."""
    grid, prims = rollout._world_parts(world)
    ns = 0 if prims is None else prims.sphere_radius.shape[-1]
    nx = 0 if prims is None else prims.box_half.shape[-2]
    fits = _ANALYTIC_FLOATS if grid is None else _OVERLAY_FLOATS
    if 4 * ns + 6 * nx > fits:
        ns = nx = -1
    return (f"-DCHOMP_GRAD_GRID={int(grid is not None)}",
            f"-DCHOMP_GRAD_NS={ns}", f"-DCHOMP_GRAD_NX={nx}")


def _library(chain, world) -> ctypes.CDLL:
    lib = rollout.build(("chomp_grad",), (chain,), _definitions(world))[
        ("chomp_grad", chain)]
    if id(lib) not in _TYPED:
        _TYPED.add(id(lib))
        lib.chomp_grad_launch.argtypes = _ARGTYPES
        lib.chomp_grad_launch.restype = ctypes.c_int
    return lib


def _checked(robot, world, theta, q0, qN, smooth) -> int:
    """The world's kind for the kernel (0 analytic, 1 grid, 2 composite);
    raises on a world, device, dtype or shape the kernel does not take."""
    kind = _WORLD_KINDS.get(type(world))
    if kind is None:
        raise NotImplementedError(
            f"{type(world).__name__}: the functional gradient takes "
            "AnalyticWorld, GridSDF or CompositeWorld")
    if world_rows(world) is not None:
        raise NotImplementedError("the functional gradient takes a world "
                                  "shared by every row, not one with a row "
                                  "axis")
    grid, prims = rollout._world_parts(world)
    if theta.dim() != 3:
        raise ValueError(f"theta must be [B, N, d], got "
                         f"{tuple(theta.shape)}")
    B, N, d = theta.shape
    if d != robot.num_joints:
        raise ValueError(f"theta has {d} joints, the robot "
                         f"{robot.num_joints}")
    if rollout.chain_of(robot) is None and d > _RUNTIME_JOINTS:
        raise ValueError(f"a robot of {d} joints without a static chain: "
                         f"the runtime chain takes {_RUNTIME_JOINTS}")
    shapes = dict(theta=(B, N, d), q0=(B, d), qN=(B, d), smooth=(B, N, d))
    given = dict(theta=theta, q0=q0, qN=qN, smooth=smooth)
    dev = theta.device
    for name, t in given.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, theta on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("robot", robot.joint_axis),
                    ("grid", None if grid is None else grid.grid),
                    ("world", None if prims is None else prims.box_half)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} tensors are on {t.device}, theta on "
                             f"{dev}")
    if B * (N + 2) + 64 >= 2**31:
        raise ValueError(f"{B} x {N + 2} waypoints: the kernel indexes "
                         "them with 32-bit ints")
    return kind


def _constants(dt, clearance, pinv_ridge, w_obstacle, w_smoothness):
    """The plain version's float32 constants, in the entry's order: dt,
    2·dt, clearance, 0.5·clearance, the potential's denominators
    (costs/obstacle.py: clearance and 2·clearance, 1 where it is not
    positive), the ridge and the two weights (Python floats, each the
    float32 torch rounds the scalar to)."""
    eps = float(clearance)
    vals = (dt, 2.0 * dt, eps, 0.5 * eps, eps if eps > 0.0 else 1.0,
            2.0 * eps if eps > 0.0 else 1.0, pinv_ridge, w_obstacle,
            w_smoothness)
    return tuple(float(np.float32(v)) for v in vals)


def _entry(robot, world, kind, theta, q0, qN, smooth, out, consts,
           use_curvature, use_pseudo_inverse, resident=None):
    """One call of the library's entry: a launch, or with `resident` (a
    ctypes int) the occupancy query that loads the kernel a launch would
    take. Returns (route, params, chain) of the launch."""
    grid, prims = rollout._world_parts(world)
    chain = rollout.chain_of(robot)
    dev = theta.device
    if resident is None:
        route, params = rollout._launch_params(robot, world, True)
    else:
        # as rollout_occupancy: the route from shapes, zeros for the set
        route = rollout.param_route(robot, world, True)
        params = np.zeros(rollout._param_floats(robot, world, True),
                          np.float32)
    ptr = (params.data_ptr() if isinstance(params, torch.Tensor)
           else params.ctypes.data)
    B, N, d = theta.shape
    ns = 0 if prims is None else prims.sphere_radius.shape[-1]
    nx = 0 if prims is None else prims.box_half.shape[-2]
    grid_args = (None, None, 0, 0, 0, 0.0, 0.0, 0.0)
    if grid is not None:
        g = grid.grid.to(torch.float32).contiguous()
        if g.numel() >= 2**31:
            raise ValueError(f"grid of {g.numel()} voxels: the kernel "
                             "indexes it with 32-bit ints")
        packed = rollout._packed_table(grid, g)
        grid_args = (g.data_ptr(),
                     None if packed is None else packed.data_ptr(),
                     *g.shape, *map(float, grid_clip_hi(g.shape)))
    lib = _library(chain, world)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chomp_grad_launch(
            theta.data_ptr(), q0.data_ptr(), qN.data_ptr(),
            smooth.data_ptr(), None if out is None else out.data_ptr(),
            *theta.stride(), *q0.stride(), *qN.stride(), ptr, len(params),
            int(route != "memory"), *grid_args, kind, B, N, d,
            robot.num_bodies, ns, nx, int(bool(robot.rot_fixed_identity)),
            *consts, int(bool(use_curvature)), int(bool(use_pseudo_inverse)),
            stream, None if resident is None else ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"chomp_grad kernel launch failed: CUDA error "
                           f"{err}")
    return route, params, chain


def functional_gradient(robot, world, theta, q0, qN, smooth, dt, clearance,
                        w_obstacle, w_smoothness, use_curvature=True,
                        use_pseudo_inverse=False, pinv_ridge=1e-4):
    """w_obstacle · ∇q_obs + w_smoothness · smooth [B, N, d] by the kernel,
    on CUDA tensors; raises on what it does not take, CPU tensors among
    them (engine/chomp.py takes the plain route there)."""
    kind = _checked(robot, world, theta, q0, qN, smooth)
    if theta.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got "
                         f"{theta.device}")
    out = torch.empty(theta.shape, dtype=torch.float32, device=theta.device)
    route, params, chain = _entry(
        robot, world, kind, theta, q0, qN, smooth.contiguous(), out,
        _constants(dt, clearance, pinv_ridge, w_obstacle, w_smoothness),
        use_curvature, use_pseudo_inverse)
    if route != "memory" and rollout._capturing():
        # the node's block, rewritten when the graph's world takes new
        # values (engine/graph.py)
        graph_node.record(torch.cuda.current_stream(theta.device), route,
                          params, (robot, world, True, ()))
    LAUNCHES["chomp_grad" + ("" if chain is not None else ":runtime")] += 1
    return out


def occupancy(robot, world, theta) -> int:
    """Resident blocks per SM of the kernel :func:`functional_gradient`
    takes for these CUDA arguments (on :func:`rollout.param_route`'s
    route); builds the library and loads the kernel, outside any capture,
    and launches nothing. What the solver calls when it builds a CHOMP
    step on the card (:func:`load`), and chip_smoke.py's reading."""
    kind = _checked(robot, world, theta, theta[:, 0], theta[:, 0], theta)
    resident = ctypes.c_int(0)
    _entry(robot, world, kind, theta, theta[:, 0], theta[:, 0], theta, None,
           _constants(1.0, 0.0, 0.0, 0.0, 0.0), True, True, resident)
    return resident.value


def load(robot, world, theta) -> None:
    """Build the library of the robot's chain and the world's kind and
    counts, and load the kernel the launches on these arguments take,
    outside any capture (a module loaded lazily inside one is not
    allowed): once per device, chain, world kind, primitive counts and
    parameter route. The library of the evaluator the step also launches
    is built at the same time."""
    grid, _ = rollout._world_parts(world)
    chain = rollout.chain_of(robot)
    key = (theta.device.index, chain, type(world), _definitions(world),
           rollout.param_route(robot, world, True))
    if key not in _LOADED:
        # the step's evaluator (K3 or K5 at C = B) is built beside it: the
        # two nvcc jobs run at once on a checkout's first solve
        evaluator = "rollout_analytic" if grid is None else "rollout_grid"
        with ThreadPoolExecutor(1) as pool:
            job = pool.submit(rollout.build, ("chomp_grad",), (chain,),
                              key[3])
            rollout.build((evaluator,), (chain,))
            job.result()
        occupancy(robot, world, theta)
        _LOADED.add(key)

"""Fused rollout evaluators: FK → sphere bodies → SDF → potential × workspace
speed → per-waypoint cost rows, one CUDA kernel per world kind.

Port of the evaluation kernels of ``tpustomp/kernels/rollout_pallas.py`` and
of the contract of their wrapper ``obstacle_cost_batch_pallas``:

- ``rollout_analytic`` (``csrc/rollout_analytic.cu``), for `AnalyticWorld`:
  K3 (pallas_call :741); K4 (:755, the candidate-major [C, T, d] input,
  which the kernel stages itself: no copy runs before it); K1 (:257, robots
  with ``body_counts=None``, whose bodies are stable-sorted by link here).
  Its variant ``rollout_analytic:per_cand_world`` is K3 with
  ``per_cand_world=True``: one set of spheres/boxes per row of candidates.
- ``rollout_grid`` (``csrc/rollout_grid.cu``), for `GridSDF` and
  `CompositeWorld`: K5 (:770) together with its XLA tail ``_grid_finish``,
  as one kernel; K2 (:325), sorted as for K1. Its variant
  ``rollout_grid:per_cand_overlay`` takes a composite whose overlay has one
  set of spheres/boxes per row (``_grid_finish``'s per_cand branch).

Worlds with a row axis (world/sdf.py ``world_rows``; batched MPC's
per-scenario worlds) come in a grouped form: R rows and ``cands_per_row``,
candidate c reading row c // cands_per_row. The JAX package's
per-candidate contract is the grouped form with cands_per_row = 1; the
solver passes rows of scenarios with cands_per_row = candidates per
scenario, and nothing is repeated per candidate.

Both kernels are hand-written CUDA C++ for sm_90a around one shared skeleton
(``csrc/rollout_common.cuh``; each file's header says what bounds it and
how the design answers that): a block holds a few candidates' joint tile,
and its warps walk windows of 30 owned (candidate, waypoint) pairs laid end
to end over the active candidates, a halo lane on either side (the lane
plan is :func:`_plan`); the robot and a shared world travel in a kernel
parameter block filled on the host, read as constant-bank operands: the
3 KB block, or the 31 KB large block for a set above it (both with the
world's counts compiled in; :func:`param_route`), filled from the
tensors' host copies (:func:`_host_params`) or, for a set without them (built on the card,
changed in place), from one read of :func:`pack_params`'s device vector
per set of tensors and versions at the set's second launch
(:func:`_launch_params`; a write that bumps no version counter is not
seen). Tensors moved under ``torch.inference_mode()`` (no version
counter), sets above the large block and the first launch of a set
without host copies take the memory path (:func:`pack_params` on the
device, staged in shared memory). Each route is an instantiation of the same kernel
(``PARAM_ROUTES`` counts them); a grid with a packed corner table is read
through it.
Each source is compiled with nvcc into a
shared library with a plain C interface at first use, into
``tpustomp_torch/_build/``, and called through ctypes.

Every variant has an ``:ee`` form (K3 with ``ee_out=True``): the same
launch with an end-effector frame output ``ee [12, T, C]`` (rows 0-2 the
last joint's position, 3-11 its rotation, row-major; zeros on inactive
rows), from which costs/constraints.py ``constraint_cost_tm`` computes
Cartesian constraints' cost. Every variant also has a ``:con`` form, the
constraint route the solver takes: the same launch with the constraints'
parameters appended to its parameters (:func:`pack_params`) and that cost,
``q_con [C, T]``, computed on the frame in registers and written as one
plane instead of the frame's twelve. Asking for either changes neither
q_obs nor margin.

The joint chain (the TPU kernels' ``static_joints``, :355, :372-391,
:536-571). A robot with ``joint_static`` and ``body_counts`` runs its static
chain: the same sources built with the robot compiled in
(``-DROLLOUT_CHAIN``, :func:`chain_of`), one library per source and robot,
built at the robot's first launch. Any other robot (``joint_static=None``,
or ``body_counts=None``: K1/K2) runs the runtime chain, the build without
the definition. Both are hand-written kernels; the choice is the robot's,
as on the TPU (:944-945), never a fallback.

- :func:`obstacle_cost_batch_plain` is the plain PyTorch version
  (costs/obstacle.py, robot/fk.py ``fk_frames``) the kernels are held to.
- :func:`obstacle_cost_batch` takes the plain version only for tensors on
  the CPU. For CUDA tensors it launches a kernel, or raises; it never falls
  back. ``LAUNCHES`` counts each kernel variant's launches: ``<variant>`` on
  the static chain, ``<variant>:runtime`` on the runtime chain, each with
  its ``:ee`` and its ``:con`` form.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpustomp_torch._tensors import host_mirror
from tpustomp_torch.costs.constraints import (OrientationConstraint, as_tuple,
                                              constraint_cost_tm)
from tpustomp_torch.costs.obstacle import obstacle_cost
from tpustomp_torch.robot.fk import fk_frames
from tpustomp_torch.world.sdf import (AnalyticWorld, CompositeWorld, GridSDF,
                                      grid_clip_hi, world_rows)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (cand, params, n_params, host_params): the arguments every entry point
# starts with; params is a host pointer when host_params is 1
_HEAD = [_P, _P, _I, _I]
# (active, q_obs, margin_part, ee, q_con, C, T, d, nb, ns, nx, n_con, dt,
#  clearance, skip_rotf, cpb, n_slab, cand_major, stream, resident): the
# arguments every entry point ends with; cand_major is 1 for a [C, T, d]
# cand; resident is null on a launch (rollout_occupancy: an int the call
# fills instead of launching)
_TAIL = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
         _I, _P, _P]
_GRID = [_P, _P, _I, _I, _I, _F, _F, _F]      # grid, packed, X, Y, Z, hi[3]
_ROWS = [_P, _P, _I]                          # spheres, boxes, cands_per_row
# kernel variant -> (source in csrc/, C entry point, its argument types)
_ENTRIES = {
    "rollout_analytic": (
        "rollout_analytic", "rollout_analytic_launch", _HEAD + _TAIL),
    "rollout_analytic:per_cand_world": (
        "rollout_analytic", "rollout_analytic_rows_launch",
        _HEAD + _ROWS + _TAIL),
    "rollout_grid": (
        "rollout_grid", "rollout_grid_launch", _HEAD + _GRID + [_I] + _TAIL),
    "rollout_grid:per_cand_overlay": (
        "rollout_grid", "rollout_grid_rows_launch",
        _HEAD + _GRID + _ROWS + _TAIL),
}
_SOURCES = ("rollout_analytic", "rollout_grid")

# Kernel launches per kernel variant since import (or reset_launches()):
# "<variant>" on a robot's static chain, "<variant>:runtime" on the runtime
# chain; a launch that also writes the end-effector frame adds ":ee", one
# that writes the constraints' cost (the constraint route) ":con".
LAUNCHES = {name + chain + form: 0 for name in _ENTRIES
            for chain in ("", ":runtime") for form in ("", ":ee", ":con")}
# Launches by where their parameters lived (:func:`param_route`): "block",
# the 3 KB kernel parameter block filled on the host; "large_block", the
# 31 KB one, for a set above _PARAM_FLOATS; or "memory", staged from device
# memory (tensors moved under torch.inference_mode(), or a set above
# _LARGE_PARAM_FLOATS); reset with LAUNCHES.
PARAM_ROUTES = {"block": 0, "large_block": 0, "memory": 0}
# Reads of a device-packed parameter vector into a block (a set without
# host copies, at its second launch: one per set of tensors and versions),
# and "deferred": launches of such a set on the memory path that made no
# read (its first, or one under a CUDA graph capture); reset with LAUNCHES.
PARAM_READS = {"device": 0, "deferred": 0}
# Launches by the layout the candidates came in: "time_major" ([d, T, C])
# or "candidate_major" ([C, T, d], the TPU's K4, which the solver's
# _evaluate takes; the kernel stages either layout); reset with LAUNCHES.
LAYOUTS = {"time_major": 0, "candidate_major": 0}
# Launches by the robot's body order: "sorted" (body_counts: link-sorted
# bodies) or "unsorted" (body_counts=None, the TPU's K1 / K2: the bodies
# are sorted by link in pack_params); reset with LAUNCHES.
BODY_ORDER = {"sorted": 0, "unsorted": 0}
# Seconds of each library's first build in this process, by (source, chain).
BUILD_SECONDS: dict[tuple, float] = {}

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# The lane plan (csrc/rollout_common.cuh kWarp, kWarps, kCore, kMaxCands,
# kRowFloats): warps of 32 lanes, 8 a block, windows of 30 owned lanes, at
# most 16 candidates a block, a staged per-row world of at most 16 floats;
# the parameter block's capacity (kParamFloats) and the large block's
# (kLargeParamFloats).
_WARP = 32
_WARPS = 8
_CORE = _WARP - 2
_MAX_CANDS = 16
_ROW_FLOATS = 16
_PARAM_FLOATS = 768
_LARGE_PARAM_FLOATS = 7936
# A constraint in the parameters' constraint section (kConFloats)
_CON_FLOATS = 9
# Resident blocks per SM the plan counts on (csrc/rollout_common.cuh
# kernel_min_blocks of the main instantiations): a batch that would fill
# fewer than this many blocks on every SM takes fewer candidates a block,
# so that its warps stay about one window deep (B = 1 keeps its latency).
_FILL_PER_SM = 4
# SMs of an H100 SXM: the plan's default when no device is named
_SMS = 132
# Shared memory a block may take, in floats: 32 KB, so that four blocks an
# SM leave L1 to the grid's gathers (a 51 KB block made the dense grid 1.3x
# slower; the constraint route's one extra plane fits it: 30 KB at T = 102);
# with the ee frame 72 KB, three blocks an SM, which holds 8 candidates a
# block at T = 102 (69 KB) and 9 at T = 52 (40 KB).
_SMEM_BUDGET = 32 * 1024 // 4
_SMEM_BUDGET_EE = 72 * 1024 // 4
# With the ee frame a block takes at least this many candidates where the
# batch allows: the frame's 12 output planes then go out in rows of whole or
# mostly whole 32-byte sectors (at T = 102, 7 candidates' 28-byte rows made
# K3:ee 1.3-1.4x slower than 8; at T = 52, 9 beat 8 by 3-8 %).
_MIN_CANDS_EE = 8

# A static chain's axis component other than exactly 0, +1 or -1
# (csrc/rollout_common.cuh kOther): read from the parameters at run time.
_OTHER = 2

_libs: dict[tuple, ctypes.CDLL] = {}
# _launch_params's cache of host vectors (at most 64 entries): key ->
# (weak references to the tensors, their versions, (route, numpy vector),
# or None for a set without host copies launched once, not read yet)
_LAUNCH_PARAMS: dict[tuple, tuple] = {}


def reset_launches() -> None:
    """Every kernel counter to 0: these, the propose kernel's, the CHOMP
    gradient kernel's and PI²'s tail's (kernels/propose.py,
    kernels/chomp_grad.py, kernels/pi2.py, which import this module)."""
    from tpustomp_torch.kernels import chomp_grad, pi2, propose
    for counts in (LAUNCHES, PARAM_ROUTES, PARAM_READS, LAYOUTS,
                   BODY_ORDER, propose.LAUNCHES, chomp_grad.LAUNCHES,
                   pi2.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME): the rollout kernels "
                       "are compiled from source at first use")


def _sources(name: str) -> list[Path]:
    """The kernel's .cu file and every csrc file it includes, transitively."""
    todo, seen = [_CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return seen


def chain_of(robot) -> tuple[int, ...] | None:
    """The static chain the kernels compile in for `robot`: (skip_rotf,
    then per joint type, ax, ay, az, n_bodies), each axis component coded
    0, +1, -1 or 2 (any other value, read at run time) — the codes the
    reference's _cmul folds (rollout_pallas.py:506-571). None (the runtime
    chain) for a robot without joint_static or body_counts, as the TPU
    kernel's static_joints (:944-945, :961, :1000, :1040, :1056)."""
    static, counts = robot.joint_static, robot.body_counts
    if static is None or counts is None:
        return None
    if len(static) != len(counts):
        raise ValueError(f"joint_static has {len(static)} joints, "
                         f"body_counts {len(counts)}")

    def code(a):
        return int(a) if a in (0.0, 1.0, -1.0) else _OTHER

    out = [int(bool(robot.rot_fixed_identity))]
    for (jtype, ax, ay, az), n in zip(static, counts):
        out += [int(jtype != 0), code(ax), code(ay), code(az), int(n)]
    return tuple(out)


def chain_definition(chain) -> str:
    """The chain as nvcc's definition: one identifier, since nvcc splits a
    value at commas: ``-DROLLOUT_CHAIN=chain_1_0_0_n1_...`` (n: minus),
    which csrc/rollout_common.cuh reads back."""
    return "-DROLLOUT_CHAIN=chain" + "".join(
        f"_{'n' if c < 0 else ''}{abs(c)}" for c in chain)


def _nvcc_flags(chain, defines=()) -> tuple[str, ...]:
    """nvcc's flags for a library of `chain` (None: the runtime chain),
    with `defines` ("-DNAME=value" strings) after them."""
    if chain is None:
        return _NVCC_FLAGS + tuple(defines)
    return _NVCC_FLAGS + (chain_definition(chain),) + tuple(defines)


def _lib_path(name: str, chain=None, defines=()) -> Path:
    """The library's name carries a hash of the flags (the chain's
    definition and `defines` among them) and of every source it is built
    from, so an edited source or header is never served by a stale
    build."""
    h = hashlib.sha256(" ".join(_nvcc_flags(chain, defines)).encode())
    for src in _sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_job(nvcc, name, chain, defines, out):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *_nvcc_flags(chain, defines), "-o", out,
         str(_CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build(names=_SOURCES, chains=(None,),
          defines=()) -> dict[tuple, ctypes.CDLL]:
    """Compile (once per version of the sources, chain and definitions)
    and load the named kernel libraries (sources in csrc/) for each chain
    (None: the runtime chain; else a :func:`chain_of` tuple), each built
    with `defines` ("-DNAME=value" strings) as well. Missing builds run at
    the same time, one nvcc each; their seconds go to BUILD_SECONDS, by
    (name, chain), with the definitions appended where there are any.
    Returns {(name, chain): library}."""
    defines = tuple(defines)
    keys = [(n, c) for c in chains for n in names]
    missing = [k for k in keys if (*k, defines) not in _libs
               and not _lib_path(*k, defines).exists()]
    if missing:
        nvcc = _nvcc()
        _BUILD_DIR.mkdir(exist_ok=True)
        tmps = []
        try:
            for _ in missing:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                tmps.append(tmp)
            with ThreadPoolExecutor(len(missing)) as pool:
                jobs = [pool.submit(_nvcc_job, nvcc, n, c, defines, tmp)
                        for (n, c), tmp in zip(missing, tmps)]
                done = [job.result() for job in jobs]
            errors = []
            for (n, c), tmp, (proc, seconds) in zip(missing, tmps, done):
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {n}.cu, chain {c} "
                                  f"({proc.returncode}):\n{proc.stdout}\n"
                                  f"{proc.stderr}")
                else:
                    BUILD_SECONDS[(n, c) + ((defines,) if defines
                                            else ())] = seconds
                    os.replace(tmp, _lib_path(n, c, defines))  # atomic
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for tmp in tmps:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    for n, c in keys:
        if (n, c, defines) not in _libs:
            lib = ctypes.CDLL(str(_lib_path(n, c, defines)))
            for source, entry, argtypes in _ENTRIES.values():
                if source == n:
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[(n, c, defines)] = lib
    return {k: _libs[(*k, defines)] for k in keys}


def _world_parts(world):
    """(grid, primitives) of a world: the GridSDF or None, and the
    AnalyticWorld of spheres/boxes (the overlay of a composite) or None.
    Raises on a world kind the evaluators do not take, or a grid with a
    dimension below 2."""
    if isinstance(world, AnalyticWorld):
        return None, world
    if isinstance(world, GridSDF):
        grid, prims = world, None
    elif isinstance(world, CompositeWorld):
        grid, prims = world.grid, world.overlay
    else:
        raise NotImplementedError(
            f"{type(world).__name__}: the evaluators take AnalyticWorld, "
            "GridSDF or CompositeWorld")
    if grid.grid.dim() != 3 or min(grid.grid.shape) < 2:
        raise ValueError(f"a grid must be [X, Y, Z] with every dimension "
                         f">= 2, got {tuple(grid.grid.shape)}")
    return grid, prims


def pack_params(robot, world, constraints=()) -> torch.Tensor:
    """Robot + world parameters as the kernels' packed float32 vector (layout
    in the header of csrc/rollout_common.cuh), on the robot's device: the
    memory path's parameters, and what a set without host copies reads to
    the host once for the parameter block (:func:`_launch_params`;
    :func:`_host_params` runs it on the host copies). A world with a row axis
    contributes only its grid's origin and resolution: its primitives go to
    the kernel as their own arrays (_prim_arrays). `constraints` (a tuple,
    as costs/constraints.py as_tuple) append the constraint route's
    section, _CON_FLOATS each."""
    d = robot.num_joints
    dev = robot.joint_axis.device
    f32 = torch.float32
    offset, radius = robot.body_offset, robot.body_radius
    if robot.body_counts is not None and dev.type == "cpu":
        # bodies link-sorted (RobotSpec's _spec): the runs from the tuple
        body_start = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(robot.body_counts)]).astype(np.float32))
    else:
        # on the card the runs' starts come from a search of fixed output
        # shape (no read-back, and no copy from the host, which a captured
        # graph could not hold); bodies in any order are stable-sorted by
        # link on the device first, so the kernel walks one contiguous run
        # per joint (costs are sums and mins over bodies; only the float
        # summation order moves)
        link = robot.body_link.long()
        if robot.body_counts is None:
            link, order = torch.sort(link, stable=True)
            offset, radius = offset[order], radius[order]
        body_start = torch.searchsorted(
            link, torch.arange(d + 1, device=dev)).to(f32)
    joints = torch.cat([
        robot.joint_type.to(f32)[:, None], robot.joint_axis.to(f32),
        robot.joint_offset.to(f32), robot.joint_rot.to(f32).reshape(d, 9)],
        dim=1)                                                  # [d, 16]
    parts = [
        robot.base_rot.to(f32).reshape(9), robot.base_pos.to(f32),
        joints.reshape(-1),
        body_start,
        torch.cat([offset.to(f32), radius.to(f32)[:, None]],
                  dim=1).reshape(-1)]
    grid, prims = _world_parts(world)
    if prims is not None and world_rows(world) is None:
        parts += [x.reshape(-1) for x in _prim_arrays(prims)]
    if grid is not None:
        parts += [grid.origin.to(f32).reshape(3),
                  grid.resolution.to(f32).reshape(1)]
    for c in constraints:
        orient = isinstance(c, OrientationConstraint)
        parts += [torch.full((1,), 0.0 if orient else 1.0, dtype=f32,
                             device=dev),
                  (c.axis_local if orient else robot.ee_offset).to(
                      f32).reshape(3),
                  c.target_world.to(f32).reshape(3),
                  c.tolerance.to(f32).reshape(1), c.weight.to(f32).reshape(1)]
    return torch.cat(parts).contiguous()


def _slab(T: int, n_slab: int, s: int):
    """Slab s of the waypoint axis (csrc/rollout_common.cuh Slab): owned
    [t_lo, t_hi) and its rows [a, a + n_seq), the halo waypoints t_lo - 1
    and t_hi where they exist."""
    L = -(-T // n_slab)
    t_lo = s * L
    t_hi = min(t_lo + L, T)
    a = max(t_lo - 1, 0)
    return t_lo, t_hi, a, min(t_hi + 1, T) - a


def _smem_floats(staged: int, d: int, cpb: int, T: int, n_slab: int,
                 ee: bool, con: bool = False) -> int:
    """A block's shared memory in floats (csrc/rollout_common.cuh
    smem_floats): staged parameters, the joint tile of the largest slab,
    the cost and margin rows, the staged per-row worlds, the slots, the ee
    frame, the constraint route's q_con rows."""
    L = -(-T // n_slab)
    n_seq = T if n_slab == 1 else min(L + 2, T)
    return (((staged + 31) & ~31) + d * cpb * n_seq
            + (2 + (12 if ee else 0) + (1 if con else 0)) * cpb * (L | 1)
            + _MAX_CANDS * _ROW_FLOATS + _MAX_CANDS + 2)


def _slots(cpb: int, T: int, n_slab: int) -> int:
    """Lane slots a block of cpb active candidates holds over its rounds:
    each round is one window on each of the block's warps, and a warp idle
    in the last round still holds its registers."""
    total = 0
    for s in range(n_slab):
        windows = -(-cpb * _slab(T, n_slab, s)[3] // _CORE)
        total += -(-windows // _WARPS) * _WARPS * _WARP
    return total


def _plan(C: int, T: int, d: int, ee: bool = False, staged: int = 0,
          sms: int = _SMS, con: bool = False) -> tuple[int, int]:
    """The kernels' lane plan: (cpb, n_slab). A block holds cpb consecutive
    candidates and one of n_slab slabs of the waypoint axis; grid
    (ceil(C / cpb), n_slab). n_slab is 1 unless one candidate's tile would
    pass the shared-memory budget (long trajectories). Without ee, cpb is
    the count up to _MAX_CANDS whose windows fill the block's warps best
    (fewest lane slots per owned waypoint, :func:`_slots`; the larger on a
    tie), among the counts whose shared memory fits the budget and, unless
    there are none, that leave at least _FILL_PER_SM blocks on each of the
    card's `sms` SMs (a small batch takes fewer candidates a block, so its
    warps stay about one window deep); with ee, among those of at least
    _MIN_CANDS_EE where there are any. `staged`: parameters staged in
    shared memory (the memory path), on top of the budget: the memory path
    now holds the sets above the large block, whose staged parameters alone
    pass it. The constraint route (`con`: one more staged plane) plans as
    without ee."""
    budget = ((_SMEM_BUDGET_EE if ee else _SMEM_BUDGET)
              + ((staged + 31) & ~31))
    n_slab, n = 1, 1
    while (n_slab < T
           and _smem_floats(staged, d, 1, T, n_slab, ee, con) > budget):
        n += 1
        n_slab = -(-T // -(-T // n))      # slabs of ceil(T / n), none empty
    fits = [c for c in range(1, _MAX_CANDS + 1)
            if _smem_floats(staged, d, c, T, n_slab, ee, con) <= budget]
    fill = [c for c in fits if -(-C // c) >= _FILL_PER_SM * sms] or [1]
    if ee:
        fill = [c for c in fill if c >= _MIN_CANDS_EE] or fill
    cpb = min(fill, key=lambda c: (_slots(c, T, n_slab) / (c * T), -c))
    return cpb, n_slab


def _param_set(robot, world, shared: bool, constraints=()):
    """(parts, tensors, key): the objects and tensor fields
    :func:`pack_params` reads values from, {name: (object, [field names])}
    (the robot, a shared world's primitives (`shared`), a grid's origin and
    resolution, each constraint), those tensors, and the caches' key for
    them (their ids and what else decides the vector's layout)."""
    grid, prims = _world_parts(world)
    names = ["base_rot", "base_pos", "joint_type", "joint_axis",
             "joint_offset", "joint_rot", "body_offset", "body_radius"]
    if robot.body_counts is None:
        names.append("body_link")
    orient = tuple(isinstance(c, OrientationConstraint) for c in constraints)
    if not all(orient):
        names.append("ee_offset")       # the position constraints' tool point
    parts = {"robot": (robot, names)}
    if shared and prims is not None:
        parts["prims"] = (prims, ["sphere_center", "sphere_radius",
                                  "box_center", "box_half"])
    if grid is not None:
        parts["grid"] = (grid, ["origin", "resolution"])
    for i, (c, o) in enumerate(zip(constraints, orient)):
        parts[f"con{i}"] = (c, ["axis_local"] * o + [
            "target_world", "tolerance", "weight"])
    tensors = [getattr(obj, n) for obj, fields in parts.values()
               for n in fields]
    key = (robot.body_counts, shared, grid is not None, prims is not None,
           orient) + tuple(id(t) for t in tensors)
    return parts, tensors, key


def _param_floats(robot, world, shared: bool, n_con: int = 0) -> int:
    """The length of :func:`pack_params`'s vector, from shapes alone (no
    device value is read): the robot's 12 + 17 d + 1 + 4 nb, a shared
    world's 4 a sphere and 6 a box, a grid's 4, _CON_FLOATS a
    constraint."""
    d, nb = robot.num_joints, robot.num_bodies
    n = 12 + 17 * d + 1 + 4 * nb
    grid, prims = _world_parts(world)
    if shared and prims is not None:
        n += (4 * prims.sphere_radius.shape[-1]
              + 6 * prims.box_half.shape[-2])
    return n + (4 if grid is not None else 0) + _CON_FLOATS * n_con


def _route(n_params: int, inference: bool) -> str:
    return ("memory" if inference
            else "block" if n_params <= _PARAM_FLOATS
            else "large_block" if n_params <= _LARGE_PARAM_FLOATS
            else "memory")


def param_route(robot, world, shared: bool = True, constraints=()) -> str:
    """Where a launch's parameters live, decided from shapes and tensor
    kinds alone (no device value is read; CPU tests call it on the "meta"
    device): "block", the 3 KB kernel parameter block, for a set of at most
    _PARAM_FLOATS floats; "large_block", the 31 KB one, up to
    _LARGE_PARAM_FLOATS (a robot of about 150 bodies or more, a shared
    world of about 100 boxes or 150 spheres); "memory" (staged in shared
    memory from device memory) above that, and for any tensor moved under
    torch.inference_mode(): it keeps no version counter, so no copy of its
    values may be cached. Both blocks are filled on the host, from host
    copies or one device read per set (:func:`_launch_params`); a set
    without host copies takes the memory path at its first launch and this
    route from its second.
    `shared`: the world's primitives are parameters (not a world with a
    row axis); `constraints` a tuple, the constraint route's section."""
    _, tensors, _ = _param_set(robot, world, shared, constraints)
    return _route(_param_floats(robot, world, shared, len(constraints)),
                  any(t.is_inference() for t in tensors))


def _host_params(robot, world, shared: bool, constraints=()):
    """pack_params's vector, as numpy float32, from the host mirrors of the
    robot's, the world's and the constraints' tensors
    (_tensors.host_mirror): the parameter block's, or the large block's
    above _PARAM_FLOATS. None when a tensor has no mirror (made on the
    device, changed in place since it was moved, or moved under
    inference_mode) or the vector exceeds _LARGE_PARAM_FLOATS.
    `shared`: the world's primitives go in too (not for a world with a row
    axis). `constraints` (a tuple): the constraint route's section.
    :func:`_launch_params` caches what it returns."""
    grid, prims = _world_parts(world)
    parts, tensors, _ = _param_set(robot, world, shared, constraints)
    if any(t.is_inference() for t in tensors):
        return None
    host = [host_mirror(t) for t in tensors]
    if any(h is None for h in host):
        return None
    # the same objects with those fields on the host; a grid's own tensors
    # and a row world's primitives stay where they are (pack_params reads
    # only their shapes)
    it = iter(host)
    cpu = {k: dataclasses.replace(obj, **{n: torch.from_numpy(next(it))
                                          for n in fields})
           for k, (obj, fields) in parts.items()}
    h_prims = cpu.get("prims", prims)
    h_world = (h_prims if grid is None else cpu["grid"] if prims is None
               else dataclasses.replace(world, grid=cpu["grid"],
                                        overlay=h_prims))
    out = pack_params(cpu["robot"], h_world, tuple(
        cpu[f"con{i}"] for i in range(len(constraints)))).numpy()
    return out if out.size <= _LARGE_PARAM_FLOATS else None


def _launch_params(robot, world, shared: bool, constraints=()):
    """(route, params) of a launch: for "block" and "large_block"
    (:func:`param_route`) the vector as numpy float32, from the host copies
    (:func:`_host_params`) or, for a set without them (built on the card,
    changed in place since it was moved) launched a second time, from one
    read of :func:`pack_params`'s device vector (PARAM_READS), which waits
    for the work queued on the current stream; for "memory" the device
    vector, packed on the current stream at every launch and never cached
    (a launch on another stream would read it unordered). A set without
    host copies takes "memory" at its first launch, as a set used once (a
    world built anew, or changed in place, before every call) costs no host
    sync; the launch that finds it again makes the read. The host vectors
    are cached per set of tensors and versions, as the host copies are, so
    a launch that hits does no more host work than the lookup, and a tensor
    changed in place by a torch op is packed again. While a CUDA graph is
    captured no read is made: a set without host copies and not yet read
    would take the memory path in the graph, so engine/graph.py runs eager
    iterations until no launch defers its read (PARAM_READS["deferred"])
    before it captures. A write that does not
    bump the tensor's version counter (through `.data`, a DLPack alias, a
    custom CUDA op, a CUDA-graph replay) is not seen once the set is read:
    a set written that way must be new tensors, or be changed by torch
    ops."""
    _, tensors, key = _param_set(robot, world, shared, constraints)
    hit = _LAUNCH_PARAMS.get(key)
    seen = hit is not None and all(
        r() is t and t._version == v
        for r, v, t in zip(hit[0], hit[1], tensors))
    if seen and hit[2] is not None:
        return hit[2]
    route = _route(_param_floats(robot, world, shared, len(constraints)),
                   any(t.is_inference() for t in tensors))
    if route == "memory":
        return route, pack_params(robot, world, constraints)
    out = None
    if all(host_mirror(t) is not None for t in tensors):
        out = (route, _host_params(robot, world, shared, constraints))
    elif seen and not _capturing():
        # the one read of this set: ordered after pack_params on the
        # current stream (a copy to the host waits for it); never while
        # a CUDA graph is captured, where the set takes the memory path
        out = (route, pack_params(robot, world, constraints).cpu().numpy())
        PARAM_READS["device"] += 1
    else:
        PARAM_READS["deferred"] += 1
    if len(_LAUNCH_PARAMS) >= 64:
        _LAUNCH_PARAMS.clear()      # before the insert: the new entry stays
    _LAUNCH_PARAMS[key] = (tuple(map(weakref.ref, tensors)),
                           tuple(t._version for t in tensors), out)
    return out or ("memory", pack_params(robot, world, constraints))


def block_params(robot, world, shared: bool, constraints=()) -> np.ndarray:
    """The parameter block's vector of a set on "block" or "large_block"
    (:func:`param_route`) as it stands: from the host copies
    (:func:`_host_params`), else from one read of :func:`pack_params`'s
    device vector, ordered after the current stream's work
    (PARAM_READS["device"]). What engine/graph.py writes into a captured
    launch's node when the graph's world or constraints take new
    values."""
    out = _host_params(robot, world, shared, constraints)
    if out is None:
        out = pack_params(robot, world, constraints).cpu().numpy()
        PARAM_READS["device"] += 1
    return out


def _capturing() -> bool:
    """The current stream is capturing a CUDA graph (engine/graph.py)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _cands_per_row(world, C: int, cands_per_row):
    """Candidates per world row, or None for a shared world. A world with
    R rows takes C = R * cands_per_row candidates (default 1: one row per
    candidate, the per-candidate contract)."""
    rows = world_rows(world)
    if rows is None:
        if cands_per_row is not None:
            raise ValueError("cands_per_row is for a world with a row axis; "
                             "this world is shared by every candidate")
        return None
    per = 1 if cands_per_row is None else int(cands_per_row)
    if per < 1 or rows * per != C:
        raise ValueError(f"a world with {rows} rows and cands_per_row={per} "
                         f"takes {rows} x {per} candidates, got {C}")
    return per


def ee_frames(robot, fulls: torch.Tensor) -> torch.Tensor:
    """The end-effector frame the kernels' ``:ee`` forms write, in plain
    PyTorch: the last joint's frame of fk_frames (before ee_offset) for
    fulls [C, T, d] -> ee [12, T, C] (rows 0-2 position, 3-11 rotation,
    row-major)."""
    C, T, _ = fulls.shape
    pos, rot, _ = fk_frames(robot, fulls)
    frame = torch.cat([pos[..., -1, :], rot[..., -1, :, :].reshape(C, T, 9)],
                      dim=-1)                                   # [C, T, 12]
    return frame.permute(2, 1, 0).contiguous()


def _con_args(constraints, want_ee: bool):
    """The constraints as a tuple (as_tuple), or None for no constraint
    route; refuses asking for both routes."""
    if constraints is None:
        return None
    if want_ee:
        raise ValueError("want_ee and constraints are exclusive: the "
                         "constraint route computes the cost on the frame "
                         "instead of writing it")
    return as_tuple(constraints)


def obstacle_cost_batch_plain(robot, world, full_trajs: torch.Tensor,
                              dt: float, clearance: float,
                              time_major: bool = False, cands_per_row=None,
                              want_ee: bool = False, constraints=None):
    """The plain PyTorch version of the kernels: body_positions_traj → sdf →
    potential × speed (costs/obstacle.py). full_trajs [C, T, d], or
    [d, T, C] with time_major=True -> (q_obs [C, T], margin [C]), plus
    ee [12, T, C] (:func:`ee_frames`) with want_ee=True, or with
    `constraints` (not None) their cost on that frame, q_con [C, T]
    (costs/constraints.py constraint_cost_tm). A world with R rows is
    broadcast over its rows' candidates, not repeated."""
    cons = _con_args(constraints, want_ee)
    fulls = full_trajs.permute(2, 1, 0) if time_major else full_trajs
    C, T, d = fulls.shape
    per = _cands_per_row(world, C, cands_per_row)
    if per is None:
        q, m = obstacle_cost(robot, world, fulls, dt, clearance)
    else:
        q, m = obstacle_cost(robot, world, fulls.reshape(C // per, per, T, d),
                             dt, clearance)
        q, m = q.reshape(C, T), m.reshape(C)
    if cons is not None:
        return q, m, constraint_cost_tm(robot, cons, ee_frames(robot, fulls))
    return (q, m, ee_frames(robot, fulls)) if want_ee else (q, m)


def obstacle_cost_batch(robot, world, full_trajs: torch.Tensor, dt: float,
                        clearance: float, row_active=None,
                        time_major: bool = False, cands_per_row=None,
                        want_ee: bool = False, constraints=None):
    """Batched obstacle cost, the contract of the JAX package's
    ``obstacle_cost_batch_pallas``: an AnalyticWorld, a GridSDF or a
    CompositeWorld, shared by every candidate or with a row axis on its
    spheres/boxes (the overlay's for a composite).

    full_trajs: [C, T, d], or the time-major [d, T, C] with time_major=True
    (the batched solver's STOMP step builds it directly); the kernels read
    either as it is, and give the same results bit for bit.
    Returns (q_obs [C, T], margin [C]); with want_ee=True also the
    end-effector frame ee [12, T, C] (the ``:ee`` form of the kernel); with
    `constraints` (None, one OrientationConstraint / PositionConstraint or
    a tuple of them; not None takes this route) instead their summed cost
    on that frame, q_con [C, T] (the ``:con`` form: the constraint route,
    costs/constraints.py constraint_cost_tm in the kernel). The two are
    exclusive.

    A world with R rows evaluates candidate c against row
    c // cands_per_row; R * cands_per_row must be C. cands_per_row=None is
    1: every candidate its own world.

    row_active: optional [C] bool. Rows whose flag is False MAY come back as
    zeros, ee and q_con included (the kernels skip them); callers must
    discard them.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    the world's kind on the robot's chain (:func:`chain_of`), or raise —
    there is no fallback. The static chain compiles in robot.joint_static
    as it is: this function does not compare it with joint_type/joint_axis
    (that would read the device on every launch). The public entry points
    (plan_batch, plan, run_mpc_batch, run_mpc, run_mpc_resilient) check it
    once per call on the host (robot/model.py check_joint_static); a
    direct caller with CUDA tensors is responsible for a consistent spec.
    """
    dev = full_trajs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    cons = _con_args(constraints, want_ee)
    grid, prims = _world_parts(world)
    C = full_trajs.shape[-1 if time_major else 0]
    per = _cands_per_row(world, C, cands_per_row)
    for name, t in (("robot", robot.joint_axis),
                    ("grid", None if grid is None else grid.grid),
                    ("world", None if prims is None else prims.box_half),
                    *(("constraint", c.target_world) for c in cons or ())):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} tensors are on {t.device}, "
                             f"trajectories on {dev}")
    if dev.type == "cpu":
        return obstacle_cost_batch_plain(robot, world, full_trajs, dt,
                                         clearance, time_major=time_major,
                                         cands_per_row=per, want_ee=want_ee,
                                         constraints=cons)
    return _launch(robot, world, grid, prims, per, full_trajs, dt, clearance,
                   row_active, time_major, want_ee, chain_of(robot),
                   cons=cons)


def rollout_occupancy(robot, world, full_trajs: torch.Tensor, dt: float,
                      clearance: float, row_active=None,
                      time_major: bool = False, cands_per_row=None,
                      want_ee: bool = False, constraints=None) -> int:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of the kernel :func:`obstacle_cost_batch` launches for these CUDA
    arguments (on :func:`param_route`'s route: for a set without host
    copies, that of its repeat launches), at its plan's shared memory;
    launches nothing, counts nothing and reads no device value (a
    diagnostic: chip_compare.py records it)."""
    grid, prims = _world_parts(world)
    C = full_trajs.shape[-1 if time_major else 0]
    per = _cands_per_row(world, C, cands_per_row)
    resident = ctypes.c_int(0)
    _launch(robot, world, grid, prims, per, full_trajs, dt, clearance,
            row_active, time_major, want_ee, chain_of(robot), resident,
            _con_args(constraints, want_ee))
    return resident.value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _prim_arrays(prims):
    """Spheres and boxes as the kernels read them: spheres [..., S, 4]
    (center, radius) and boxes [..., X, 6] (center, half), with a world's
    row axis, if any, in front."""
    f32 = torch.float32
    spheres = torch.cat([prims.sphere_center.to(f32),
                         prims.sphere_radius.to(f32)[..., None]], dim=-1)
    boxes = torch.cat([prims.box_center.to(f32), prims.box_half.to(f32)],
                      dim=-1)
    return spheres.contiguous(), boxes.contiguous()


def _packed_table(grid, g):
    """The GridSDF's packed corner table as the grid kernel reads it (one
    32-byte row per sample): float32 [X*Y*Z, 8], contiguous, rows 32-byte
    aligned; None when the grid has none (the kernel then reads the dense
    grid g)."""
    packed = grid.packed
    if packed is None:
        return None
    if tuple(packed.shape) != (g.numel(), 8) or packed.device != g.device:
        raise ValueError(f"packed corner table must be [{g.numel()}, 8] on "
                         f"{g.device}, got {tuple(packed.shape)} on "
                         f"{packed.device}")
    packed = packed.to(torch.float32).contiguous()
    return packed if packed.data_ptr() % 32 == 0 else packed.clone()


def _launch(robot, world, grid, prims, per, full_trajs, dt, clearance,
            row_active, time_major, want_ee, chain, resident=None, cons=None):
    """One launch of the library of `chain` (:func:`chain_of`; None: the
    runtime chain), with the constraint route when `cons` is a tuple;
    with `resident` (a ctypes int) the occupancy query of
    :func:`rollout_occupancy` instead."""
    source = "rollout_analytic" if grid is None else "rollout_grid"
    entry_name = source
    if per is not None:
        entry_name += (":per_cand_world" if grid is None
                       else ":per_cand_overlay")
    if full_trajs.dtype != torch.float32 or full_trajs.dim() != 3:
        raise ValueError(f"trajectories must be a 3-D float32 tensor, got "
                         f"{full_trajs.dtype} {tuple(full_trajs.shape)}")
    # either layout as it comes: the kernel stages [C, T, d] itself (K4)
    cand = full_trajs.contiguous()
    d, T, C = cand.shape if time_major else cand.shape[::-1]
    if d != robot.num_joints:
        raise ValueError(f"trajectories have {d} joints, robot has "
                         f"{robot.num_joints}")
    if T < 2:
        raise ValueError("need at least 2 waypoints (workspace speed)")
    dev = cand.device
    shared, con_set = per is None, cons or ()
    if resident is None:
        route, params = _launch_params(robot, world, shared, con_set)
    else:
        # the occupancy query reads no device value: the route from shapes,
        # and zeros of the set's length for its parameters (on the memory
        # path a pointer the query never follows)
        route = param_route(robot, world, shared, con_set)
        n = _param_floats(robot, world, shared, len(con_set))
        params = np.zeros(n, np.float32)
    n_params = len(params)
    ptr = (params.data_ptr() if isinstance(params, torch.Tensor)
           else params.ctypes.data)
    head = (cand.data_ptr(), ptr, n_params, int(route != "memory"))
    staged = n_params if route == "memory" else 0
    active = None
    if row_active is not None:
        if row_active.shape != (C,) or row_active.device != dev:
            raise ValueError(f"row_active must be [{C}] on {dev}")
        active = (row_active.contiguous().view(torch.uint8)
                  if row_active.dtype == torch.bool
                  else row_active.to(torch.uint8).contiguous())
    cpb, n_slab = _plan(C, T, d, want_ee, staged, _sm_count(dev.index),
                        con=cons is not None)
    q_obs = torch.empty((T, C), dtype=torch.float32, device=dev)
    margin_part = torch.empty((n_slab, C), dtype=torch.float32, device=dev)
    ee = (torch.empty((12, T, C), dtype=torch.float32, device=dev)
          if want_ee else None)
    q_con = (None if cons is None
             else torch.empty((T, C), dtype=torch.float32, device=dev))
    ns = 0 if prims is None else prims.sphere_radius.shape[-1]
    nx = 0 if prims is None else prims.box_half.shape[-2]
    tail = (None if active is None else active.data_ptr(),
            q_obs.data_ptr(), margin_part.data_ptr(),
            None if ee is None else ee.data_ptr(),
            None if q_con is None else q_con.data_ptr(), C, T, d,
            robot.num_bodies, ns, nx, len(cons or ()), float(dt),
            float(clearance), int(bool(robot.rot_fixed_identity)), cpb,
            n_slab, int(not time_major))
    query = None if resident is None else ctypes.byref(resident)
    rows = ()
    if per is not None:
        spheres, boxes = _prim_arrays(prims)
        rows = (spheres.data_ptr(), boxes.data_ptr(), per)
    lib = build((source,), (chain,))[(source, chain)]
    entry = getattr(lib, _ENTRIES[entry_name][1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if grid is None:
            err = entry(*head, *rows, *tail, stream, query)
        else:
            g = grid.grid.to(torch.float32).contiguous()
            if g.numel() >= 2**31:
                raise ValueError(f"grid of {g.numel()} voxels: the kernel "
                                 "indexes it with 32-bit ints")
            packed = _packed_table(grid, g)
            grid_args = (g.data_ptr(),
                         None if packed is None else packed.data_ptr(),
                         *g.shape, *map(float, grid_clip_hi(g.shape)))
            mid = rows or (int(isinstance(world, CompositeWorld)),)
            err = entry(*head, *grid_args, *mid, *tail, stream, query)
    name = (entry_name + ("" if chain is not None else ":runtime")
            + (":ee" if want_ee else "" if cons is None else ":con"))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if resident is not None:
        return None
    if route != "memory" and _capturing():
        # the node's block, rewritten when the graph's world takes new
        # values (engine/graph.py)
        from tpustomp_torch.kernels import graph_node
        graph_node.record(torch.cuda.current_stream(dev), route, params,
                          (robot, world, shared, con_set))
    LAUNCHES[name] += 1
    PARAM_ROUTES[route] += 1
    LAYOUTS["time_major" if time_major else "candidate_major"] += 1
    BODY_ORDER["unsorted" if robot.body_counts is None else "sorted"] += 1
    margin = margin_part[0] if n_slab == 1 else margin_part.amin(dim=0)
    if want_ee:
        return q_obs.t(), margin, ee
    if q_con is not None:
        return q_obs.t(), margin, q_con.t()
    return q_obs.t(), margin

"""Fused rollout evaluators: FK → sphere bodies → SDF → potential × workspace
speed → per-waypoint cost rows, one CUDA kernel per world kind.

Port of the evaluation kernels of ``tpustomp/kernels/rollout_pallas.py`` and
of the contract of their wrapper ``obstacle_cost_batch_pallas``:

- ``rollout_analytic`` (``csrc/rollout_analytic.cu``), for `AnalyticWorld`:
  K3 (pallas_call :741); K4 (:755, the candidate-major [C, T, d] input,
  permuted here into the kernel's time-major layout); K1 (:257, robots
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
how the design answers that): one warp walks one candidate over a segment
of the waypoint axis, one waypoint per lane (the segment plan is
:func:`_segments`); a grid with a packed corner table is read through it.
Each source is compiled with nvcc into a
shared library with a plain C interface at first use, into
``tpustomp_torch/_build/``, and called through ctypes.

Every variant has an ``:ee`` form (K3 with ``ee_out=True``): the same
launch with an end-effector frame output ``ee [12, T, C]`` (rows 0-2 the
last joint's position, 3-11 its rotation, row-major; zeros on inactive
rows), which Cartesian constraints read (costs/constraints.py
``constraint_cost_tm``). Asking for it changes neither q_obs nor margin.

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
  its ``:ee`` form.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpustomp_torch.costs.obstacle import obstacle_cost
from tpustomp_torch.robot.fk import fk_frames
from tpustomp_torch.world.sdf import (AnalyticWorld, CompositeWorld, GridSDF,
                                      grid_clip_hi, world_rows)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (active, q_obs, margin_part, ee, C, T, d, nb, ns, nx, dt, clearance,
#  skip_rotf, seg_len, stream): the arguments every entry point ends with
_TAIL = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
_GRID = [_P, _P, _I, _I, _I, _F, _F, _F]      # grid, packed, X, Y, Z, hi[3]
_ROWS = [_P, _P, _I]                          # spheres, boxes, cands_per_row
# kernel variant -> (source in csrc/, C entry point, its argument types)
_ENTRIES = {
    "rollout_analytic": (
        "rollout_analytic", "rollout_analytic_launch", [_P, _P, _I] + _TAIL),
    "rollout_analytic:per_cand_world": (
        "rollout_analytic", "rollout_analytic_rows_launch",
        [_P, _P, _I] + _ROWS + _TAIL),
    "rollout_grid": (
        "rollout_grid", "rollout_grid_launch",
        [_P, _P, _I] + _GRID + [_I] + _TAIL),
    "rollout_grid:per_cand_overlay": (
        "rollout_grid", "rollout_grid_rows_launch",
        [_P, _P, _I] + _GRID + _ROWS + _TAIL),
}
_SOURCES = ("rollout_analytic", "rollout_grid")

# Kernel launches per kernel variant since import (or reset_launches()):
# "<variant>" on a robot's static chain, "<variant>:runtime" on the runtime
# chain; a launch that also writes the end-effector frame adds ":ee".
LAUNCHES = {name + chain + ee: 0 for name in _ENTRIES
            for chain in ("", ":runtime") for ee in ("", ":ee")}
# Seconds of each library's first build in this process, by (source, chain).
BUILD_SECONDS: dict[tuple, float] = {}

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# One warp walks one candidate over a segment of the waypoint axis, a
# waypoint per lane: its lanes less a halo lane on either side
# (csrc/rollout_common.cuh kWarp, kSegMax).
_WARP = 32
_SEG_MAX = _WARP - 2

# A static chain's axis component other than exactly 0, +1 or -1
# (csrc/rollout_common.cuh kOther): read from the parameters at run time.
_OTHER = 2

_libs: dict[tuple, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _nvcc_flags(chain) -> tuple[str, ...]:
    """nvcc's flags for a library of `chain` (None: the runtime chain)."""
    if chain is None:
        return _NVCC_FLAGS
    return _NVCC_FLAGS + (chain_definition(chain),)


def _lib_path(name: str, chain=None) -> Path:
    """The library's name carries a hash of the flags (the chain's
    definition among them) and of every source it is built from, so an
    edited source or header is never served by a stale build."""
    h = hashlib.sha256(" ".join(_nvcc_flags(chain)).encode())
    for src in _sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_job(nvcc, name, chain, out):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *_nvcc_flags(chain), "-o", out, str(_CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build(names=_SOURCES, chains=(None,)) -> dict[tuple, ctypes.CDLL]:
    """Compile (once per version of the sources and chain) and load the
    named kernel libraries (sources in csrc/) for each chain (None: the
    runtime chain; else a :func:`chain_of` tuple). Missing builds run at the
    same time, one nvcc each; their seconds go to BUILD_SECONDS. Returns
    {(name, chain): library}."""
    keys = [(n, c) for c in chains for n in names]
    missing = [k for k in keys if k not in _libs and not _lib_path(*k).exists()]
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
                jobs = [pool.submit(_nvcc_job, nvcc, n, c, tmp)
                        for (n, c), tmp in zip(missing, tmps)]
                done = [job.result() for job in jobs]
            errors = []
            for (n, c), tmp, (proc, seconds) in zip(missing, tmps, done):
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {n}.cu, chain {c} "
                                  f"({proc.returncode}):\n{proc.stdout}\n"
                                  f"{proc.stderr}")
                else:
                    BUILD_SECONDS[(n, c)] = seconds
                    os.replace(tmp, _lib_path(n, c))   # atomic: no races
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for tmp in tmps:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    for n, c in keys:
        if (n, c) not in _libs:
            lib = ctypes.CDLL(str(_lib_path(n, c)))
            for source, entry, argtypes in _ENTRIES.values():
                if source == n:
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[(n, c)] = lib
    return {k: _libs[k] for k in keys}


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


def pack_params(robot, world) -> torch.Tensor:
    """Robot + world parameters as the kernels' packed float32 vector (layout
    in the header of csrc/rollout_common.cuh), on the robot's device. A
    world with a row axis contributes only its grid's origin and resolution:
    its primitives go to the kernel as their own arrays (_prim_arrays)."""
    d = robot.num_joints
    dev = robot.joint_axis.device
    f32 = torch.float32
    offset, radius = robot.body_offset, robot.body_radius
    if robot.body_counts is not None:
        # bodies link-sorted (RobotSpec's _spec): the runs come from the host
        # tuple, copied from pinned memory without a wait
        body_start = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(robot.body_counts)]).astype(np.float32))
        if dev.type == "cuda":
            body_start = body_start.pin_memory().to(dev, non_blocking=True)
    else:
        # bodies in any order: stable-sort by link on the device, so the
        # kernel walks one contiguous run per joint (costs are sums and mins
        # over bodies; only the float summation order moves); the runs'
        # starts by a search of fixed output shape (no read-back)
        link, order = torch.sort(robot.body_link.long(), stable=True)
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
    return torch.cat(parts).contiguous()


def _segments(T: int) -> tuple[int, int]:
    """The kernels' segment plan: (seg_len, n_seg). Segment s owns
    waypoints [s * seg_len, min(T, (s + 1) * seg_len)); its warp also
    computes the FK of the waypoint on either side (the halo) for the
    speed's central difference, and writes its own row of margin_part
    [n_seg, C]. The fewest segments of at most _SEG_MAX waypoints, of
    near-equal length (the last may be shorter)."""
    n_seg = -(-T // _SEG_MAX)
    seg_len = -(-T // n_seg)
    return seg_len, n_seg


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


def obstacle_cost_batch_plain(robot, world, full_trajs: torch.Tensor,
                              dt: float, clearance: float,
                              time_major: bool = False, cands_per_row=None,
                              want_ee: bool = False):
    """The plain PyTorch version of the kernels: body_positions_traj → sdf →
    potential × speed (costs/obstacle.py). full_trajs [C, T, d], or
    [d, T, C] with time_major=True -> (q_obs [C, T], margin [C]), plus
    ee [12, T, C] (:func:`ee_frames`) with want_ee=True. A world with R
    rows is broadcast over its rows' candidates, not repeated."""
    fulls = full_trajs.permute(2, 1, 0) if time_major else full_trajs
    C, T, d = fulls.shape
    per = _cands_per_row(world, C, cands_per_row)
    if per is None:
        q, m = obstacle_cost(robot, world, fulls, dt, clearance)
    else:
        q, m = obstacle_cost(robot, world, fulls.reshape(C // per, per, T, d),
                             dt, clearance)
        q, m = q.reshape(C, T), m.reshape(C)
    return (q, m, ee_frames(robot, fulls)) if want_ee else (q, m)


def obstacle_cost_batch(robot, world, full_trajs: torch.Tensor, dt: float,
                        clearance: float, row_active=None,
                        time_major: bool = False, cands_per_row=None,
                        want_ee: bool = False):
    """Batched obstacle cost, the contract of the JAX package's
    ``obstacle_cost_batch_pallas``: an AnalyticWorld, a GridSDF or a
    CompositeWorld, shared by every candidate or with a row axis on its
    spheres/boxes (the overlay's for a composite).

    full_trajs: [C, T, d], or the time-major [d, T, C] with time_major=True
    (the layout the kernels read; the batched solver builds it directly).
    Returns (q_obs [C, T], margin [C]); with want_ee=True also the
    end-effector frame ee [12, T, C] (the ``:ee`` form of the kernel).

    A world with R rows evaluates candidate c against row
    c // cands_per_row; R * cands_per_row must be C. cands_per_row=None is
    1: every candidate its own world.

    row_active: optional [C] bool. Rows whose flag is False MAY come back as
    zeros, ee included (the kernels skip them); callers must discard them.

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
    grid, prims = _world_parts(world)
    C = full_trajs.shape[-1 if time_major else 0]
    per = _cands_per_row(world, C, cands_per_row)
    for name, t in (("robot", robot.joint_axis),
                    ("grid", None if grid is None else grid.grid),
                    ("world", None if prims is None else prims.box_half)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} tensors are on {t.device}, "
                             f"trajectories on {dev}")
    if dev.type == "cpu":
        return obstacle_cost_batch_plain(robot, world, full_trajs, dt,
                                         clearance, time_major=time_major,
                                         cands_per_row=per, want_ee=want_ee)
    return _launch(robot, world, grid, prims, per, full_trajs, dt, clearance,
                   row_active, time_major, want_ee, chain_of(robot))


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
            row_active, time_major, want_ee, chain):
    """One launch of the library of `chain` (:func:`chain_of`; None: the
    runtime chain)."""
    source = "rollout_analytic" if grid is None else "rollout_grid"
    entry_name = source
    if per is not None:
        entry_name += (":per_cand_world" if grid is None
                       else ":per_cand_overlay")
    if full_trajs.dtype != torch.float32 or full_trajs.dim() != 3:
        raise ValueError(f"trajectories must be a 3-D float32 tensor, got "
                         f"{full_trajs.dtype} {tuple(full_trajs.shape)}")
    cand = full_trajs if time_major else full_trajs.permute(2, 1, 0)
    cand = cand.contiguous()                               # [d, T, C]
    d, T, C = cand.shape
    if d != robot.num_joints:
        raise ValueError(f"trajectories have {d} joints, robot has "
                         f"{robot.num_joints}")
    if T < 2:
        raise ValueError("need at least 2 waypoints (workspace speed)")
    dev = cand.device
    params = pack_params(robot, world)
    active = None
    if row_active is not None:
        if row_active.shape != (C,) or row_active.device != dev:
            raise ValueError(f"row_active must be [{C}] on {dev}")
        active = row_active.to(torch.uint8).contiguous()
    seg_len, n_seg = _segments(T)
    q_obs = torch.empty((T, C), dtype=torch.float32, device=dev)
    margin_part = torch.empty((n_seg, C), dtype=torch.float32, device=dev)
    ee = (torch.empty((12, T, C), dtype=torch.float32, device=dev)
          if want_ee else None)
    ns = 0 if prims is None else prims.sphere_radius.shape[-1]
    nx = 0 if prims is None else prims.box_half.shape[-2]
    tail = (None if active is None else active.data_ptr(),
            q_obs.data_ptr(), margin_part.data_ptr(),
            None if ee is None else ee.data_ptr(), C, T, d,
            robot.num_bodies, ns, nx, float(dt), float(clearance),
            int(bool(robot.rot_fixed_identity)), seg_len)
    head = (cand.data_ptr(), params.data_ptr(), params.numel())
    rows = ()
    if per is not None:
        spheres, boxes = _prim_arrays(prims)
        rows = (spheres.data_ptr(), boxes.data_ptr(), per)
    lib = build((source,), (chain,))[(source, chain)]
    entry = getattr(lib, _ENTRIES[entry_name][1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if grid is None:
            err = entry(*head, *rows, *tail, stream)
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
            err = entry(*head, *grid_args, *mid, *tail, stream)
    name = (entry_name + ("" if chain is not None else ":runtime")
            + (":ee" if want_ee else ""))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    if want_ee:
        return q_obs.t(), margin_part.amin(dim=0), ee
    return q_obs.t(), margin_part.amin(dim=0)

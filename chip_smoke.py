#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpustomp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths once, through the entry points a user calls,
and fails (non-zero exit, no result line) on any error:

  1. a CUDA card is present; TF32 off; the card's name and power limit;
  2. both evaluator kernels build from tpustomp_torch/csrc with nvcc (one
     nvcc per source, started together);
  3. rollout_analytic against its plain PyTorch version at the config-4
     shape (C = 1024 scenarios x 56 candidates = 57,344 trajectories,
     T = 102) on the tabletop boxes: time-major input with all rows active
     and with about a third inactive (K3), the candidate-major [C, T, d]
     input (K4, staged by the kernel: at C and at config 3's C = 1,024,
     bitwise the time-major launch, one kernel in its profiler window),
     and a robot with shuffled bodies and no body_counts (K1); kernel and
     plain times (CUDA events);
  3g. rollout_grid against the plain version at the same shape on the
     config-2 tabletop voxelized by the port's signed EDT (64x80x48 at
     2.5 cm): all rows active and masked (K5 + tail), the grid plus an
     overlay sphere (CompositeWorld), shuffled bodies (K2), the
     candidate-major input (K4's grid form, as for the analytic kernel),
     the packed corner table against the dense grid (bitwise); times, also
     on solver-like candidates (config 4's problems: min-jerk + sigma L
     z);
  3e. both kernels and their :ee forms against plain at the lane plan's
     edges (T in {2, 3, 31, 32, 33, 101, 102, 103}, a ragged C of 4,229
     with 7-8 candidates a block, a third of the rows masked, both chains),
     and the parameter routes: a world, an overlay and a robot above the
     3 KB parameter block (the large block), a world and a robot built on
     the card, a world changed in place, K1 / K2 sorted on the card (the
     memory path at a set's first launch, then the block after one device
     read), robot and world moved under
     inference_mode and a world above the large block (the memory path),
     each counted on its route and timed;
  3s. two worlds built on the card, launched at once on two streams: each
     result bitwise its own single-stream launch (and its first launch,
     on the memory path);
  3m. the per-row-world variants (rollout_analytic:per_cand_world,
     rollout_grid:per_cand_overlay) against the plain version at the
     config-5 shape (B = 10,000 scenarios x 21 candidates = 210,000
     trajectories, T = 52): one moving sphere per scenario plus the
     tabletop boxes, and the voxel tabletop plus a per-row overlay sphere;
     all rows active, masked rows, the per-candidate form against the
     grouped one (bitwise), every row equal against the shared-world kernel
     (bitwise), the grid's packed corner table against its dense grid
     (bitwise); kernel and plain times on uniform random waypoints, and
     kernel times on solver-like candidates (the min-jerk plan between each
     scenario's start and goal plus sigma L z at the config's sigma: the
     grid gather's locality depends on smooth paths);
  4. plan_batch on BASELINE config 4 (configs/config4_batch.yaml, tabletop
     boxes, B = 1024, starts/goals jittered as the CLI does): the analytic
     kernel's launches over that run, success, and checks on every solved
     row; and the same slice on a small input against the CPU run (plain
     evaluator) under the same noise;
  4g. the same over the voxel tabletop (grid kernel), with every solved row
     also checked against the exact box SDF; every launch of both runs
     takes the kernel parameter block (counted per route);
  5. plan on BASELINE config 2 (configs/config2_tabletop.yaml);
  5g. plan on config 2 over the voxel tabletop, 4 restarts;
  6. run_mpc_batch on BASELINE config 5 (configs/config5_mpc.yaml: 10,000
     scenarios, 100 ticks) over the tabletop boxes, states seeded as
     bench/mpc_bench.py: replans/s, collision, reached and ticks to goal,
     the variant's launches, and checks of the final state;
  6g. the same over the voxel tabletop (CompositeWorld per tick);
  6c. batched MPC on the card against the CPU run, B = 8, 4 ticks, under
     the same noise, over both static worlds;
  7. the ``:ee`` form of every variant (TPU K3 with ee_out: the
     end-effector frame [12, T, C] beside the costs) against the plain
     fk_frames frame at the config-4 shape (shared worlds) and the config-5
     shape (per-row worlds), with a third of the rows masked: ee to rtol
     1e-5 / atol 2e-5, zeros on masked rows, q_obs and margin bitwise equal
     to the launch without ee; ee, no-ee and plain times;
  7c. the ``:con`` form of every variant (the constraint route: the
     constraints' cost computed in the kernel on the frame, q_con [C, T],
     instead of the frame and the solver's tail on it) at the same shapes,
     for the cone, a tool-point target and both, a third of the rows
     masked: q_con against the plain tail on the same launch's :ee frame
     (rtol 1e-5, atol 1e-6 per unit of weight) and against the plain
     version (q_con_tolerance: the ee gate carried through the tail),
     zeros on masked rows, q_obs and margin bitwise the launch without
     constraints; the memory path (a cone made on the card); :con, :ee and
     no-constraint times in turns, plain times, resident blocks per SM;
  8. Cartesian constraints and the torque cost on the main path:
     plan_batch on config 4's problems with the "glass of water" cone
     (bench.py's constrained row: config 2 at 50 iterations, no early stop)
     against the same run unconstrained, over the box and the voxel
     tabletop (only :con launches; the constraint tail's kernels per
     iteration from a profiler window over each run, at most 2); a
     constrained solve_batch over config 5's per-scenario worlds (both
     static worlds); plan_batch B = 256 with torque weight 0.005 (bench.py's
     torque row);
  9. CHOMP (BASELINE config 3, configs/config3_chomp.yaml): plan on its
     query, plan_batch B = 1024 on jittered problems (success floor 0.9),
     plan_batch B = 256 with the experiment suite's HMC settings; the
     CHOMP gradient kernel's launches over the three asserted equal to
     the iterations run (L + 1 an HMC iteration);
  9c. constrained STOMP and config-3 CHOMP on the card against the CPU run,
     B = 8, under the same noise;
 10. the joint chain (TPU K3/K5 static_joints): the phases above run every
     built-in robot on its static chain (the robot compiled in); here each
     variant and its :ee and :con forms on the static chain against the
     plain version and against the runtime chain (joint_static=None) at
     the config-4 and config-5 shapes, with both chains' times (arm_7dof;
     and the URDF torso arm below at the config-4 shape);
 10u. plan_batch on config 4's problems with a URDF robot (the arm_7dof
     chain under a prismatic torso lift, one axis negated, a general axis,
     fixed rotations, a fixed tool link; cylinder/box collision geometry),
     B = 1024, on its static chain only; and at B = 8 against the CPU run;
 10g. a stale joint_static (joint_axis replaced, joint_static kept):
     plan_batch warns and runs only :runtime kernels, equal to the honest
     robot's run;
 10s. one launch of each variant and its :con form (and of the sorted
     runtime route, K1; a world built on the card, after its one device
     read; another at its first launch, on the memory path) under
     torch.cuda.set_sync_debug_mode("error"): no host sync.
 11. the rest of the planning API, at config 4's full width unless named,
     every entry point called without `device` (it runs on the card):
     goal-tolerance bands (every goal given +-0.1 rad: the resolve over
     B·65 candidates timed, every endpoint inside band ∩ limits); plan_timed
     on config 2 (a 60 s budget bitwise equal to plan, a 0 s budget stopping
     after one chunk); batch compaction on and off in alternating turns over
     both worlds (success and iterations equal, trajectories within 1e-5);
     the smooth rollout projection (and its ms per iteration);
     plan_batch_retry after a 4-iteration budget (successful rows bitwise
     unchanged); plan_batch_stream, 8 batches x 256 at depth 2 and 0,
     against back-to-back plan_batch calls (results bitwise equal); tune on
     a 4x3x2 grid x 43 problems. Each phase's launches are counted from 0.
 12. the modules that complete the port, at full width: an IncrementalSDF
     of the config-2 tabletop (64x80x48 at 2.5 cm, max_distance 0.5) on the
     card, patched by set_box and add_points (host EDT + upload timed with
     CUDA events), bitwise equal to a fresh field on the final occupancy,
     the grid kernel on it bitwise the rebuilt field's and within tolerance
     of plain, a world taken before the updates unchanged, then plan_batch
     B = 1024 on it; plan_sharded at world size 1 bitwise plan_batch;
     plan_sharded over two gloo ranks on the one card (two spawned
     processes, 512 rows each) against the one-rank run, summarize equal on
     both ranks; `python -m tpustomp_torch` as a subprocess on config 2
     (analytic and --grid), config 4 (1,024 scenarios) and config 5 (10,000
     scenarios x 100 ticks, analytic and --grid): rc 0, JAX's keys, wall;
     a config-5 episode checkpointed at tick 50 (state and generator),
     restored into freshly built objects and finished, bitwise the
     uninterrupted episode; utils.tracing.profile windows over a config-4
     plan_batch, with the eager loop and replaying the solver's CUDA graph:
     kernels and host launches per iteration and the device's idle share.
 13. the solver's CUDA graphs (engine/graph.py, the counterpart of the
     JAX package's jitted solve: solve-in, the loop in chunks of
     iterations under IF nodes with its condition and draws on the
     device, solve-out) and the MPC tick's (engine/mpc.py _Tick, the
     counterpart of its jitted run_mpc_batch scan): every solve and
     episode of phases 4-12 must have replayed its graphs on the chunk
     route; here config 4 (box, voxel, cone, a box world built on the
     card), config 2's plan (also with the robot and world built on the
     CPU at every call), config 3's CHOMP plan and plan_batch, HMC, config
     5 (10,000 scenarios x 20 ticks, box and voxel), a fleet of 256 and
     one robot's run_mpc run on three routes in turns (eager, one replay
     an iteration, chunks): walls, solves/s, replans/s or latency, host
     reads of the loop's condition per solve or tick (none inside a chunk
     episode), host launches per call, the first graphed calls' walls,
     the entries' pools, capture and instantiate ms, results and the
     generator's offset after each call bitwise equal, no graphed call
     capturing anew or launching on the memory path; then profiler
     windows of config 4's loop and of config 5's ticks on the three
     routes: host launches, kernels and kernel ms per iteration or tick,
     and the device's idle share. The main path's launches are asserted
     equal to the per-iteration route's (MAIN_PATH_LAUNCHES).

  2p. the propose kernel (csrc/propose.cu: the STOMP step's scale, add,
     clip and both candidate layouts in one pass) against its plain
     PyTorch version at the config-4 and config-5 shapes: bitwise, kernel
     and plain ms (CUDA events), its bytes bound; its launches over the
     config-4 plan_batch and config-5 MPC phases, asserted above 0.
  2π. PI²'s tail (csrc/pi2.cu: the reverse cost-to-go, the per-timestep
     softmax and the probability-weighted candidates in one pass) against
     its plain PyTorch version and a float64 evaluation at the config-4
     and config-5 shapes and at B = 1: max |Δ| to each, kernel and plain
     ms (CUDA events over a captured graph of 10 calls), its bytes bound;
     its launches over the config-4 plan_batch and config-5 MPC phases,
     asserted equal to the propose kernel's.
  2c. the CHOMP gradient kernel (csrc/chomp_grad.cu: ∇U's point
     Jacobians, SDF gradient, curvature term, damped pseudo-inverse and
     Jᵀ sum in one pass) against its plain PyTorch version at config 3's
     shape (B 1,024, N 100, two boxes): max |Δ|, kernel and plain ms (CUDA
     events over a captured graph), the bound from benchmark/lib/
     roofline.py's peaks, resident blocks per SM, its library's build
     seconds.

The line before the last is the kernel table as JSON (every kernel with
its launches on its main path, max |Δ| against its plain version, kernel
and plain ms, the least time the card could take for the same work on the
chain it ran: bound_ms, bound_by; the runtime chain's ms and the largest
|static - runtime|; ms_smooth on solver-like candidates where measured;
for the shared-world kernels K4's candidate-major ms at both C and its
main-path launches, and K1 / K2's ms);
the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain tolerance: FMA contraction and a different summation
# order move the float32 FK chain by about 1 ULP per joint (the JAX
# package measured up to 4e-6 in body positions at 7 joints).
Q_ATOL, Q_RTOL, M_ATOL = 1e-5, 1e-5, 1e-6
TOL = f"q {Q_ATOL}+{Q_RTOL}|q|, margin {M_ATOL}"
# The end-effector frame against fk_frames: the JAX package's gate for the
# TPU kernel's ee_out (tests/unit/test_rollout_kernel.py:371-372).
EE_RTOL, EE_ATOL = 1e-5, 2e-5

# The constraint route's q_con against the plain tail on the kernel's own
# :ee frame: only acosf against torch's arccos can differ (the route rounds
# every product and sum on its own, as the tail's elementwise passes do);
# atol per unit of constraint weight.
CON_RTOL, CON_ATOL_PER_WEIGHT = 1e-5, 1e-6


def q_con_tolerance(robot, constraints, ee):
    """[C, T] bound on |q_con(kernel) - q_con(plain)| derived from the ee
    gate: where each entry of the kernel's frame is within EE_ATOL +
    EE_RTOL·|ee| of the plain frame ee [12, T, C], each constraint's
    excess moves by at most Δe (orientation: the axis and cos bounds
    carried through acos, which is monotone, so the exact change of acos
    over cos ± Δcos; position: the tool point's bound summed over its
    axes), and its cost w·e² by w·(2e + Δe)·Δe; plus 1e-6·w for the
    float32 rounding of the tail and CON_RTOL of the cost."""
    eps = EE_ATOL + EE_RTOL * ee.abs()
    p, R, e_p, e_R = ee[:3], ee[3:], eps[:3], eps[3:]
    tol = torch.zeros_like(ee[0])
    cost = torch.zeros_like(ee[0])
    for c in constraints:
        w, t = float(c.weight), c.target_world.tolist()
        orient = hasattr(c, "axis_local")
        a = (c.axis_local if orient else robot.ee_offset).tolist()
        row = [R[3 * i] * a[0] + R[3 * i + 1] * a[1] + R[3 * i + 2] * a[2]
               for i in range(3)]
        d_row = [sum(e_R[3 * i + k] * abs(a[k]) for k in range(3))
                 for i in range(3)]
        if orient:
            cos = sum(row[i] * t[i] for i in range(3))
            d_cos = sum(d_row[i] * abs(t[i]) for i in range(3)) + 1e-6
            d_e = (torch.arccos(torch.clamp(cos - d_cos, -1.0, 1.0))
                   - torch.arccos(torch.clamp(cos + d_cos, -1.0, 1.0))
                   + 1e-6)
            ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
            e = torch.clamp(ang - float(c.tolerance), min=0.0)
        else:
            rel = [p[i] + row[i] - t[i] for i in range(3)]
            d_e = sum(e_p[i] + d_row[i] for i in range(3)) + 1e-6
            dist = torch.sqrt(sum(r * r for r in rel))
            e = torch.clamp(dist - float(c.tolerance), min=0.0)
        tol = tol + w * (2.0 * e + d_e) * d_e + 1e-6 * w
        cost = cost + w * e * e
    return (tol + CON_RTOL * cost).t()


# Peak rates of one H100 SXM (NVIDIA's data sheet, 700 W): float32 outside
# the tensor cores, and HBM3.
PEAK_FP32_OPS, PEAK_BYTES = 67e12, 3.35e12
# Float operations per (candidate, waypoint) of the evaluators, counted
# from the source (csrc/rollout_common.cuh); sin, cos, sqrt and a division
# count one each. FK: fk_ops below. A body: placement 18, then speed 12 and
# potential, sum and margin 10, plus its distance: 11 per sphere, 25 per
# box, 51 per trilinear grid sample. The ee output adds stores only. The
# constraint route adds, per constraint, an orientation cone's 28 (R·axis
# 15, the dot 5, clamp 2, acos, - tolerance, max, square, weight, sum) or a
# position target's 32 (R·offset + p - target 21, |rel|² 5, sqrt, then as
# the cone's last five).
OPS_BODY, OPS_SPHERE, OPS_BOX, OPS_GRID = 40, 11, 25, 51
OPS_CONE, OPS_POSITION = 28, 32
OTHER = 2          # a run-time axis component (kernels/rollout.py _OTHER)


def fk_ops(rollout, robot, static=True):
    """Float operations of one waypoint's FK on the chain a kernel runs:
    per joint the origin (18) and R·RotFixed (45) unless every fixed
    rotation is the identity; a revolute joint's sincos (2) and 1 - cos
    (1), the live terms of G (a run-time coefficient costs its product and
    the term's multiply; +1 and -1 fold to nothing), and R·G over G's live
    entries; a prismatic joint's axis projection and translation. The
    static chain folds as rollout_common.cuh's Joint does; the runtime
    chain (static=False) folds nothing: 99 a revolute joint."""
    d = robot.num_joints
    chain = rollout.chain_of(robot) if static else None
    assert (chain is not None) == static, "no static chain for this robot"
    codes = ([chain[2 + 5 * j:5 + 5 * j] for j in range(d)] if static
             else [(OTHER,) * 3] * d)

    def mul(a, b):
        return 0 if 0 in (a, b) else OTHER if OTHER in (a, b) else a * b

    ops = 0
    for jtype, (x, y, z) in zip(robot.joint_type.tolist(), codes):
        ops += 18 + (0 if robot.rot_fixed_identity else 45)
        if jtype != 0:                  # prismatic: a·R rows, then p += .. q
            n = sum(k != 0 for k in (x, y, z))
            per_row = sum(k == OTHER for k in (x, y, z)) + max(n - 1, 0)
            ops += 3 * (per_row + 2) if n else 0
            continue
        ops += 3                                        # sincos, 1 - cos
        live = []
        for a, b, k_s in ((x, x, None), (x, y, z), (x, z, y),
                          (y, x, z), (y, y, None), (y, z, x),
                          (z, x, y), (z, y, x), (z, z, None)):
            k_oc = mul(a, b)
            terms = [(k_oc != 0, 2 if k_oc == OTHER else 0),
                     (True, 0) if k_s is None      # a diagonal's cos
                     else (k_s != 0, 1 if k_s == OTHER else 0)]
            n = sum(lv for lv, _ in terms)
            live.append(n > 0)
            ops += sum(c for lv, c in terms if lv) + max(n - 1, 0)
        for col in range(3):                            # R·G, 3 rows
            ops += 3 * (2 * sum(live[col + 3 * k] for k in range(3)) - 1)
    return ops


def bound(C, T, d, fk, nb, ns, nx, grid_voxels=0, rows=0, ee=False,
          con_ops=None):
    """(bound_ms, bound_by) of one evaluator launch: the larger of its
    float operations (fk per waypoint: fk_ops; con_ops per waypoint on the
    constraint route) over the fp32 peak and the bytes it must move (the
    candidates, the grid and per-row primitives read once; q_obs, margin,
    ee and q_con written once) over the memory rate."""
    per_body = OPS_BODY + OPS_SPHERE * ns + OPS_BOX * nx + (
        OPS_GRID if grid_voxels else 0)
    ops = C * T * (fk + nb * per_body + (con_ops or 0))
    nbytes = 4 * (C * T * d + C * T + C + (12 * C * T if ee else 0)
                  + (C * T if con_ops is not None else 0)
                  + grid_voxels + rows * (4 * ns + 6 * nx))
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def say(phase, **kv):
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def cuda_time_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_time_ms(fn, reps, calls=10):
    """Median milliseconds of one fn() over reps replays of a CUDA graph
    of `calls` back-to-back fn() calls, timed with CUDA events: device
    time with no host launch cost (fn must be capturable)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    return cuda_time_ms(graph.replay, reps) / calls


def tabletop(scene_doc):
    from tpustomp_torch.world.sdf import AnalyticWorld

    return AnalyticWorld.make(boxes=[(tuple(b["center"]), tuple(b["half"]))
                                     for b in scene_doc["boxes"]])


def voxel_tabletop(scene_doc):
    """The scene's own grid spec, voxelized through the port's signed EDT."""
    from tpustomp_torch.world.edt import occupancy_from_analytic, signed_edt

    g = scene_doc["grid"]
    occ = occupancy_from_analytic(tabletop(scene_doc), g["origin"],
                                  tuple(g["shape"]), g["resolution"])
    return signed_edt(occ, g["resolution"], g["origin"])


def shuffled(robot, seed):
    """robot with its bodies in a random order and no body_counts (the
    case of the TPU's rolled kernels K1/K2), built on the CPU and moved to
    robot's device with .to(), as a user's robot comes (the parameter
    block)."""
    cpu = robot.to("cpu")
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        robot.num_bodies))
    return dataclasses.replace(
        cpu, body_link=cpu.body_link[perm], body_offset=cpu.body_offset[perm],
        body_radius=cpu.body_radius[perm],
        body_counts=None).to(robot.body_link.device)


def made_on_card(robot):
    """robot with a parameter made on its device (a clone there): no host
    copy, so its launches take the memory path."""
    return dataclasses.replace(robot, body_offset=robot.body_offset.clone())


def big_world(world, n=200, seed=7):
    """n spheres beside the tabletop world's boxes, moved to its device
    with .to(): a world above the kernel parameter block (768 floats)."""
    from tpustomp_torch.world.sdf import AnalyticWorld

    rng = np.random.default_rng(seed)
    spheres = [(tuple(rng.uniform(-0.8, 0.8, 3)), rng.uniform(0.05, 0.2))
               for _ in range(n)]
    return AnalyticWorld.make(spheres=spheres, boxes=[
        (tuple(b.tolist()), tuple(h.tolist()))
        for b, h in zip(world.box_center.cpu(), world.box_half.cpu())]).to(
            world.box_half.device)


def big_robot(dev, spheres_per_link=70):
    """arm_7dof with 70 spheres on each of its three long links (210
    bodies) on the runtime chain, moved to dev with .to(): a robot above
    the kernel parameter block."""
    from tpustomp_torch.robot.model import arm_7dof

    return dataclasses.replace(arm_7dof(spheres_per_link=spheres_per_link),
                               joint_static=None).to(dev)


def param_triggers(robot, world):
    """(label, robot, world) for each way a launch's parameters leave the
    3 KB parameter block of a robot and world moved with .to(): a world
    and a robot above it (200 spheres; 490 bodies), the world and the
    robot built on the card (no host copy), the world changed in place
    since it was moved (a stale host copy), and both moved under
    torch.inference_mode() (no version counter)."""
    dev = robot.joint_axis.device
    changed = world.to("cpu").to(dev)
    changed.box_half.mul_(1.0)                  # same values, new version
    with torch.inference_mode():
        inf_robot, inf_world = robot.to("cpu").to(dev), world.to(
            "cpu").to(dev)
    return [
        ("above_block:world", robot, big_world(world)),
        ("above_block:robot", big_robot(dev), world),
        ("made_on_card:world", robot, dataclasses.replace(
            world, box_half=world.box_half.clone())),
        ("made_on_card:robot", made_on_card(robot), world),
        ("changed_in_place", robot, changed),
        ("inference_mode", inf_robot, inf_world),
    ]


def check_kernel(label, rollout, robot, world, fulls, dt, clearance,
                 active=None, time_major=True, plain=None, cands_per_row=None):
    """The kernel against the plain version on the same inputs; returns the
    larger of the two max |Δ| over the checked rows."""
    C = fulls.shape[0]
    q_p, m_p = plain or rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row)
    x = fulls.permute(2, 1, 0).contiguous() if time_major else fulls
    q_k, m_k = rollout.obstacle_cost_batch(robot, world, x, dt, clearance,
                                           row_active=active,
                                           time_major=time_major,
                                           cands_per_row=cands_per_row)
    torch.cuda.synchronize()
    rows = (torch.ones(C, dtype=torch.bool, device=fulls.device)
            if active is None else active)
    dq = (q_k - q_p).abs()[rows]
    dm = (m_k - m_p).abs()[rows]
    ok = bool((dq <= Q_ATOL + Q_RTOL * q_p.abs()[rows]).all()
              and (dm <= M_ATOL).all())
    finite = bool(torch.isfinite(q_k).all() and torch.isfinite(m_k).all())
    out = dict(C=C, T=fulls.shape[1], rows_checked=int(rows.sum()),
               max_abs_dq=float(dq.max()), max_abs_dm=float(dm.max()),
               max_abs_q=float(q_p.abs().max()), tol=TOL, finite=finite)
    if active is not None:
        off = ~active
        zero_or_plain = bool(
            (((q_k[off] == 0) | ((q_k[off] - q_p[off]).abs()
                                 <= Q_ATOL + Q_RTOL * q_p[off].abs())).all())
            and (((m_k[off] == 0) | ((m_k[off] - m_p[off]).abs()
                                     <= M_ATOL)).all()))
        out.update(rows_inactive=int(off.sum()),
                   inactive_zero_or_plain=zero_or_plain)
        assert zero_or_plain, out
    say("kernel_vs_plain:" + label, **out)
    assert ok and finite, out
    return max(float(dq.max()), float(dm.max()))


def inactive_rows(C, dev):
    """About a third of the rows, in whole and partial 128-row runs."""
    blocks = torch.arange(C, device=dev) // 128
    within = torch.arange(C, device=dev) % 128
    return (blocks % 3 == 0) | ((blocks % 7 == 1) & (within < 64))


def dense_twin(world):
    """The same world with its grid's packed corner table dropped: the
    grid kernel then reads the dense grid."""
    from tpustomp_torch.world.sdf import CompositeWorld

    if isinstance(world, CompositeWorld):
        return dataclasses.replace(world, grid=dense_twin(world.grid))
    assert world.packed is not None, "the grid has no packed table"
    return dataclasses.replace(world, packed=None)


def packed_vs_dense(label, rollout, robot, world, tm, dt, clearance,
                    **kw):
    """The grid kernel through the packed corner table against the dense
    grid, on the same time-major input: bitwise equal (same corner values,
    same arithmetic). Returns the dense route's ms."""
    dense = dense_twin(world)
    q_p, m_p = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                           time_major=True, **kw)
    q_d, m_d = rollout.obstacle_cost_batch(robot, dense, tm, dt, clearance,
                                           time_major=True, **kw)
    same = bool(torch.equal(q_p, q_d) and torch.equal(m_p, m_d))
    say(f"kernel_vs_kernel:{label}:packed_vs_dense", rows=tm.shape[-1],
        bitwise_equal=same)
    assert same
    return cuda_time_ms(lambda: rollout.obstacle_cost_batch(
        robot, dense, tm, dt, clearance, time_major=True, **kw), 20)


# Config 3's CHOMP shape: every finalize and CHOMP step evaluates one
# candidate a scenario, C = B = 1,024 (candidate-major: the TPU's K4)
K4_SMALL_C = 1024
# Candidate-major launches (K4) of each kernel over the main-path phases
# (rollout.LAYOUTS, read with their launches)
K4_LAUNCHES = {}
# Launches of robots with unsorted bodies (the TPU's K1 / K2) of each kernel
# over the same phases (rollout.BODY_ORDER)
UNSORTED_LAUNCHES = {}
def chomp_grad_ops(rollout, robot, ns, nx, curvature=True, pinv=True):
    """Float operations of one waypoint of the CHOMP gradient kernel on
    the robot's static chain, counted from csrc/chomp_grad.cu: the FK
    (fk_ops); per body its placement (18), velocity and acceleration (12),
    speed (6), distance and gradient to each sphere (OPS_SPHERE + 4) and
    box (OPS_BOX + 6), potential and derivative (6), the curvature term
    (46; 9 without), the 3x3 adjugate solve (44); per Jacobian column of
    a body (joints up to its link) the column once (12), its part of
    J Jᵀ (12) and of Jᵀ f (6) (the column and Jᵀ f alone, 18, without the
    pseudo-inverse); the epilogue (3 d). What the function needs: the
    kernel forms each column a second time for Jᵀ f, which is not
    counted."""
    from benchmark.lib import roofline

    per_body = (18 + 12 + 6 + 6 + ns * (roofline.OPS_SPHERE + 4)
                + nx * (roofline.OPS_BOX + 6) + (46 if curvature else 9)
                + (44 if pinv else 0))
    columns = sum(link + 1 for link in robot.body_link.tolist())
    return (fk_ops(rollout, robot) + robot.num_bodies * per_body
            + columns * (30 if pinv else 18) + 3 * robot.num_joints)


def chomp_grad_phase(robot, world, cfg, smi, B=1024, seed=0):
    """Phase 2c: the CHOMP gradient kernel against its plain version at
    config 3's shape: θ from config 3's queries ± 0.03 rad along a
    perturbed path over the table; max |Δ| (absolute, and relative to
    each row's largest |∇U|); kernel and plain ms (CUDA events over a
    captured graph of 10 calls, median of 20 replays) beside the bound of
    its operations and bytes at benchmark/lib/roofline.py's peaks;
    resident blocks per SM; the library's first build. The plain version
    is engine/chomp.py's functional mode, the CPU's route."""
    from benchmark.lib import roofline
    from tpustomp_torch.costs.smoothness import smoothness_gradient
    from tpustomp_torch.dynamics.device import device_ops
    from tpustomp_torch.engine.chomp import obstacle_functional_gradient
    from tpustomp_torch.engine.trajectory import full_trajectory
    from tpustomp_torch.kernels import chomp_grad, rollout

    def plain(robot, world, theta, q0, qN, smooth, dt, clearance, w_o, w_s,
              curvature, pinv, ridge):
        return w_o * obstacle_functional_gradient(
            robot, world, full_trajectory(theta, q0, qN), dt, clearance,
            curvature, pinv, ridge) + w_s * smooth

    dev = robot.joint_axis.device
    N, d = cfg.num_timesteps, robot.num_joints
    rng = np.random.default_rng(seed)
    q0 = (np.asarray([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, d)))
    qN = (np.asarray([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, d)))
    u = np.linspace(0, 1, N + 2)[1:-1, None]
    theta = (q0[:, None] + u * (qN - q0)[:, None]
             + rng.normal(0, 0.1, (B, N, d)))
    theta[..., 1] += 0.35 * np.sin(np.pi * u[:, 0])
    theta, q0, qN = (torch.as_tensor(a.astype(np.float32), device=dev)
                     for a in (theta, q0, qN))
    ops = device_ops(N, cfg.dt, cfg.smoothness, dev)
    smooth = smoothness_gradient(ops, theta, q0, qN)
    args = (robot, world, theta, q0, qN, smooth, cfg.dt,
            cfg.collision_clearance, cfg.weights.obstacle,
            cfg.weights.smoothness, True, cfg.use_pseudo_inverse,
            cfg.pseudo_inverse_ridge_factor)
    chomp_grad.load(robot, world, theta)
    build_s = rollout.BUILD_SECONDS.get(
        ("chomp_grad", rollout.chain_of(robot), chomp_grad._definitions(world)))
    before = chomp_grad.LAUNCHES["chomp_grad"]
    got = chomp_grad.functional_gradient(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert chomp_grad.LAUNCHES["chomp_grad"] == before + 1
    max_abs = float((got - want).abs().max())
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    max_rel = float(((got - want).abs() / scale).max())
    ms = graph_time_ms(lambda: chomp_grad.functional_gradient(*args), 20)
    plain_ms = graph_time_ms(lambda: plain(*args), 20)
    ns = world.sphere_radius.shape[-1]
    nx = world.box_half.shape[-2]
    flops = B * (N + 2) * chomp_grad_ops(rollout, robot, ns, nx, True,
                                         cfg.use_pseudo_inverse)
    nbytes = 4 * (3 * B * N * d + 2 * B * d)   # θ, S read; ∇U written
    t_ops = flops / roofline.PEAK_FP32_OPS
    t_bytes = nbytes / roofline.PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    say("chomp_grad:config3", B=B, N=N, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
        pct_of_bound=100 * bound_ms / ms, max_abs_err=max_abs,
        max_rel_err=max_rel,
        resident_blocks=chomp_grad.occupancy(robot, world, theta),
        build_seconds=build_s, card=smi)
    assert max_rel <= 1e-4, max_rel
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=max_abs)


# The propose kernel's launches over each plan_batch and MPC phase, by label
PROPOSE_LAUNCHES = {}
# PI²'s tail kernel's launches over the same phases, by label
PI2_LAUNCHES = {}
# The CHOMP gradient kernel's launches over each plan and plan_batch phase,
# and the solver loop's iterations there (the most any row ran), by label
# ("plan:<label>" for plan)
CHOMP_GRAD_LAUNCHES = {}
LOOP_ITERATIONS = {}


def propose_phase(label, robot, B, N, K, Kr, smi, seed=0):
    """Phase 2p: the propose kernel against its plain version at one
    shape: θ and the reused rollouts spread past the robot's limits,
    per-row σ (HyperParams-like), a NaN in θ, in the noise and in a reused
    rollout. Bitwise (max |Δ| 0, NaNs in place); kernel and plain ms (CUDA
    events over a captured graph of 10 calls, median of 20 replays) beside
    the bound of the bytes it must move."""
    from tpustomp_torch.kernels import propose

    dev = robot.joint_axis.device
    d = robot.num_joints
    g = torch.Generator(dev).manual_seed(seed)
    lo, hi = robot.joint_lower, robot.joint_upper
    mid, half = (lo + hi) / 2, (hi - lo) / 2

    def spread(*shape):     # ±1.2 of the limits' half-width about their middle
        u = torch.rand(*shape, d, generator=g, device=dev) * 2.4 - 1.2
        return mid + half * u

    eps_raw = torch.randn(N, d, B, K, generator=g, device=dev)
    sigma = 0.2 * torch.rand(B, d, generator=g, device=dev) + 0.05
    theta, reuse = spread(B, N), spread(B, Kr, N)
    Q0, QN = spread(B), spread(B)
    theta[B - 1, N // 2, 1] = float("nan")
    reuse[0, Kr - 1, 3, 2] = float("nan")
    eps_raw[1, 2, B // 2, K - 1] = float("nan")
    args = (eps_raw, sigma, theta, reuse, Q0, QN, lo, hi,
            robot.joint_limited)
    before = propose.LAUNCHES["propose"]
    cand, full = propose.propose(*args)
    want_cand, want_full = propose.propose_plain(*args)
    torch.cuda.synchronize()
    assert propose.LAUNCHES["propose"] == before + 1

    def bits(t):
        return t.contiguous().view(torch.int32)

    bitwise = all(torch.equal(bits(a), bits(b)) for a, b in
                  ((cand, want_cand), (full, want_full)))
    max_err = max(float((a - b).nan_to_num().abs().max()) for a, b in
                  ((cand, want_cand), (full, want_full)))
    nan_in_place = all(torch.equal(a.isnan(), b.isnan()) for a, b in
                       ((cand, want_cand), (full, want_full)))
    # device time as the solver's graphs run it: one launch's host time
    # (≈ 70 µs) would hide the kernel's 3 µs at B = 1
    ms = graph_time_ms(lambda: propose.propose(*args), 20)
    plain_ms = graph_time_ms(lambda: propose.propose_plain(*args), 20)
    read = sum(t.numel() * t.element_size() for t in args)
    written = 4 * (cand.numel() + full.numel())
    bound_ms = 1e3 * (read + written) / PEAK_BYTES
    say(f"propose:{label}", B=B, N=N, K=K, Kr=Kr, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", read_mb=read / 1e6,
        written_mb=written / 1e6, pct_of_bound=100 * bound_ms / ms,
        max_abs_err=max_err, bitwise=bitwise, nan_in_place=nan_in_place,
        card=smi)
    assert bitwise and nan_in_place and max_err == 0.0, (max_err, bitwise)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def pi2_phase(label, B, N, K, smi, seed=0):
    """Phase 2π: PI²'s tail kernel at one shape (d 7, costs ≥ 0 with about
    60 % of them 0, one h a row, the cumulative cost) against its plain
    version and a float64 evaluation of the formula: max |Δ| to each
    over the finite entries, NaNs in place (a NaN cost in the last
    scenario); kernel and plain ms (CUDA events over a captured graph of
    10 calls, median of 20 replays) beside the bound of the bytes it must
    move."""
    from tpustomp_torch.kernels import pi2

    dev = torch.device("cuda")
    d, T = 7, N + 2
    g = torch.Generator(dev).manual_seed(seed)
    S_all = (2.0 * torch.rand(B, K + 1, T, generator=g, device=dev)
             * (torch.rand(B, K + 1, T, generator=g, device=dev) < 0.4))
    S_all[B - 1, 2, T // 2] = float("nan")
    theta = torch.randn(B, N, d, generator=g, device=dev)
    cand = (theta.permute(1, 2, 0)[..., None]
            + 0.3 * torch.randn(N, d, B, K + 1, generator=g, device=dev))
    h = 1.0 + 25.0 * torch.rand(B, generator=g, device=dev)
    args = (S_all, None, 0.0, True, cand[..., 1:], theta.permute(1, 2, 0), h)
    pi2.load(dev)
    before = pi2.LAUNCHES["pi2"]
    got = pi2.tail(*args)
    plain = pi2.tail_plain(*args)
    S = S_all.double()[:, 1:].flip(2).cumsum(2).flip(2)[:, :, 1:-1]
    lo, hi = S.amin(1, keepdim=True), S.amax(1, keepdim=True)
    e = torch.exp(-h.double()[:, None, None] * ((S - lo) / (hi - lo + 1e-8)))
    P = e / e.sum(1, keepdim=True)
    ref = (torch.einsum("bkn,ndbk->ndb", P, cand[..., 1:].double())
           - theta.permute(1, 2, 0).double() * P.sum(1).t()[:, None, :])
    torch.cuda.synchronize()
    assert pi2.LAUNCHES["pi2"] == before + 1
    finite = ~ref.isnan()
    nan_in_place = (torch.equal(got.isnan(), ref.isnan())
                    and torch.equal(got.isnan(), plain.isnan()))
    err = float((got.double() - ref)[finite].abs().max())
    plain_err = float((plain.double() - ref)[finite].abs().max())
    to_plain = float((got - plain)[finite].abs().max())
    ms = graph_time_ms(lambda: pi2.tail(*args), 20)
    plain_ms = graph_time_ms(lambda: pi2.tail_plain(*args), 20)
    # each byte once: S's noisy rows, the noisy slots, θ and h read, the
    # output written
    nbytes = 4 * (B * K * T + N * d * B * K + 2 * N * d * B + B)
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    say(f"pi2:{label}", B=B, N=N, K=K, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", mbytes=nbytes / 1e6,
        pct_of_bound=100 * bound_ms / ms, max_abs_err_float64=err,
        plain_max_abs_err_float64=plain_err, max_abs_to_plain=to_plain,
        nan_in_place=nan_in_place, plan=pi2._plan(
            B, K, T, d, torch.cuda.get_device_properties(0)
            .multi_processor_count), card=smi)
    assert nan_in_place and err <= max(2 * plain_err, 1e-4), (err,
                                                              plain_err)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                max_abs_err=err)


def kernel_phase(name, rollout, robot, world, fulls, dt, clearance, smi,
                 chains, smooth):
    """Phases 3 and 3g for one kernel: time-major with all rows active and
    masked, candidate-major (K4, staged by the kernel: at C and at
    K4_SMALL_C, bitwise the time-major launch, no other kernel in its
    window) and shuffled bodies; then kernel and plain times, and the
    kernel's on solver-like candidates (`smooth`, time-major), beside both
    chains' times from chain_phase (`chains`). Returns (max_err, ms,
    plain_ms, ms_smooth, the kernel_time line's timings)."""
    C = fulls.shape[0]
    plain = rollout.obstacle_cost_batch_plain(robot, world, fulls, dt,
                                              clearance)
    inactive = inactive_rows(C, fulls.device)
    unsorted = shuffled(robot, 0)
    err = max(
        check_kernel(f"{name}:all_active", rollout, robot, world, fulls, dt,
                     clearance, plain=plain),
        check_kernel(f"{name}:masked", rollout, robot, world, fulls, dt,
                     clearance, active=~inactive, plain=plain),
        check_kernel(f"{name}:unsorted_bodies", rollout, unsorted, world,
                     fulls, dt, clearance))
    tm = fulls.permute(2, 1, 0).contiguous()   # [d, T, C], as the solver hands it
    kernel_ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch(
        robot, world, tm, dt, clearance, row_active=None, time_major=True), 20)
    plain_ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance), 5)
    timing = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                  speedup=plain_ms / kernel_ms,
                  kernel_ms_smooth=cuda_time_ms(
                      lambda: rollout.obstacle_cost_batch(
                          robot, world, smooth, dt, clearance,
                          time_major=True), 20),
                  unsorted_bodies_ms=cuda_time_ms(
                      lambda: rollout.obstacle_cost_batch(
                          unsorted, world, tm, dt, clearance,
                          time_major=True), 20),
                  unsorted_bodies_plain_ms=cuda_time_ms(
                      lambda: rollout.obstacle_cost_batch_plain(
                          unsorted, world, fulls, dt, clearance), 5))
    if name == "rollout_grid":
        timing["dense_grid_ms"] = packed_vs_dense(name, rollout, robot,
                                                  world, tm, dt, clearance)
    # K4: the candidate-major input, staged by the kernel, at config 4's C
    # and at config 3's C = B = 1,024; bitwise the time-major launch, and
    # no kernel but the evaluator in its profiler window
    runtime = dataclasses.replace(robot, joint_static=None)
    small = fulls[:K4_SMALL_C]
    err = max(err, check_kernel(f"{name}:candidate_major", rollout, robot,
                                world, fulls, dt, clearance,
                                time_major=False, plain=plain),
              check_kernel(f"{name}:candidate_major:C={K4_SMALL_C}", rollout,
                           robot, world, small, dt, clearance,
                           time_major=False))
    same = all(torch.equal(a, b) for x in (fulls, small) for a, b in zip(
        rollout.obstacle_cost_batch(robot, world, x, dt, clearance),
        rollout.obstacle_cost_batch(robot, world, x.permute(2, 1, 0)
                                    .contiguous(), dt, clearance,
                                    time_major=True)))
    _, n_kernels, _, _ = device_window(lambda: rollout.obstacle_cost_batch(
        robot, world, fulls, dt, clearance))
    say(f"kernel_vs_kernel:{name}:candidate_major_vs_time_major",
        C=[C, K4_SMALL_C], bitwise_equal=same,
        kernels_in_candidate_major_call=n_kernels)
    assert same and n_kernels == 1, (same, n_kernels)
    small_tm = small.permute(2, 1, 0).contiguous()
    for tag, r in (("", robot), ("_runtime", runtime)):
        timing[f"candidate_major{tag}_ms"] = cuda_time_ms(
            lambda: rollout.obstacle_cost_batch(r, world, fulls, dt,
                                                clearance), 20)
    timing[f"candidate_major_ms_C{K4_SMALL_C}"] = cuda_time_ms(
        lambda: rollout.obstacle_cost_batch(robot, world, small, dt,
                                            clearance), 20)
    timing[f"time_major_ms_C{K4_SMALL_C}"] = cuda_time_ms(
        lambda: rollout.obstacle_cost_batch(robot, world, small_tm, dt,
                                            clearance, time_major=True), 20)
    say(f"kernel_time:{name}", **timing, static_ms=chains["static_ms"],
        runtime_ms=chains["runtime_ms"], card=smi)
    return err, kernel_ms, plain_ms, timing["kernel_ms_smooth"], timing


# Waypoint counts at the lane plan's edges (windows of 30 owned lanes) and
# a ragged batch that still takes 7-8 candidates a block: windows cross
# candidate boundaries at every T that is not a multiple of 30.
EDGE_TS = (2, 3, 31, 32, 33, 101, 102, 103)
EDGE_C = 4229
# A world above the large parameter block (1,950 spheres: 7,956 floats
# with arm_7dof), checked on fewer candidates (its plain version holds a
# [C·T·12, 1,950] distance table)
ABOVE_LARGE_SPHERES, ABOVE_LARGE_C = 1950, 512


def edges_phase(rollout, robot, world, grid, smi):
    """Phase 3e: K3 and K5 and their :ee forms against the plain version at
    the lane plan's edges (EDGE_TS, EDGE_C, a third of the rows masked:
    zeros there), on the static and the runtime chain; then the parameter
    routes (kernels/rollout.py param_route): a world, an overlay and a
    robot above the 3 KB parameter block (the large block), a world and a
    robot built on the card, a world changed in place since it was moved,
    K1 and K2 sorted on the card (the memory path at a set's first launch,
    then the block, after one device read), both
    moved under inference_mode and a world above the large block (the
    memory path, csrc/rollout_common.cuh ParamPtr): each against plain,
    counted on its route, timed beside the route it took before (all the
    memory path). Returns the largest max |Δ| of q_obs and margin at the
    edges (the routes', on other robots and worlds, stay in their own
    lines)."""
    dev = robot.joint_axis.device
    runtime = dataclasses.replace(robot, joint_static=None)
    active = ~inactive_rows(EDGE_C, dev)
    active[:3] = torch.tensor([False, True, False])
    worst = 0.0

    def check(label, r, w, fulls, dt, mask, ee):
        x = fulls.permute(2, 1, 0).contiguous()
        got = rollout.obstacle_cost_batch(r, w, x, dt, 0.05, row_active=mask,
                                          time_major=True, want_ee=ee)
        ref = rollout.obstacle_cost_batch_plain(r, w, fulls, dt, 0.05,
                                                want_ee=ee)
        torch.cuda.synchronize()
        rows = (torch.ones(fulls.shape[0], dtype=torch.bool, device=dev)
                if mask is None else mask)
        dq = (got[0] - ref[0]).abs()[rows]
        dm = (got[1] - ref[1]).abs()[rows]
        ok = bool((dq <= Q_ATOL + Q_RTOL * ref[0].abs()[rows]).all()
                  and (dm <= M_ATOL).all())
        err = max(float(dq.max()), float(dm.max()))
        dee = None
        if ee:
            de = (got[2] - ref[2]).abs()[:, :, rows]
            ok = ok and bool((de <= EE_ATOL + EE_RTOL
                              * ref[2][:, :, rows].abs()).all())
            dee = float(de.max())
        if mask is not None:
            ok = ok and all(bool((g[..., ~mask] == 0).all()) if g.dim() == 3
                            else bool((g[~mask] == 0).all()) for g in got)
        assert ok, (label, err, dee)
        return err, dee

    for name, w in (("rollout_analytic", world), ("rollout_grid", grid)):
        errs, ee_errs = {}, {}
        for T in EDGE_TS:
            fulls = torch.as_tensor(np.random.default_rng(T).uniform(
                robot.joint_lower.cpu().numpy(),
                robot.joint_upper.cpu().numpy(),
                (EDGE_C, T, 7)).astype(np.float32), device=dev)
            dt = 5.0 / (T - 1)
            got = [check(f"{name}:{T}:{chain}:{ee}", r, w, fulls, dt, mask,
                         ee)
                   for chain, r in (("static", robot), ("runtime", runtime))
                   for ee, mask in ((False, None), (True, active))]
            errs[T] = max(e for e, _ in got)
            ee_errs[T] = max(de for _, de in got if de is not None)
        worst = max(worst, *errs.values())
        say(f"kernel_vs_plain:{name}:edges", C=EDGE_C, T=list(EDGE_TS),
            max_abs_by_T=errs, max_abs_ee_by_T=ee_errs,
            chains=["static", "runtime"],
            forms=["costs", "ee masked"], tol=TOL,
            ee_tol=f"{EE_ATOL}+{EE_RTOL}|ee|", ok=True)
    # the parameter routes: every way a launch leaves the 3 KB block of a
    # robot and world moved with .to() (each of them the memory path in
    # the version before the large block and the device read), on the
    # route it takes now; and K1 / K2 sorted on the card
    from tpustomp_torch.world.sdf import CompositeWorld

    route_of = {"above_block": "large_block", "made_on_card": "block",
                "changed_in_place": "block", "inference_mode": "memory"}
    unsorted = made_on_card(shuffled(robot, 0))
    cases = [("rollout_analytic", label, r, w, route_of[label.split(":")[0]])
             for label, r, w in param_triggers(robot, world)] + [
        ("rollout_grid", "above_block:overlay", robot,
         CompositeWorld(grid=grid, overlay=big_world(world)), "large_block"),
        ("rollout_analytic", "made_on_card:unsorted_robot", unsorted, world,
         "block"),
        ("rollout_grid", "made_on_card:unsorted_robot", unsorted, grid,
         "block"),
        ("rollout_analytic", "above_large_block", robot,
         big_world(world, n=ABOVE_LARGE_SPHERES), "memory")]
    fulls = torch.as_tensor(np.random.default_rng(11).uniform(
        robot.joint_lower.cpu().numpy(), robot.joint_upper.cpu().numpy(),
        (EDGE_C, 33, 7)).astype(np.float32), device=dev)
    x = fulls.permute(2, 1, 0).contiguous()
    for name, label, r, w, route in cases:
        # the set above the large block: 1,950 spheres a body, fewer rows
        C = ABOVE_LARGE_C if label == "above_large_block" else EDGE_C
        n = len(rollout.pack_params(r, w))
        read0 = rollout.PARAM_READS["device"]
        # a set without host copies: its first launch on the memory path
        # (no host sync), its second reads it once, then none
        device_set = route != "memory" and label.startswith(
            ("made_on_card", "changed_in_place"))
        for ee, mask in ((False, None), (True, active)):
            before = dict(rollout.PARAM_ROUTES)
            err, dee = check(f"{name}:{label}", r, w, fulls[:C], 5.0 / 32,
                             None if mask is None else mask[:C], ee)
            routes = {k: rollout.PARAM_ROUTES[k] - before[k]
                      for k in before}
            took = "memory" if device_set and not ee else route
            ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch(
                r, w, x[..., :C], 5.0 / 32, 0.05,
                row_active=None if mask is None else mask[:C],
                time_major=True, want_ee=ee), 20)
            say(f"kernel_vs_plain:{name}:param_route:{label}"
                + (":ee" if ee else ""), C=C, T=33, n_params=n,
                param_block_floats=rollout._PARAM_FLOATS,
                large_block_floats=rollout._LARGE_PARAM_FLOATS,
                route=route, checked_launch_route=took,
                parent_route="memory", routes=routes,
                device_reads=rollout.PARAM_READS["device"] - read0,
                max_abs=err, max_abs_ee=dee, tol=TOL, ms=ms, card=smi)
            assert routes == {k: int(k == took) for k in routes}, routes
        reads = rollout.PARAM_READS["device"] - read0
        assert reads == int(device_set), (label, reads)
    del fulls, x
    torch.cuda.empty_cache()
    return worst


def replayed(graph):
    """The run since graph.reset_counts() replayed the solver's CUDA graphs
    (engine/graph.py) on the chunk route (the loop's condition and draws
    on the device): a main path that stayed eager, or that replayed one
    iteration a replay, fails the smoke."""
    assert graph.GRAPHS["replayed"] > 0, dict(graph.GRAPHS)
    assert graph.GRAPHS["chunk"] > 0, dict(graph.GRAPHS)
    assert not any(k.startswith("per_iteration") for k in graph.GRAPHS), \
        dict(graph.GRAPHS)


def timed_plan_batch(rollout, robot, world, cfg, q0b, qNb, **kw):
    """plan_batch after a 16-row warm-up; the launch counts are set to 0
    just before the timed run and read just after, and the run must have
    replayed its CUDA graph. Returns (Solution, wall s, launches)."""
    from tpustomp_torch import ProblemSpec, plan_batch
    from tpustomp_torch.engine import graph

    dev = robot.joint_axis.device
    plan_batch(robot, world, ProblemSpec(q0=q0b[:16], qN=qNb[:16]), cfg,
               device=dev, generator=torch.Generator(dev).manual_seed(1),
               **kw)
    torch.cuda.synchronize()
    rollout.reset_launches()
    graph.reset_counts()
    t0 = time.perf_counter()
    sol = plan_batch(robot, world, ProblemSpec(q0=q0b, qN=qNb), cfg,
                     device=dev, generator=torch.Generator(dev).manual_seed(0),
                     **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in rollout.LAUNCHES.items() if v}
    replayed(graph)
    B, T, d = q0b.shape[0], cfg.num_timesteps + 2, q0b.shape[1]
    assert sol.trajectory.shape == (B, T, d), sol.trajectory.shape
    assert bool(torch.isfinite(sol.trajectory).all()
                and torch.isfinite(sol.cost).all()), "non-finite solution"
    return sol, wall, launches


def plan_batch_phase(label, kernel, rollout, robot, world, cfg4, q0b, qNb,
                     smi, success_floor, exact_world=None):
    """Phases 4/4g/8/9: plan_batch at B = len(q0b), checks on every solved
    row. Returns the kernel's launches over the run."""
    from tpustomp_torch.engine.trajectory import wrap_goal

    dev = robot.joint_axis.device
    B, d = q0b.shape
    T = cfg4.num_timesteps + 2
    dt, clearance = cfg4.dt, cfg4.collision_clearance
    from tpustomp_torch.kernels import chomp_grad, pi2, propose

    sol, wall, launches = timed_plan_batch(rollout, robot, world, cfg4, q0b,
                                           qNb)
    PROPOSE_LAUNCHES[label] = propose.LAUNCHES["propose"]
    PI2_LAUNCHES[label] = pi2.LAUNCHES["pi2"]
    CHOMP_GRAD_LAUNCHES[label] = chomp_grad.LAUNCHES["chomp_grad"]
    LOOP_ITERATIONS[label] = int(sol.iterations.max())
    # the robot and world came to the card by .to(): every launch takes the
    # parameter block, none the memory path
    routes = dict(rollout.PARAM_ROUTES)
    assert routes["memory"] == 0 and routes["block"] > 0, routes
    # from the host copies: no launch read the device (no host sync)
    assert rollout.PARAM_READS["device"] == 0, rollout.PARAM_READS
    # the candidate-major launches are the TPU's K4 (the solver's
    # _evaluate: finalize, CHOMP steps)
    layouts = dict(rollout.LAYOUTS)
    K4_LAUNCHES[kernel] = (K4_LAUNCHES.get(kernel, 0)
                           + layouts["candidate_major"])
    UNSORTED_LAUNCHES[kernel] = (UNSORTED_LAUNCHES.get(kernel, 0)
                                 + rollout.BODY_ORDER["unsorted"])
    traj, succ, iters = sol.trajectory, sol.success, sol.iterations
    assert traj.shape == (B, T, d) and succ.shape == (B,), traj.shape
    assert bool(torch.isfinite(traj).all() and torch.isfinite(sol.cost).all())
    success_rate = float(succ.float().mean())
    say(f"plan_batch:{label}", B=B, wall_s=wall, solves_per_s=B / wall,
        success_rate=success_rate, mean_iterations=float(iters.float().mean()),
        max_iterations=int(iters.max()), kernel_launches=launches,
        propose_launches=PROPOSE_LAUNCHES[label],
        chomp_grad_launches=CHOMP_GRAD_LAUNCHES[label], param_routes=routes,
        layouts=layouts, card=smi)
    assert launches.get(kernel, 0) >= int(iters.max()), launches
    assert sum(launches.values()) == launches[kernel], launches
    assert success_rate >= success_floor, success_rate
    q0t = torch.as_tensor(q0b, device=dev)
    qNt = wrap_goal(q0t, torch.as_tensor(qNb, device=dev),
                    robot.joint_limited)
    solved = traj[succ]
    assert torch.allclose(solved[:, 0], q0t[succ], atol=1e-5, rtol=0)
    assert torch.allclose(solved[:, -1], qNt[succ], atol=1e-5, rtol=0)
    lim = robot.joint_limited
    inside = ((solved >= robot.joint_lower - 1e-6)
              & (solved <= robot.joint_upper + 1e-6)) | ~lim
    assert bool(inside.all()), "joint limits violated"
    _, margins = rollout.obstacle_cost_batch_plain(robot, world, solved, dt,
                                                   clearance)
    assert bool((margins > cfg4.collision_threshold - M_ATOL).all()), \
        float(margins.min())
    checks = dict(solved=int(succ.sum()),
                  min_final_margin=float(margins.min()), endpoints="ok",
                  joint_limits="ok")
    if exact_world is not None:
        # the grid has voxel-scale error: hold solved rows to the exact box
        # SDF with one voxel of slack, as tests/integration/test_config2.py
        _, exact = rollout.obstacle_cost_batch_plain(
            robot, exact_world, solved, dt, clearance)
        checks["min_exact_margin"] = float(exact.min())
        assert bool((exact > -0.025).all()), float(exact.min())
    say(f"plan_batch:{label}:checks", **checks)
    return launches[kernel]


def cuda_vs_cpu_phase(label, robot, world, cfg4, q0b, qNb):
    """The same slice on a small input: card (kernel) vs CPU (plain version)
    under the same noise."""
    from tpustomp_torch import ProblemSpec, plan_batch

    dev = robot.joint_axis.device
    small = cfg4.replace(max_iterations=10)
    Bs, K, N = 8, small.num_rollouts, small.num_timesteps
    z = np.random.default_rng(1).standard_normal(
        (small.max_iterations, robot.num_joints, Bs, K, N)).astype(np.float32)

    def bank(device):
        return lambda it, active: torch.from_numpy(z[it]).to(device)

    prob = ProblemSpec(q0=q0b[:Bs], qN=qNb[:Bs])
    ref = plan_batch(robot.to("cpu"), world.to("cpu"), prob, small,
                     device="cpu", noise_fn=bank("cpu"))
    got = plan_batch(robot, world, prob, small, device=dev,
                     noise_fn=bank(dev)).to("cpu")
    d_traj = float((got.trajectory - ref.trajectory).abs().max())
    d_cost = float(((got.cost - ref.cost).abs() / ref.cost.abs()).max())
    same = (torch.equal(got.success, ref.success)
            and torch.equal(got.iterations, ref.iterations))
    say(f"plan_batch:cuda_vs_cpu:{label}", B=Bs, max_abs_dtraj=d_traj,
        max_rel_dcost=d_cost, success_and_iterations_equal=same)
    assert same and d_traj <= 1e-4 and d_cost <= 1e-4


def plan_phase(label, kernel, rollout, robot, world, cfg2, scene, smi):
    """Phase 5/5g: one config-2 query through plan; asserts success and
    that the solver loop replayed its CUDA graph."""
    from tpustomp_torch import ProblemSpec, plan
    from tpustomp_torch.engine import graph
    from tpustomp_torch.kernels import chomp_grad

    dev = robot.joint_axis.device
    q0 = np.asarray(scene["q0"], np.float32)
    qN = np.asarray(scene["qN"], np.float32)
    launches0 = rollout.LAUNCHES[kernel]
    grads0 = chomp_grad.LAUNCHES["chomp_grad"]
    graph.reset_counts()
    t0 = time.perf_counter()
    one = plan(robot, world, ProblemSpec(q0=q0, qN=qN), cfg2, device=dev,
               generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replayed(graph)
    key = f"plan:{label}"
    CHOMP_GRAD_LAUNCHES[key] = chomp_grad.LAUNCHES["chomp_grad"] - grads0
    LOOP_ITERATIONS[key] = int(one.iterations)
    say(f"plan:{label}", success=bool(one.success),
        restarts=cfg2.num_restarts, iterations=int(one.iterations),
        cost=float(one.cost), wall_s=wall,
        kernel_launches=rollout.LAUNCHES[kernel] - launches0,
        chomp_grad_launches=CHOMP_GRAD_LAUNCHES[key], card=smi)
    assert bool(one.success), f"{label} plan failed"
    assert one.trajectory.shape == (cfg2.num_timesteps + 2, 7)


def config5_states(robot, cfg5, B, q0, qN, speed, seed=0):
    """Scenarios seeded as bench/mpc_bench.py:64-85: start and goal jittered
    by +-0.03 rad, one sphere starting outside the arm's envelope and moving
    at `speed` in a random direction."""
    from tpustomp_torch.engine.mpc import init_mpc

    rng = np.random.default_rng(seed)
    Q0 = np.tile(q0, (B, 1)) + rng.uniform(-0.03, 0.03, (B, 7))
    QN = np.tile(qN, (B, 1)) + rng.uniform(-0.03, 0.03, (B, 7))
    centers = np.stack([rng.uniform(0.9, 1.2, B), rng.uniform(-0.6, 0.6, B),
                        rng.uniform(0.3, 0.8, B)], axis=1)[:, None, :]
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    vels = (-dirs * speed)[:, None, :]
    return init_mpc(robot, cfg5, Q0, QN, centers, vels)


def solver_like(robot, cfg5, states, per, seed=5):
    """Config-5 candidates as the solver draws them: each scenario's
    min-jerk plan between its start and goal plus sigma L z (the config's
    sigma, the sampling factor L, z from a seeded generator on the card),
    clipped to the joint limits, with the endpoints: [B * per, N + 2, d]."""
    from tpustomp_torch.dynamics.device import device_ops
    from tpustomp_torch.engine.sampling import sample_noise_tm
    from tpustomp_torch.engine.trajectory import full_trajectory, min_jerk_init

    dev = robot.joint_axis.device
    q0, qN = states.q.to(dev), states.qN.to(dev)
    B, d = q0.shape
    N = cfg5.num_timesteps
    L = device_ops(N, cfg5.dt, cfg5.smoothness, dev).L_sample
    z = torch.randn((d, B, per, N), generator=torch.Generator(
        dev).manual_seed(seed), device=dev)
    sigma = torch.full((B, d), cfg5.noise.stddev, device=dev)
    eps = sample_noise_tm(z, L, sigma).permute(2, 3, 0, 1)   # [B, per, N, d]
    theta = min_jerk_init(q0, qN, N)[:, None] + eps
    theta = torch.where(robot.joint_limited, torch.clamp(
        theta, robot.joint_lower, robot.joint_upper), theta)
    ends = [x[:, None].expand(B, per, d) for x in (q0, qN)]
    return full_trajectory(theta, *ends).reshape(B * per, N + 2, d)


def shared_row(world):
    """Row 0 of a world with a row axis, as a world shared by every
    candidate."""
    from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

    over = world.overlay if isinstance(world, CompositeWorld) else world
    row = AnalyticWorld(**{f: getattr(over, f)[0]
                           for f in AnalyticWorld.__dataclass_fields__})
    return (CompositeWorld(grid=world.grid, overlay=row)
            if isinstance(world, CompositeWorld) else row)


def percand_phase(name, rollout, robot, static, centers, radius, fulls,
                  smooth, per, dt, clearance, smi, chains):
    """Phase 3m for one variant: the tick's world of config 5 (one row per
    scenario, `per` candidates each) against the plain version, all rows
    active and masked, and on solver-like candidates (`smooth`); the
    per-candidate form (every candidate its own row) and every row equal
    against the shared-world kernel, both bitwise, and for the grid the
    packed corner table against the dense grid; kernel and plain times,
    beside both chains' times from chain_phase (`chains`). Returns
    (max_err, ms, plain_ms, ms_smooth)."""
    from tpustomp_torch.engine.mpc import _tick_world_batch

    C = fulls.shape[0]
    world = _tick_world_batch(centers, radius, static)
    plain = rollout.obstacle_cost_batch_plain(robot, world, fulls, dt,
                                              clearance, cands_per_row=per)
    err = max(
        check_kernel(f"{name}:all_active", rollout, robot, world, fulls, dt,
                     clearance, plain=plain, cands_per_row=per),
        check_kernel(f"{name}:masked", rollout, robot, world, fulls, dt,
                     clearance, active=~inactive_rows(C, fulls.device),
                     plain=plain, cands_per_row=per))
    del plain
    err = max(err, check_kernel(f"{name}:solver_like", rollout, robot, world,
                                smooth, dt, clearance, cands_per_row=per))
    tm = fulls.permute(2, 1, 0).contiguous()

    def run(w, per_row=None):
        return rollout.obstacle_cost_batch(robot, w, tm, dt, clearance,
                                           time_major=True,
                                           cands_per_row=per_row)

    q_g, m_g = run(world, per)
    q_c, m_c = run(_tick_world_batch(centers.repeat_interleave(per, 0),
                                     radius, static))
    contract = bool(torch.equal(q_c, q_g) and torch.equal(m_c, m_g))
    say(f"kernel_vs_kernel:{name}:per_candidate_vs_grouped",
        rows=C, bitwise_equal=contract)
    same = _tick_world_batch(centers[:1].expand_as(centers), radius, static)
    q_r, m_r = run(same, per)
    # the shared row as a user's .to() brings it: the parameter block
    shared = shared_row(same).to("cpu").to(fulls.device)
    q_s, m_s = run(shared)
    vs_shared = bool(torch.equal(q_r, q_s) and torch.equal(m_r, m_s))
    say(f"kernel_vs_kernel:{name}:every_row_equal_vs_shared",
        rows=C // per, bitwise_equal=vs_shared)
    assert contract and vs_shared
    kernel_ms = cuda_time_ms(lambda: run(world, per), 20)
    tm_smooth = smooth.permute(2, 1, 0).contiguous()
    # the shared row built on the card (no host copy): the block, after one
    # read of its device vector (the memory path before it)
    made = shared_row(same)
    timing = dict(
        C=C, T=fulls.shape[1], cands_per_row=per, kernel_ms=kernel_ms,
        kernel_ms_smooth=cuda_time_ms(lambda: rollout.obstacle_cost_batch(
            robot, world, tm_smooth, dt, clearance, time_major=True,
            cands_per_row=per), 20),
        shared_world_kernel_ms=cuda_time_ms(lambda: run(shared), 20),
        shared_world_built_on_card_ms=cuda_time_ms(lambda: run(made), 20),
        plain_ms=cuda_time_ms(lambda: rollout.obstacle_cost_batch_plain(
            robot, world, fulls, dt, clearance, cands_per_row=per), 5))
    if name.startswith("rollout_grid"):
        timing["dense_grid_ms"] = packed_vs_dense(
            name, rollout, robot, world, tm, dt, clearance,
            cands_per_row=per)
    timing["speedup"] = timing["plain_ms"] / kernel_ms
    say(f"kernel_time:{name}", **timing, static_ms=chains["static_ms"],
        runtime_ms=chains["runtime_ms"], card=smi)
    return err, kernel_ms, timing["plain_ms"], timing["kernel_ms_smooth"]


def mpc_phase(label, variant, rollout, robot, cfg5, spec, static, states,
              ticks, smi):
    """Phase 6/6g: run_mpc_batch over every scenario of `states` for
    `ticks` ticks after a small warm-up; reports and checks the episode,
    which must have replayed its tick's CUDA graphs. Returns the variant's
    launches over the run, the collision rate and the final state (on the
    CPU)."""
    from tpustomp_torch._tensors import map_tensors
    from tpustomp_torch.engine import graph, mpc
    from tpustomp_torch.engine.mpc import run_mpc_batch
    from tpustomp_torch.kernels import pi2, propose

    dev = robot.joint_axis.device
    B = states.q.shape[0]
    world_dt = float(spec["world_dt"])
    radius = [0.12]
    run_mpc_batch(robot, cfg5, map_tensors(states, lambda v: v[:16]), radius,
                  2, world_dt, static_world=static, device=dev,
                  generator=torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()

    rollout.reset_launches()
    graph.reset_counts()
    mpc.NOISE_DRAWS.update(used=0, padded=0)
    t0 = time.perf_counter()
    out = run_mpc_batch(robot, cfg5, states, radius, ticks, world_dt,
                        static_world=static, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    PROPOSE_LAUNCHES[label] = propose.LAUNCHES["propose"]
    PI2_LAUNCHES[label] = pi2.LAUNCHES["pi2"]
    # the episode replayed its tick's graphs, captured in its first tick
    replayed(graph)
    graphs = dict(graph.GRAPHS)
    assert graphs["captured"] == 3, graphs
    launches = dict(rollout.LAUNCHES)
    layouts = dict(rollout.LAYOUTS)           # candidate-major: the flush
    K4_LAUNCHES[variant] = (K4_LAUNCHES.get(variant, 0)
                            + layouts["candidate_major"])
    UNSORTED_LAUNCHES[variant] = (UNSORTED_LAUNCHES.get(variant, 0)
                                  + rollout.BODY_ORDER["unsorted"])
    draws = dict(mpc.NOISE_DRAWS)
    draw_mb = (states.q.shape[1] * B * cfg5.num_rollouts
               * cfg5.num_timesteps * 4 / 1e6)
    out = out.to("cpu")
    reached = out.reached_tick.numpy()
    collision_rate = float(out.collided.float().mean())
    drift = float((out.sphere_center - (states.sphere_center + ticks * world_dt
                                        * states.sphere_vel)).abs().max())
    finite = all(bool(torch.isfinite(getattr(out, f)).all())
                 for f in ("q", "qN", "theta", "sphere_center", "sphere_vel"))
    say(f"mpc:{label}", B=B, ticks=ticks, wall_s=wall,
        replans_per_s=B * ticks / wall, ms_per_tick=1e3 * wall / ticks,
        collision_rate=collision_rate,
        reached_rate=float((reached >= 0).mean()),
        median_ticks_to_goal=(float(np.median(reached[reached >= 0]))
                              if (reached >= 0).any() else None),
        mean_goal_distance=float((out.q - out.qN).norm(dim=1).mean()),
        kernel_launches=launches, launches_per_tick=launches[variant] / ticks,
        propose_launches=PROPOSE_LAUNCHES[label], layouts=layouts,
        noise_draws_used=draws["used"], noise_draws_padded=draws["padded"],
        padded_draw_mb=draws["padded"] * draw_mb,
        max_obstacle_drift=drift, finite=finite, graph_counts=graphs,
        graphs=graph.cached()[-1:], card=smi)
    assert out.steps.tolist() == [ticks] * B, "steps != ticks"
    assert draws["used"] + draws["padded"] == ticks * cfg5.max_iterations
    assert drift <= 1e-4, drift
    assert finite
    assert launches[variant] >= ticks, launches
    assert sum(launches.values()) == launches[variant], launches
    return launches[variant], collision_rate, out


def mpc_cuda_vs_cpu_phase(label, robot, cfg5, static, states, ticks=4):
    """Phase 6c: batched MPC on the card against the CPU run under the same
    numpy noise bank."""
    from tpustomp_torch.engine.mpc import run_mpc_batch

    dev = robot.joint_axis.device
    B, d = states.q.shape
    z = np.random.default_rng(2).standard_normal(
        (ticks, cfg5.max_iterations, d, B, cfg5.num_rollouts,
         cfg5.num_timesteps)).astype(np.float32)

    def bank(device):
        return lambda tick, it, active: torch.from_numpy(
            z[tick, it]).to(device)

    cpu_static = None if static is None else static.to("cpu")
    ref = run_mpc_batch(robot.to("cpu"), cfg5, states, [0.12], ticks, 0.1,
                        static_world=cpu_static, device="cpu",
                        noise_fn=bank("cpu"))
    got = run_mpc_batch(robot, cfg5, states, [0.12], ticks, 0.1,
                        static_world=static, device=dev,
                        noise_fn=bank(dev)).to("cpu")
    d_q = float((got.q - ref.q).abs().max())
    d_theta = float((got.theta - ref.theta).abs().max())
    same = (torch.equal(got.collided, ref.collided)
            and torch.equal(got.reached_tick, ref.reached_tick)
            and torch.equal(got.steps, ref.steps))
    say(f"mpc:cuda_vs_cpu:{label}", B=B, ticks=ticks, max_abs_dq=d_q,
        max_abs_dtheta=d_theta, collided_reached_steps_equal=same)
    assert same and d_q <= 1e-4 and d_theta <= 1e-4


def ee_phase(variant, rollout, robot, world, fulls, dt, clearance, smi,
             chains, cands_per_row=None, smooth=None):
    """Phase 7 for one variant's :ee form: with a third of the rows masked,
    ee against the plain fk_frames frame, zeros on masked rows, q_obs and
    margin bitwise equal to the same launch without ee and close to the
    plain version; then ee, no-ee and plain times, and the ee time on
    solver-like candidates (`smooth`, time-major, where given), beside both
    chains' times from chain_phase (`chains`). Returns (max_err, ms,
    plain_ms, ms_smooth or None)."""
    C = fulls.shape[0]
    tm = fulls.permute(2, 1, 0).contiguous()
    active = ~inactive_rows(C, fulls.device)
    kw = dict(time_major=True, cands_per_row=cands_per_row)
    q, m, ee = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                           row_active=active, want_ee=True,
                                           **kw)
    q0, m0 = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                         row_active=active, **kw)
    q_p, m_p, ee_p = rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row,
        want_ee=True)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(q, q0) and torch.equal(m, m0))
    de = (ee - ee_p).abs()[:, :, active]
    ee_ok = bool((de <= EE_ATOL + EE_RTOL * ee_p[:, :, active].abs()).all())
    masked_zero = bool((ee[:, :, ~active] == 0).all())
    dq = (q - q_p).abs()[active]
    dm = (m - m_p).abs()[active]
    q_ok = bool((dq <= Q_ATOL + Q_RTOL * q_p.abs()[active]).all()
                and (dm <= M_ATOL).all())
    out = dict(C=C, T=fulls.shape[1], rows_checked=int(active.sum()),
               rows_masked=int((~active).sum()), max_abs_dee=float(de.max()),
               ee_tol=f"{EE_ATOL}+{EE_RTOL}|ee|", ee_ok=ee_ok,
               masked_rows_zero=masked_zero,
               q_margin_bitwise_equal_without_ee=bitwise,
               max_abs_dq=float(dq.max()), max_abs_dm=float(dm.max()),
               tol=TOL, finite=bool(torch.isfinite(ee).all()))
    say(f"kernel_vs_plain:{variant}:ee", **out)
    assert ee_ok and masked_zero and bitwise and q_ok and out["finite"], out
    del q_p, m_p, ee_p, de
    ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch(
        robot, world, tm, dt, clearance, want_ee=True, **kw), 20)
    no_ee_ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch(
        robot, world, tm, dt, clearance, **kw), 20)
    plain_ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row,
        want_ee=True), 3)
    ms_smooth = None if smooth is None else cuda_time_ms(
        lambda: rollout.obstacle_cost_batch(robot, world, smooth, dt,
                                            clearance, want_ee=True, **kw),
        20)
    say(f"kernel_time:{variant}:ee", C=C, T=fulls.shape[1], ee_ms=ms,
        no_ee_ms=no_ee_ms, plain_ms=plain_ms, ee_cost_ms=ms - no_ee_ms,
        ee_ms_smooth=ms_smooth, static_ms=chains["static_ms"],
        runtime_ms=chains["runtime_ms"], card=smi)
    torch.cuda.empty_cache()
    return max(float(dq.max()), float(dm.max()), out["max_abs_dee"]), ms, \
        plain_ms, ms_smooth


def con_check(label, rollout, robot, world, fulls, dt, clearance, cons,
              active, cands_per_row=None, tag=""):
    """One :con launch (a third of the rows masked) against: the launch
    without constraints (q_obs and margin bitwise), the plain tail on the
    same launch's :ee frame (CON_RTOL, CON_ATOL_PER_WEIGHT: only acosf
    differs), the plain version on fk_frames (q_con_tolerance, derived from
    the ee gate), zeros on masked rows. Returns the largest |Δ| of q_obs,
    margin and q_con against the plain version."""
    from tpustomp_torch.costs.constraints import constraint_cost_tm

    tm = fulls.permute(2, 1, 0).contiguous()
    kw = dict(row_active=active, time_major=True, cands_per_row=cands_per_row)
    q, m, q_con = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                              constraints=cons, **kw)
    q0, m0 = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                         **kw)
    _, _, ee = rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                           want_ee=True, **kw)
    q_p, m_p, ee_p = rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row,
        want_ee=True)
    own = constraint_cost_tm(robot, cons, ee)
    ref = constraint_cost_tm(robot, cons, ee_p)
    tol = q_con_tolerance(robot, cons, ee_p)
    del ee, ee_p
    torch.cuda.synchronize()
    weight = sum(float(c.weight) for c in cons)
    d_own = (q_con - own).abs()[active]
    own_ok = bool((d_own <= CON_ATOL_PER_WEIGHT * weight
                   + CON_RTOL * own.abs()[active]).all())
    d_ref = (q_con - ref).abs()
    ref_ok = bool((d_ref <= tol)[active].all())
    dq, dm = (q - q_p).abs()[active], (m - m_p).abs()[active]
    q_ok = bool((dq <= Q_ATOL + Q_RTOL * q_p.abs()[active]).all()
                and (dm <= M_ATOL).all())
    out = dict(C=fulls.shape[0], T=fulls.shape[1],
               constraints=[type(c).__name__ for c in cons],
               rows_checked=int(active.sum()),
               rows_masked=int((~active).sum()),
               max_abs_dq_con_vs_own_ee_tail=float(d_own.max()),
               own_tol=f"{CON_ATOL_PER_WEIGHT}*{weight}+{CON_RTOL}|q_con|",
               bitwise_equal_own_ee_tail=bool(torch.equal(
                   q_con[active], own[active])),
               max_abs_dq_con_vs_plain=float(d_ref[active].max()),
               max_tol_vs_plain=float(tol[active].max()),
               plain_tol="q_con_tolerance (the ee gate carried through "
                         "the tail)",
               max_q_con=float(ref[active].max()),
               masked_rows_zero=bool((q_con[~active] == 0).all()),
               q_margin_bitwise_equal_without_con=bool(
                   torch.equal(q, q0) and torch.equal(m, m0)),
               max_abs_dq=float(dq.max()), max_abs_dm=float(dm.max()),
               tol=TOL, finite=bool(torch.isfinite(q_con).all()))
    say(f"kernel_vs_plain:{label}:con{tag}", **out)
    assert (own_ok and ref_ok and q_ok and out["masked_rows_zero"]
            and out["q_margin_bitwise_equal_without_con"] and out["finite"]
            and out["max_q_con"] > 0.0), out
    return max(float(dq.max()), float(dm.max()), float(d_ref[active].max()))


def con_phase(variant, rollout, robot, world, fulls, dt, clearance, cone,
              spot, smi, chains, cands_per_row=None, smooth=None):
    """Phase 7c for one variant's :con form (the constraint route): con_check
    for the cone alone, the tool-point target alone and both (a third of
    the rows masked); then :con, :ee and no-constraint times in turns
    (con, ee, none, none, ee, con), the plain version's and the :con time
    on solver-like candidates (`smooth`, time-major, where given), beside
    both chains' times from chain_phase (`chains`). Returns (max_err, ms,
    plain_ms, ms_smooth or None)."""
    C = fulls.shape[0]
    active = ~inactive_rows(C, fulls.device)
    err = max(con_check(variant, rollout, robot, world, fulls, dt, clearance,
                        cons, active, cands_per_row, tag)
              for cons, tag in (((cone,), ""), ((spot,), ":position"),
                                ((cone, spot), ":both")))
    tm = fulls.permute(2, 1, 0).contiguous()
    kw = dict(time_major=True, cands_per_row=cands_per_row)
    runs = {"con": dict(constraints=cone), "ee": dict(want_ee=True),
            "none": {}}
    t = {k: [] for k in runs}
    for k in ("con", "ee", "none", "none", "ee", "con"):
        t[k].append(cuda_time_ms(lambda: rollout.obstacle_cost_batch(
            robot, world, tm, dt, clearance, **runs[k], **kw), 20))
    ms = sum(t["con"]) / 2
    plain_ms = cuda_time_ms(lambda: rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row,
        constraints=cone), 3)
    ms_smooth = None if smooth is None else cuda_time_ms(
        lambda: rollout.obstacle_cost_batch(robot, world, smooth, dt,
                                            clearance, constraints=cone,
                                            **kw), 20)
    blocks = {k: rollout.rollout_occupancy(robot, world, tm, dt, clearance,
                                           **runs[k], **kw) for k in runs}
    say(f"kernel_time:{variant}:con", C=C, T=fulls.shape[1],
        con_ms=t["con"], ee_ms=t["ee"], no_con_ms=t["none"],
        con_over_no_con=ms / (sum(t["none"]) / 2),
        con_over_ee=ms / (sum(t["ee"]) / 2), plain_ms=plain_ms,
        con_ms_smooth=ms_smooth, resident_blocks_per_sm=blocks,
        static_ms=chains["static_ms"], runtime_ms=chains["runtime_ms"],
        card=smi)
    torch.cuda.empty_cache()
    return err, ms, plain_ms, ms_smooth


def cone_excess(robot, traj, cone):
    """Per trajectory [B, T, d], the largest angle (rad) by which the
    end-effector axis leaves the cone (0 inside it)."""
    from tpustomp_torch.robot.fk import fk_frames

    _, rot, _ = fk_frames(robot, traj)
    axis = rot[..., -1, :, :] @ cone.axis_local               # [B, T, 3]
    cos = torch.clamp(axis @ cone.target_world, -1.0, 1.0)
    return torch.clamp(torch.arccos(cos) - cone.tolerance, min=0.0).amax(1)


def device_window(fn):
    """(fn(), CUDA kernels launched in it, their device µs, wall s): one
    utils.tracing.profile window (torch.profiler, CPU and CUDA activity)."""
    import tempfile

    from torch.autograd import DeviceType

    from tpustomp_torch.utils import tracing

    with tempfile.TemporaryDirectory() as tmp:
        with tracing.profile(tmp) as prof:
            out, wall = synced(fn)
    busy, n_k = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
            n_k += e.count
    return out, n_k, busy, wall


def constrained_phase(label, kernel, rollout, robot, world, cfg, cone, q0b,
                      qNb, smi):
    """Phase 8: the cone against the same problems and noise unconstrained
    (equal work: no early stop); then one profiler window over each run:
    kernels per iteration, and the constrained run's extra kernels per
    iteration (the constraint tail's launches; at most 2). Returns the
    :con kernel's launches."""
    from tpustomp_torch import ProblemSpec, plan_batch

    free, wall_f, _ = timed_plan_batch(rollout, robot, world, cfg, q0b, qNb)
    sol, wall_c, launches = timed_plan_batch(rollout, robot, world, cfg,
                                             q0b, qNb, constraints=cone)
    dev = robot.joint_axis.device
    window = {}
    for run, kw in (("unconstrained", {}), ("constrained",
                                            dict(constraints=cone))):
        out, n_k, busy, wall = device_window(lambda: plan_batch(
            robot, world, ProblemSpec(q0=q0b, qN=qNb), cfg, device=dev,
            generator=seeded(dev, 0), **kw))
        window[run] = dict(kernels_per_iteration=n_k / (
            int(out.iterations.max()) + 1), idle_pct=100 * (
                1 - busy / 1e6 / wall), device_kernel_ms=busy / 1e3)
    extra = (window["constrained"]["kernels_per_iteration"]
             - window["unconstrained"]["kernels_per_iteration"])
    B = q0b.shape[0]
    ex_c = float(cone_excess(robot, sol.trajectory, cone).mean())
    ex_f = float(cone_excess(robot, free.trajectory, cone).mean())
    say(f"plan_batch:{label}", B=B, iterations=cfg.max_iterations,
        solves_per_s=B / wall_c, unconstrained_solves_per_s=B / wall_f,
        overhead_pct=100.0 * (wall_c / wall_f - 1.0),
        success_rate=float(sol.success.float().mean()),
        unconstrained_success_rate=float(free.success.float().mean()),
        mean_max_cone_excess_rad=ex_c,
        unconstrained_mean_max_cone_excess_rad=ex_f,
        kernel_launches=launches, profile=window,
        tail_kernels_per_iteration=extra, card=smi)
    assert launches.get(kernel, 0) >= cfg.max_iterations, launches
    assert sum(launches.values()) == launches[kernel], launches
    assert ex_c < ex_f, (ex_c, ex_f)
    assert extra <= 2.0, window
    return launches[kernel]


def percand_constrained_phase(label, kernel, rollout, robot, cfg5, static,
                              states, cone, smi):
    """Phase 8: one config-5 replan with the cone, every scenario in its
    own world (solve_batch with world_batched=True: the per-row :con
    kernel). Returns its launches."""
    from tpustomp_torch.dynamics.device import device_ops
    from tpustomp_torch.engine import solver
    from tpustomp_torch.engine.mpc import _tick_world_batch
    from tpustomp_torch.engine.sampling import draw_z

    dev = robot.joint_axis.device
    B, d = states.q.shape
    world = _tick_world_batch(states.sphere_center.to(dev),
                              torch.tensor([0.12], device=dev),
                              static)
    ops = device_ops(cfg5.num_timesteps, cfg5.dt, cfg5.smoothness, dev)
    gen = torch.Generator(dev).manual_seed(0)
    K, N = cfg5.num_rollouts, cfg5.num_timesteps
    rollout.reset_launches()
    t0 = time.perf_counter()
    sol = solver.solve_batch(
        robot, world, cfg5, ops, states.q.to(dev), states.qN.to(dev),
        lambda it, active: draw_z(gen, d, B, K, N, dev),
        theta0=states.theta.to(dev), world_batched=True,
        constraints=cone)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in rollout.LAUNCHES.items() if v}
    say(f"solve_batch:{label}", B=B, wall_s=wall,
        mean_max_cone_excess_rad=float(cone_excess(
            robot, sol.trajectory, cone).mean()),
        success_rate=float(sol.success.float().mean()),
        kernel_launches=launches, card=smi)
    assert bool(torch.isfinite(sol.trajectory).all()
                and torch.isfinite(sol.cost).all())
    assert launches.get(kernel, 0) >= 1, launches
    assert sum(launches.values()) == launches[kernel], launches
    return launches[kernel]


def cuda_vs_cpu_modes_phase(label, robot, world, cfg, q0b, qNb, **kw):
    """Phase 9c: B = 8 on the card against the CPU under the same noise."""
    from tpustomp_torch import ProblemSpec, plan_batch

    dev = robot.joint_axis.device
    Bs, K, N = 8, cfg.num_rollouts, cfg.num_timesteps
    z = np.random.default_rng(3).standard_normal(
        (cfg.max_iterations, robot.num_joints, Bs, K, N)).astype(np.float32)

    def bank(device):
        return lambda it, active: torch.from_numpy(z[it]).to(device)

    prob = ProblemSpec(q0=q0b[:Bs], qN=qNb[:Bs])
    cons = kw.get("constraints")
    ref = plan_batch(robot.to("cpu"), world.to("cpu"), prob, cfg,
                     device="cpu", noise_fn=bank("cpu"),
                     constraints=None if cons is None else cons.to("cpu"))
    got = plan_batch(robot, world, prob, cfg, device=dev, noise_fn=bank(dev),
                     constraints=cons).to("cpu")
    d_traj = float((got.trajectory - ref.trajectory).abs().max())
    d_cost = float(((got.cost - ref.cost).abs() / ref.cost.abs()).max())
    same = (torch.equal(got.success, ref.success)
            and torch.equal(got.iterations, ref.iterations))
    say(f"cuda_vs_cpu:{label}", B=Bs, max_abs_dtraj=d_traj,
        max_rel_dcost=d_cost, success_and_iterations_equal=same,
        iterations=got.iterations.tolist())
    assert same and d_traj <= 1e-4 and d_cost <= 1e-4


def torso_arm_urdf():
    """A URDF robot with arm_7dof's kinematics under a prismatic torso lift
    (axis 0 0 1, 0 to 0.3 m): the shoulder lift's axis negated (limits
    mirrored), the upper-arm roll's frame turned by rpy 0.5 rad about z
    (a general axis, fixed rotations) and turned back at the elbow, a fixed
    tool link; cylinder, box and sphere collision geometry. At torso
    height 0.05 and the lift's sign flipped it moves as arm_7dof does."""
    a = 0.5                                  # the roll joint's frame turn
    c, s = np.cos(a), np.sin(a)
    axis = f"{c:.9f} {-s:.9f} 0"             # parent x in the turned frame
    elbow = f"{0.4 * c:.9f} {-0.4 * s:.9f} 0"
    return f"""
<robot name="torso_arm_7dof">
  <link name="base"/>
  <link name="torso">
    <collision><origin xyz="-0.15 0 0.35"/>
      <geometry><cylinder radius="0.08" length="0.3"/></geometry></collision>
  </link>
  <link name="shoulder_pan"/>
  <link name="shoulder_lift"/>
  <link name="upper_arm">
    <collision><origin xyz="{0.2 * c:.9f} {-0.2 * s:.9f} 0" rpy="0 1.5707963267948966 {-a}"/>
      <geometry><cylinder radius="0.06" length="0.4"/></geometry></collision>
  </link>
  <link name="elbow"/>
  <link name="forearm">
    <collision><origin xyz="0.16 0 0"/>
      <geometry><box size="0.32 0.1 0.1"/></geometry></collision>
  </link>
  <link name="wrist_flex"/>
  <link name="hand">
    <collision><origin xyz="0.08 0 0" rpy="0 1.5707963267948966 0"/>
      <geometry><cylinder radius="0.04" length="0.16"/></geometry></collision>
  </link>
  <link name="tool">
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="torso_lift" type="prismatic">
    <parent link="base"/><child link="torso"/>
    <origin xyz="0 0 0.25"/><axis xyz="0 0 1"/>
    <limit lower="0" upper="0.3"/>
  </joint>
  <joint name="shoulder_pan" type="revolute">
    <parent link="torso"/><child link="shoulder_pan"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 0 1"/>
    <limit lower="-2.28" upper="0.71"/>
  </joint>
  <joint name="shoulder_lift" type="revolute">
    <parent link="shoulder_pan"/><child link="shoulder_lift"/>
    <origin xyz="0.1 0 0"/><axis xyz="0 -1 0"/>
    <limit lower="-1.39" upper="0.52"/>
  </joint>
  <joint name="upper_arm_roll" type="revolute">
    <parent link="shoulder_lift"/><child link="upper_arm"/>
    <origin xyz="0 0 0" rpy="0 0 {a}"/><axis xyz="{axis}"/>
    <limit lower="-3.9" upper="0.8"/>
  </joint>
  <joint name="elbow_flex" type="revolute">
    <parent link="upper_arm"/><child link="elbow"/>
    <origin xyz="{elbow}" rpy="0 0 {-a}"/><axis xyz="0 1 0"/>
    <limit lower="-2.32" upper="0.0"/>
  </joint>
  <joint name="forearm_roll" type="continuous">
    <parent link="elbow"/><child link="forearm"/>
    <origin xyz="0 0 0"/><axis xyz="1 0 0"/>
  </joint>
  <joint name="wrist_flex" type="revolute">
    <parent link="forearm"/><child link="wrist_flex"/>
    <origin xyz="0.32 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2.18" upper="0.0"/>
  </joint>
  <joint name="wrist_roll" type="continuous">
    <parent link="wrist_flex"/><child link="hand"/>
    <origin xyz="0 0 0"/><axis xyz="1 0 0"/>
  </joint>
  <joint name="tool_mount" type="fixed">
    <parent link="hand"/><child link="tool"/>
    <origin xyz="0.16 0 0"/>
  </joint>
</robot>
"""


def torso_problems(q0b, qNb):
    """Config 4's problems for torso_arm_urdf: the torso from 0.05 to 0.1 m,
    the shoulder lift's sign flipped."""
    def lift(q, torso):
        q = np.concatenate([np.full((len(q), 1), torso, np.float32), q], 1)
        q[:, 2] *= -1
        return q
    return lift(q0b, 0.05), lift(qNb, 0.1)


def chain_phase(variant, rollout, robot, world, fulls, dt, clearance, cone,
                cands_per_row=None, tag=""):
    """Phase 10 for one variant: on the same time-major input with a third
    of the rows masked, the static chain (robot) against the plain version
    and against the runtime chain (the robot with joint_static=None), at
    the kernel-vs-plain tolerance, for the costs, the :ee form and the :con
    form (the cone; both chains' q_con within q_con_tolerance of the plain
    tail); then both chains' times in turns (static, runtime, runtime,
    static). Returns {form: dict(static_vs_runtime_max_abs, static_ms,
    runtime_ms)}."""
    from tpustomp_torch.costs.constraints import constraint_cost_tm

    runtime = dataclasses.replace(robot, joint_static=None)
    assert rollout.chain_of(robot) is not None
    assert rollout.chain_of(runtime) is None
    C = fulls.shape[0]
    tm = fulls.permute(2, 1, 0).contiguous()
    active = ~inactive_rows(C, fulls.device)
    q_p, m_p, ee_p = rollout.obstacle_cost_batch_plain(
        robot, world, fulls, dt, clearance, cands_per_row=cands_per_row,
        want_ee=True)
    con_p = constraint_cost_tm(robot, (cone,), ee_p)
    con_tol = q_con_tolerance(robot, (cone,), ee_p)
    out = {}
    for suffix, extra in (("", {}), (":ee", dict(want_ee=True)),
                          (":con", dict(constraints=cone))):
        ee, con = suffix == ":ee", suffix == ":con"
        form = variant + suffix
        kw = dict(time_major=True, cands_per_row=cands_per_row, **extra)
        before = dict(rollout.LAUNCHES)
        got = {name: rollout.obstacle_cost_batch(r, world, tm, dt, clearance,
                                                 row_active=active, **kw)
               for name, r in (("static", robot), ("runtime", runtime))}
        torch.cuda.synchronize()
        runtime_form = variant + ":runtime" + suffix
        ran = {k: rollout.LAUNCHES[k] - before[k] for k in before
               if rollout.LAUNCHES[k] != before[k]}
        assert ran == {form: 1, runtime_form: 1}, ran
        s, r = got["static"], got["runtime"]
        dq = (s[0] - q_p).abs()[active]
        dm = (s[1] - m_p).abs()[active]
        ok = bool((dq <= Q_ATOL + Q_RTOL * q_p.abs()[active]).all()
                  and (dm <= M_ATOL).all())
        res = dict(C=C, T=fulls.shape[1], rows_checked=int(active.sum()),
                   max_abs_dq=float(dq.max()), max_abs_dm=float(dm.max()),
                   tol=TOL)
        if ee:
            de = (s[2] - ee_p).abs()[:, :, active]
            ok = ok and bool((de <= EE_ATOL + EE_RTOL
                              * ee_p[:, :, active].abs()).all())
            res.update(max_abs_dee=float(de.max()),
                       ee_tol=f"{EE_ATOL}+{EE_RTOL}|ee|")
        if con:
            dc = (s[2] - con_p).abs()
            ok = ok and bool((dc <= con_tol)[active].all())
            res.update(max_abs_dq_con=float(dc[active].max()),
                       q_con_tol="q_con_tolerance")
        say(f"kernel_vs_plain:{form}:static{tag}", **res, ok=ok)
        # static against runtime: the same tolerance, with q and ee
        # relative to the runtime chain's values, q_con both within
        # q_con_tolerance of plain; masked rows zero in both
        diffs = [(a - b).abs() for a, b in zip(s, r)]
        within = bool(
            (diffs[0] <= Q_ATOL + Q_RTOL * r[0].abs()).all()
            and (diffs[1] <= M_ATOL).all()
            and (not ee or (diffs[2] <= EE_ATOL + EE_RTOL
                            * r[2].abs()).all())
            and (not con or ((r[2] - con_p).abs() <= con_tol)[active].all()))
        max_abs = max(float(x.max()) for x in diffs)
        bitwise = all(torch.equal(a, b) for a, b in zip(s, r))
        say(f"kernel_vs_kernel:{form}:static_vs_runtime{tag}", rows=C,
            max_abs_q=float(diffs[0].max()), max_abs_margin=float(
                diffs[1].max()),
            max_abs_ee=float(diffs[2].max()) if ee else None,
            max_abs_q_con=float(diffs[2].max()) if con else None,
            max_abs=max_abs, within_tol=within, bitwise_equal=bitwise)
        assert ok and within, (form, res)
        del got, s, r, diffs
        launch = {name: (lambda r=r: rollout.obstacle_cost_batch(
            r, world, tm, dt, clearance, **kw))
            for name, r in (("static", robot), ("runtime", runtime))}
        t = [cuda_time_ms(launch[k], 20)
             for k in ("static", "runtime", "runtime", "static")]
        out[form] = dict(static_vs_runtime_max_abs=max_abs,
                         static_ms=(t[0] + t[3]) / 2,
                         runtime_ms=(t[1] + t[2]) / 2)
        say(f"kernel_time:{form}:chains{tag}", C=C, T=fulls.shape[1],
            static_ms=[t[0], t[3]], runtime_ms=[t[1], t[2]],
            runtime_over_static=(t[1] + t[2]) / (t[0] + t[3]))
    del q_p, m_p, ee_p, con_p, con_tol
    torch.cuda.empty_cache()
    return out


def guard_phase(rollout, robot, world, cfg, q0b, qNb):
    """Phase 10g: arm_7dof with joint 1's axis replaced and joint_static
    left stale. plan_batch warns, runs only :runtime kernels and gives the
    honest robot's (joint_static=None) trajectory bit for bit."""
    from tpustomp_torch import ProblemSpec, plan_batch

    dev = robot.joint_axis.device
    axes = robot.joint_axis.clone()
    axes[1] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    stale = dataclasses.replace(robot, joint_axis=axes)
    honest = dataclasses.replace(stale, joint_static=None)
    prob = ProblemSpec(q0=q0b, qN=qNb)

    def run(r):
        return plan_batch(r, world, prob, cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))

    rollout.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = run(stale)
    torch.cuda.synchronize()
    launches = {k: v for k, v in rollout.LAUNCHES.items() if v}
    warned = [str(w.message) for w in caught
              if issubclass(w.category, UserWarning)
              and "joint_static" in str(w.message)]
    ref = run(honest)
    same = bool(torch.equal(got.trajectory, ref.trajectory)
                and torch.equal(got.success, ref.success))
    only_runtime = bool(launches) and all(":runtime" in k for k in launches)
    say("guard:stale_joint_static", B=len(q0b), warned=len(warned),
        kernel_launches=launches, only_runtime_kernels=only_runtime,
        trajectory_equal_to_honest=same)
    assert warned and only_runtime and same


def two_stream_phase(rollout, robot, world, fulls, dt, clearance, smi):
    """Two worlds built on the card (no host copies: each takes the
    memory path at its first launch and the parameter block after one read
    of its device vector at its second, bitwise the first), launched at the
    same time on two streams, three times: each result bitwise its own
    single-stream launch (every launch carries its parameters by value)."""
    dev = robot.joint_axis.device
    worlds = [dataclasses.replace(world, box_half=world.box_half * f)
              for f in (1.0, 1.4)]
    first = [rollout.obstacle_cost_batch(robot, w, fulls, dt, clearance)
             for w in worlds]
    ref = [rollout.obstacle_cost_batch(robot, w, fulls, dt, clearance)
           for w in worlds]
    torch.cuda.synchronize()
    first_same = all(torch.equal(a, b) for o, r in zip(first, ref)
                     for a, b in zip(o, r))
    del first
    streams = [torch.cuda.Stream(dev) for _ in worlds]
    rollout.reset_launches()
    same = True
    for _ in range(3):
        outs = []
        for w, st in zip(worlds, streams):
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                outs.append(rollout.obstacle_cost_batch(robot, w, fulls, dt,
                                                        clearance))
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for o, r in zip(outs, ref)
                            for a, b in zip(o, r))
    differ = not torch.equal(ref[0][0], ref[1][0])
    say("two_streams:rollout_analytic", C=fulls.shape[0], worlds=2,
        turns=3, bitwise_equal_to_single_stream=same,
        first_launch_bitwise_equal=first_same,
        worlds_give_different_costs=differ,
        param_routes=dict(rollout.PARAM_ROUTES),
        device_reads=rollout.PARAM_READS["device"], card=smi)
    assert same and differ and first_same
    assert rollout.PARAM_ROUTES["block"] == 6, rollout.PARAM_ROUTES
    assert rollout.PARAM_READS["device"] == 0     # read once, before


def sync_free_phase(rollout, cases, dt, clearance):
    """Phase 10s: one launch of each case (label, robot, world, tm,
    cands_per_row[, constraints: the :con form]) under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host sync
    in the launch path."""
    for label, robot, world, tm, per, *cons in cases:
        torch.cuda.synchronize()
        before = dict(rollout.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            rollout.obstacle_cost_batch(robot, world, tm, dt, clearance,
                                        time_major=True, cands_per_row=per,
                                        constraints=cons[0] if cons else None)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ran = [k for k in before if rollout.LAUNCHES[k] != before[k]]
        say(f"sync_free:{label}", sync_debug_mode="error", launched=ran)
        assert ran == [label], ran


def synced(fn):
    """(fn(), wall seconds) between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(rollout, kernel, fn):
    """fn() with the launch counts set to 0 just before and read just after;
    returns (result, wall s, launches). The kernel must have launched, and
    the solver loop must have replayed its CUDA graph."""
    from tpustomp_torch.engine import graph

    rollout.reset_launches()
    graph.reset_counts()
    out, wall = synced(fn)
    launches = {k: v for k, v in rollout.LAUNCHES.items() if v}
    assert launches.get(kernel, 0) > 0, (kernel, launches)
    replayed(graph)
    return out, wall, launches


def seeded(dev, seed):
    return torch.Generator(dev).manual_seed(seed)


def goal_band_phase(rollout, robot, world, cfg4, q0b, qNb, smi, band=0.1):
    """[goal_tolerance:config4]: every goal given a +-band (rad). The resolve
    over B·65 candidates timed alone, then plan_batch with the bands (no
    `device`: on the card); every endpoint inside band ∩ limits."""
    from tpustomp_torch import ProblemSpec, plan_batch
    from tpustomp_torch.api.plan import resolve_goal_tolerance
    from tpustomp_torch.engine.trajectory import wrap_goal

    dev = robot.joint_axis.device
    B, d = q0b.shape
    q0t, qNt = (torch.as_tensor(x, device=dev) for x in (q0b, qNb))
    tol_t = torch.full((B, d), band, device=dev)
    resolve_ms = cuda_time_ms(lambda: resolve_goal_tolerance(
        robot, world, cfg4, q0t, qNt, tol_t, tol_t), 5)
    tol = np.full((B, d), band, np.float32)
    prob = ProblemSpec(q0=q0b, qN=qNb, goal_tolerance_below=tol,
                       goal_tolerance_above=tol)
    plan_batch(robot, world, ProblemSpec(q0=q0b[:16], qN=qNb[:16],
                                         goal_tolerance_below=tol[:16],
                                         goal_tolerance_above=tol[:16]),
               cfg4, generator=seeded(dev, 1))
    sol, wall, launches = counted(rollout, "rollout_analytic", lambda:
                                  plan_batch(robot, world, prob, cfg4,
                                             generator=seeded(dev, 0)))
    assert sol.trajectory.device.type == dev.type      # no `device`: the card
    nominal = wrap_goal(q0t, qNt, robot.joint_limited)
    lim = robot.joint_limited
    lo = torch.where(lim, torch.maximum(nominal - band, robot.joint_lower),
                     nominal - band)
    hi = torch.where(lim, torch.minimum(nominal + band, robot.joint_upper),
                     nominal + band)
    end = wrap_goal(nominal, sol.trajectory[:, -1], lim)
    inside = bool(((end >= lo - 1e-6) & (end <= hi + 1e-6)).all())
    moved = int(((end - nominal).abs().amax(dim=1) > 1e-6).sum())
    say("goal_tolerance:config4", B=B, band_rad=band, candidates=B * 65,
        resolve_ms=resolve_ms, wall_s=wall, solves_per_s=B / wall,
        success_rate=float(sol.success.float().mean()),
        mean_iterations=float(sol.iterations.float().mean()),
        goals_moved=moved, endpoints_inside_band_and_limits=inside,
        kernel_launches=launches, card=smi)
    assert inside
    return launches["rollout_analytic"]


def plan_timed_phase(rollout, robot, world, cfg2, scene, smi, chunk=3):
    """[plan_timed:config2]: a 60 s budget equals plan under the same
    generator bitwise; a 0 s budget stops after one chunk."""
    from tpustomp_torch import ProblemSpec, plan, plan_timed

    dev = robot.joint_axis.device
    prob = ProblemSpec(q0=np.asarray(scene["q0"], np.float32),
                       qN=np.asarray(scene["qN"], np.float32))
    ample = cfg2.replace(planning_time_limit=60.0)
    ref, plan_wall = synced(lambda: plan(robot, world, prob, ample,
                                         generator=seeded(dev, 0)))
    sol, wall, launches = counted(rollout, "rollout_analytic", lambda:
                                  plan_timed(robot, world, prob, ample,
                                             generator=seeded(dev, 0)))
    same = bool(torch.equal(sol.trajectory, ref.trajectory)
                and int(sol.iterations) == int(ref.iterations))
    zero, zero_wall = synced(lambda: plan_timed(
        robot, world, prob, cfg2.replace(planning_time_limit=0.0),
        generator=seeded(dev, 0), chunk_iterations=chunk))
    say("plan_timed:config2", budget_s=60.0, success=bool(sol.success),
        iterations=int(sol.iterations), wall_s=wall, plan_wall_s=plan_wall,
        bitwise_equal_to_plan=same, zero_budget_iterations=int(
            zero.iterations), chunk_iterations=chunk,
        zero_budget_success=bool(zero.success), zero_budget_wall_s=zero_wall,
        kernel_launches=launches, card=smi)
    assert same and int(zero.iterations) <= chunk
    assert bool(torch.isfinite(zero.trajectory).all())
    return launches["rollout_analytic"]


def compaction_phase(label, kernel, rollout, robot, world, cfg4, q0b, qNb,
                     smi, turns=3):
    """[plan_batch:<label>]: batch_compaction "off" and "on" in alternating
    turns; success and iterations equal, trajectories within 1e-5."""
    from tpustomp_torch import ProblemSpec, plan_batch

    dev = robot.joint_axis.device
    B = q0b.shape[0]
    prob = ProblemSpec(q0=q0b, qN=qNb)
    cfgs = {"off": cfg4.replace(batch_compaction="off"),
            "on": cfg4.replace(batch_compaction="on")}
    for c in cfgs.values():
        plan_batch(robot, world, ProblemSpec(q0=q0b[:16], qN=qNb[:16]), c,
                   generator=seeded(dev, 1))
    rates = {"off": [], "on": []}
    sols, launches = {}, {}
    for _ in range(turns):
        for mode, c in cfgs.items():
            sols[mode], wall, launches[mode] = counted(
                rollout, kernel, lambda c=c: plan_batch(
                    robot, world, prob, c, generator=seeded(dev, 0)))
            rates[mode].append(B / wall)
    on, off = sols["on"], sols["off"]
    same = bool(torch.equal(on.success, off.success)
                and torch.equal(on.iterations, off.iterations))
    d_traj = float((on.trajectory - off.trajectory).abs().max())
    say(f"plan_batch:{label}", B=B, chunk=cfg4.compaction_chunk,
        min_bucket=cfg4.compaction_min_bucket,
        solves_per_s_on=rates["on"], solves_per_s_off=rates["off"],
        success_rate=float(on.success.float().mean()),
        mean_iterations=float(on.iterations.float().mean()),
        max_iterations=int(on.iterations.max()),
        success_and_iterations_equal=same, max_abs_dtraj=d_traj,
        kernel_launches_on=launches["on"], kernel_launches_off=launches["off"],
        card=smi)
    assert same and d_traj <= 1e-5, (same, d_traj)
    return launches["on"][kernel]


def smooth_phase(rollout, robot, world, cfg4, q0b, qNb, smi):
    """[plan_batch:config4_smooth]: rollout_limit_projection="smooth", and
    the projection of all B·C candidates timed alone."""
    from tpustomp_torch.dynamics.device import device_ops
    from tpustomp_torch.engine import solver

    dev = robot.joint_axis.device
    cfg = cfg4.replace(rollout_limit_projection="smooth")
    sol, wall, launches = timed_plan_batch(rollout, robot, world, cfg, q0b,
                                           qNb)
    B, N, d = q0b.shape[0], cfg.num_timesteps, q0b.shape[1]
    C = 1 + cfg.num_rollouts + cfg.noise.num_rollouts_reused
    ops = device_ops(N, cfg.dt, cfg.smoothness, dev)
    project = solver._projector(robot, cfg, ops)
    lo, hi = robot.joint_lower, robot.joint_upper
    cands = (lo + (hi - lo) * torch.rand((B * C, N, d), device=dev,
                                         generator=seeded(dev, 2)) * 1.2
             - 0.1 * (hi - lo))                  # a tenth out on either side
    proj_ms = cuda_time_ms(lambda: project(cands), 10)
    # one pass's matmul as the projection issues it (R⁻¹ broadcast over
    # B·C rows) and as one [N, N] @ [N, B·C·d] product, for the record
    bcast_ms = cuda_time_ms(lambda: ops.Rinv @ cands, 10)
    flat = cands.permute(1, 0, 2).reshape(N, -1)
    gemm_ms = cuda_time_ms(lambda: ops.Rinv @ flat, 10)
    say("plan_batch:config4_smooth", B=B, wall_s=wall, solves_per_s=B / wall,
        success_rate=float(sol.success.float().mean()),
        mean_iterations=float(sol.iterations.float().mean()),
        max_iterations=int(sol.iterations.max()),
        projection_ms_per_iteration=proj_ms, projected_rows=B * C,
        passes=cfg.joint_limit_iterations, matmul_ms_per_pass=bcast_ms,
        one_gemm_ms_per_pass=gemm_ms, kernel_launches=launches, card=smi)
    lim = robot.joint_limited
    tr = sol.trajectory
    assert bool((((tr >= lo - 1e-6) & (tr <= hi + 1e-6)) | ~lim).all())
    return launches["rollout_analytic"]


def retry_phase(rollout, robot, world, cfg4, q0b, qNb, smi, iters=4,
                label="config4"):
    """[plan_batch_retry:<label>]: a budget of `iters` iterations so that
    rows fail, then the retry; successful rows stay bitwise."""
    from tpustomp_torch import ProblemSpec, plan_batch, plan_batch_retry

    dev = robot.joint_axis.device
    cfg = cfg4.replace(max_iterations=iters)
    prob = ProblemSpec(q0=q0b, qN=qNb)
    base, base_wall = synced(lambda: plan_batch(robot, world, prob, cfg,
                                                generator=seeded(dev, 0)))
    sol, wall, launches = counted(rollout, "rollout_analytic", lambda:
                                  plan_batch_retry(robot, world, prob, cfg,
                                                   generator=seeded(dev, 0)))
    ok = base.success
    kept = bool(torch.equal(sol.trajectory[ok], base.trajectory[ok])
                and torch.equal(sol.iterations[ok], base.iterations[ok])
                and torch.equal(sol.cost[ok], base.cost[ok]))
    never_lost = bool((sol.success | ~ok).all())
    say(f"plan_batch_retry:{label}", B=len(q0b), max_iterations=iters,
        success_before=float(ok.float().mean()),
        success_after=float(sol.success.float().mean()),
        retried_rows=int((~ok).sum()), rounds=2, retry_restarts=4,
        wall_s=wall, plan_batch_wall_s=base_wall,
        successful_rows_bitwise_unchanged=kept, kernel_launches=launches,
        card=smi)
    assert kept and never_lost
    return launches["rollout_analytic"]


def stream_phase(rollout, robot, world, cfg4, q0, qN, jitter, smi,
                 nbatch=8, bs=256, turns=2):
    """[stream:config4]: nbatch batches of bs through plan_batch_stream at
    depth 2 and 0, against back-to-back plan_batch calls that gather the
    same (trajectory, success) to the host; results bitwise equal."""
    from tpustomp_torch import ProblemSpec, plan_batch, plan_batch_stream

    dev = robot.joint_axis.device
    rng = np.random.default_rng(7)
    probs = [ProblemSpec(
        q0=(q0 + rng.uniform(-jitter, jitter, (bs, 7))).astype(np.float32),
        qN=(qN + rng.uniform(-jitter, jitter, (bs, 7))).astype(np.float32))
        for _ in range(nbatch)]

    def back_to_back():
        out = []
        for i, p in enumerate(probs):
            s = plan_batch(robot, world, p, cfg4, generator=seeded(dev, i))
            out.append((s.trajectory.cpu().numpy(), s.success.cpu().numpy()))
        return out

    def stream(depth):
        return list(plan_batch_stream(
            robot, world, [(p, seeded(dev, i)) for i, p in enumerate(probs)],
            cfg4, depth=depth))

    stream(2)                                   # warm-up
    rates = {"back_to_back": [], "depth_2": [], "depth_0": []}
    results, launches = {}, {}
    for _ in range(turns):
        for name, fn in (("back_to_back", back_to_back),
                         ("depth_2", lambda: stream(2)),
                         ("depth_0", lambda: stream(0))):
            results[name], wall, launches[name] = counted(
                rollout, "rollout_analytic", fn)
            rates[name].append(nbatch * bs / wall)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for name in ("depth_2", "depth_0")
               for a, b in zip(results[name], results["back_to_back"]))
    say("stream:config4", batches=nbatch, batch_size=bs,
        solves_per_s=rates, equal_to_plan_batch=same,
        success_rate=float(np.mean([s for _, s in results["depth_2"]])),
        kernel_launches=launches["depth_2"], card=smi)
    assert same and len(results["depth_2"]) == nbatch
    return launches["depth_2"]["rollout_analytic"]


def tune_phase(rollout, robot, world, cfg4, q0b, qNb, smi, n=43):
    """[tune:config4]: the default 4x3x2 grid over n problems as one
    solve (24·n scenarios)."""
    from tpustomp_torch import ProblemSpec, tune

    res, wall, launches = counted(rollout, "rollout_analytic", lambda: tune(
        robot, world, ProblemSpec(q0=q0b[:n], qN=qNb[:n]), cfg4))
    label = "scale={:g}/h={:g}/decay={:g}".format(*res.best)
    say("tune:config4", cells=len(res.table), problems=n,
        scenarios=len(res.table) * n, wall_s=wall, best=label,
        best_metrics=res.table[label],
        success_per_cell={k: v["success_rate"] for k, v in res.table.items()},
        kernel_launches=launches, card=smi)
    assert len(res.table) == 24 and res.table[label]["success_rate"] == max(
        v["success_rate"] for v in res.table.values())
    return launches["rollout_analytic"]


def incremental_phase(rollout, robot, scene, cfg4, q0b, qNb, smi):
    """[incremental_sdf:config4_grid]: the tabletop as an IncrementalSDF on
    the card, a box added with set_box and a point cloud with add_points;
    the patched grid and table bitwise a fresh field's on the final
    occupancy (the table on the sample cells [0, dim-2] the kernel reads),
    the grid kernel on it bitwise the rebuilt field's and within tolerance
    of plain, the world from before the updates unchanged; then plan_batch
    on the updated world. Returns the grid kernel's launches there."""
    from tpustomp_torch.world.edt import IncrementalSDF, occupancy_from_analytic

    dev = robot.joint_axis.device
    g = scene["grid"]
    shape = tuple(g["shape"])
    occ = occupancy_from_analytic(tabletop(scene), g["origin"], shape,
                                  g["resolution"])

    def field(o):
        return IncrementalSDF(o, g["origin"], g["resolution"],
                              max_distance=0.5, device=dev)

    inc, build_s = synced(lambda: field(occ))
    before = inc.as_world()
    saved = (before.grid.clone(), before.packed.clone())

    def patch(fn):
        """(ms between CUDA events around fn: host EDT, upload, device
        writes; host ms)."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)

    # a 15 x 20 x 25 cm box on the far side of the table, a 10 cm cloud of
    # 2,000 points above the table's near corner
    box_ms, box_host_ms = patch(lambda: inc.set_box((50, 60, 20),
                                                    (56, 68, 30), True))
    pts = np.random.default_rng(4).uniform((0.25, -0.65, 0.75),
                                           (0.35, -0.55, 0.85), (2000, 3))
    pts_ms, pts_host_ms = patch(lambda: inc.add_points(pts))
    fresh, rebuild_s = synced(lambda: field(inc.occ))
    w, f = inc.as_world(), fresh.as_world()
    cells = lambda p: p.reshape(*shape, 8)[:-1, :-1, :-1]
    grid_equal = bool(torch.equal(w.grid, f.grid))
    table_equal = bool(torch.equal(cells(w.packed), cells(f.packed)))
    unchanged = bool(torch.equal(before.grid, saved[0])
                     and torch.equal(before.packed, saved[1]))
    del saved
    lo = robot.joint_lower.cpu().numpy()
    hi = robot.joint_upper.cpu().numpy()
    B = q0b.shape[0]
    C = B * (1 + cfg4.num_rollouts + cfg4.noise.num_rollouts_reused)
    T = cfg4.num_timesteps + 2
    fulls = torch.as_tensor(np.random.default_rng(9).uniform(
        lo, hi, (C, T, 7)).astype(np.float32), device=dev)
    dt, clearance = cfg4.dt, cfg4.collision_clearance
    err = check_kernel("rollout_grid:incremental_sdf", rollout, robot, w,
                       fulls, dt, clearance)
    tm = fulls.permute(2, 1, 0).contiguous()
    del fulls
    q_w, m_w = rollout.obstacle_cost_batch(robot, w, tm, dt, clearance,
                                           time_major=True)
    q_f, m_f = rollout.obstacle_cost_batch(robot, f, tm, dt, clearance,
                                           time_major=True)
    kernel_equal = bool(torch.equal(q_w, q_f) and torch.equal(m_w, m_f))
    del tm, q_w, m_w, q_f, m_f
    say("kernel_vs_kernel:rollout_grid:patched_vs_rebuilt", rows=C,
        bitwise_equal=kernel_equal)
    sol, wall, launches = timed_plan_batch(rollout, robot, w, cfg4, q0b, qNb)
    say("incremental_sdf:config4_grid", shape=list(shape),
        max_distance=inc.max_distance, build_s=build_s,
        set_box_ms=box_ms, set_box_host_ms=box_host_ms,
        add_points_ms=pts_ms, add_points_host_ms=pts_host_ms, points=2000,
        rebuild_s=rebuild_s, changed_voxels=int((inc.occ != occ).sum()),
        grid_bitwise_equal_to_rebuild=grid_equal,
        table_bitwise_equal_to_rebuild=table_equal,
        earlier_world_unchanged=unchanged, kernel_max_abs_err=err,
        B=B, wall_s=wall, solves_per_s=B / wall,
        success_rate=float(sol.success.float().mean()),
        mean_iterations=float(sol.iterations.float().mean()),
        kernel_launches=launches, card=smi)
    assert grid_equal and table_equal and unchanged and kernel_equal
    assert float(sol.success.float().mean()) >= 0.5
    assert launches.get("rollout_grid", 0) >= int(sol.iterations.max())
    return launches["rollout_grid"]


def sharded_phase(rollout, robot, world, cfg4, q0b, qNb, smi):
    """[plan_sharded:config4]: plan_sharded at world size 1, bitwise
    plan_batch under the same generator seed. Returns (its analytic
    launches, the plan_batch Solution)."""
    from tpustomp_torch import ProblemSpec, plan_batch, plan_sharded
    from tpustomp_torch.engine import distributed

    dev = robot.joint_axis.device
    prob = ProblemSpec(q0=q0b, qN=qNb)
    ref, ref_wall = synced(lambda: plan_batch(robot, world, prob, cfg4,
                                              generator=seeded(dev, 0)))
    sol, wall, launches = counted(
        rollout, "rollout_analytic", lambda: plan_sharded(
            robot, world, prob, cfg4, generator=seeded(dev, 0)))
    same = all(torch.equal(getattr(sol, f), getattr(ref, f))
               for f in ("trajectory", "success", "iterations", "cost"))
    B = q0b.shape[0]
    say("plan_sharded:config4", world_size=1, B=B, wall_s=wall,
        solves_per_s=B / wall, plan_batch_solves_per_s=B / ref_wall,
        bitwise_equal_to_plan_batch=same,
        summary=distributed.summarize(sol), kernel_launches=launches,
        card=smi)
    assert same
    return launches["rollout_analytic"], ref


def rank_worker(rank, world_size, store, device, out_path):
    """One rank of [plan_sharded:config4:2ranks] (a spawned process): its
    half of config 4's 1,024 problems on `device` through plan_sharded over
    a gloo group, the global summary, saved for the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import yaml

    from tpustomp_torch import ProblemSpec, plan_batch, plan_sharded
    from tpustomp_torch.api.config import from_dict
    from tpustomp_torch.engine import distributed
    from tpustomp_torch.kernels import rollout
    from tpustomp_torch.robot.model import arm_7dof

    mesh = distributed.init_multihost(
        init_method=f"file://{store}", world_size=world_size,
        rank=rank, device=device)
    dev = mesh.device
    with open(os.path.join(ROOT, "configs", "config4_batch.yaml")) as f:
        doc4 = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "config2_tabletop.yaml")) as f:
        scene = yaml.safe_load(f)["scene"]
    cfg4 = from_dict(doc4["planner"])
    robot = arm_7dof().to(dev)
    world = tabletop(scene).to(dev)
    q0, qN = (np.asarray(scene[k], np.float32) for k in ("q0", "qN"))
    B, jitter = (int(doc4["batch"]["scenarios_per_chip"]),
                 float(doc4["batch"]["start_goal_jitter"]))
    rng = np.random.default_rng(0)                 # as main()
    q0b = (np.tile(q0, (B, 1))
           + rng.uniform(-jitter, jitter, (B, 7))).astype(np.float32)
    qNb = (np.tile(qN, (B, 1))
           + rng.uniform(-jitter, jitter, (B, 7))).astype(np.float32)
    lo, hi, _ = mesh.rows(B // world_size)
    plan_batch(robot, world, ProblemSpec(q0=q0b[:16], qN=qNb[:16]), cfg4,
               generator=seeded(dev, 1))            # warm-up
    torch.cuda.synchronize()
    torch.distributed.barrier()
    rollout.reset_launches()
    t0 = time.perf_counter()
    sol = plan_sharded(
        robot, world, ProblemSpec(q0=q0b[lo:hi], qN=qNb[lo:hi]), cfg4,
        mesh=mesh, generator=seeded(dev, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(rollout.LAUNCHES)
    summary = distributed.summarize(sol, mesh)
    torch.save({"trajectory": sol.trajectory.cpu(),
                "success": sol.success.cpu(),
                "iterations": sol.iterations.cpu(), "cost": sol.cost.cpu(),
                "summary": summary, "wall_s": wall, "launches": launches},
               out_path)
    torch.distributed.destroy_process_group()


def two_rank_phase(ref, smi, device, world_size=2):
    """[plan_sharded:config4:2ranks]: two processes on the one card over a
    gloo group (NCCL refuses two ranks on one device), each planning half
    of the batch; the union held to the one-rank run (`ref`) as card vs CPU
    is: success and iterations equal, trajectory 1e-4; summarize equal on
    both ranks. Returns the ranks' analytic launches."""
    import multiprocessing
    import tempfile

    from tpustomp_torch.api.problem import Solution
    from tpustomp_torch.engine import distributed

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        store = os.path.join(tmp, "store")        # a file store: no port
        procs = [ctx.Process(target=rank_worker,
                             args=(r, world_size, store, device, paths[r]))
                 for r in range(world_size)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        total_s = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world_size, codes
        res = [torch.load(p, weights_only=False) for p in paths]
    got = {k: torch.cat([r[k] for r in res])
           for k in ("trajectory", "success", "iterations", "cost")}
    ref = {k: getattr(ref, k).cpu() for k in got}
    same = bool(torch.equal(got["success"], ref["success"])
                and torch.equal(got["iterations"], ref["iterations"]))
    d_traj = float((got["trajectory"] - ref["trajectory"]).abs().max())
    summaries = [r["summary"] for r in res]
    one = distributed.summarize(Solution(
        trajectory=ref["trajectory"], times=ref["trajectory"][..., 0],
        success=ref["success"], cost=ref["cost"],
        iterations=ref["iterations"]))
    B = len(ref["success"])
    walls = [r["wall_s"] for r in res]
    say("plan_sharded:config4:2ranks", world_size=world_size, B=B,
        rank_walls_s=walls, solves_per_s=B / max(walls),
        processes_s=total_s, success_and_iterations_equal=same,
        max_abs_dtraj=d_traj, summaries=summaries, one_rank_summary=one,
        kernel_launches=[{k: v for k, v in r["launches"].items() if v}
                         for r in res], card=smi)
    assert same and d_traj <= 1e-4, (same, d_traj)
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["num_scenarios"] == B
    assert summaries[0]["success_rate"] == one["success_rate"]
    assert summaries[0]["mean_iterations"] == one["mean_iterations"]
    return sum(r["launches"]["rollout_analytic"] for r in res)


CLI_KEYS = {
    "plan": {"success", "iterations", "cost", "wall_seconds",
             "num_waypoints", "device"},
    "batch": {"num_scenarios", "success_rate", "mean_cost",
              "mean_iterations", "wall_seconds",
              "solves_per_sec_incl_compile", "device"},
    "mpc": {"scenarios", "ticks", "collision_rate", "mean_goal_distance",
            "reached_rate_0.2rad", "reached_rate", "median_ticks_to_goal",
            "wall_seconds", "replans_per_sec_incl_compile", "device"},
}


def cli_phases(smi):
    """[cli:<config>]: `python -m tpustomp_torch` as a subprocess on the
    card: rc 0 and the JAX CLI's keys; the wall of the whole process."""
    runs = [("config2", "plan", ["config2_tabletop.yaml"]),
            ("config2_grid", "plan", ["config2_tabletop.yaml", "--grid"]),
            ("config4", "batch", ["config4_batch.yaml"]),
            ("config5", "mpc", ["config5_mpc.yaml"]),
            ("config5_grid", "mpc", ["config5_mpc.yaml", "--grid"])]
    for label, kind, args in runs:
        cmd = [sys.executable, "-m", "tpustomp_torch",
               os.path.join(ROOT, "configs", args[0]), *args[1:]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        assert res.returncode == 0, (label, res.returncode,
                                     res.stdout[-2000:], res.stderr[-3000:])
        out = json.loads(res.stdout.strip().splitlines()[-1])
        say(f"cli:{label}", args=args[1:], rc=res.returncode,
            process_wall_s=wall, result=out, card=smi)
        assert set(out) == CLI_KEYS[kind], sorted(out)
        assert out["device"] == torch.cuda.get_device_name(0)


def checkpoint_phase(rollout, robot, cfg5, spec5, world, states, ticks,
                     whole, smi):
    """[checkpoint:config5]: the config-5 episode run to tick ticks/2, its
    state and generator saved with utils.checkpoint, restored into freshly
    built objects (a new initial state as the template, a new generator)
    and run to the end: bitwise the uninterrupted episode (`whole`, from
    phase 6). Returns the per-row kernel's launches."""
    import tempfile

    from tpustomp_torch.engine.mpc import run_mpc_batch
    from tpustomp_torch.utils import checkpoint

    dev = robot.joint_axis.device
    dt = float(spec5["world_dt"])
    half = ticks // 2
    gen = seeded(dev, 0)
    rollout.reset_launches()
    mid, wall1 = synced(lambda: run_mpc_batch(
        robot, cfg5, states, [0.12], half, dt, static_world=world,
        device=dev, generator=gen))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mpc.pt")
        _, save_s = synced(lambda: checkpoint.save(
            path, {"state": mid, "generator": gen}))
        nbytes = os.path.getsize(path)
        gen.manual_seed(12345)                 # the live generator moves on
        del mid
        template = {"state": config5_states(robot, cfg5, states.q.shape[0],
                                            np.zeros(7, np.float32),
                                            np.zeros(7, np.float32), 0.0,
                                            seed=99),
                    "generator": torch.Generator(dev)}
        back, restore_s = synced(lambda: checkpoint.restore(path, template))
    out, wall2 = synced(lambda: run_mpc_batch(
        robot, cfg5, back["state"], [0.12], ticks - half, dt,
        static_world=world, device=dev, generator=back["generator"]))
    launches = {k: v for k, v in rollout.LAUNCHES.items() if v}
    out = out.to("cpu")
    same = all(torch.equal(getattr(out, f.name), getattr(whole, f.name))
               for f in dataclasses.fields(out))
    say("checkpoint:config5", B=states.q.shape[0], ticks=ticks,
        saved_at_tick=half, checkpoint_bytes=nbytes, save_s=save_s,
        restore_s=restore_s, first_half_s=wall1, second_half_s=wall2,
        bitwise_equal_to_uninterrupted=same, kernel_launches=launches,
        card=smi)
    assert same
    return launches["rollout_analytic:per_cand_world"]


def differing(a, b):
    """The fields of two results (Solutions, or tune's tables) that are not
    bitwise equal."""
    if not dataclasses.is_dataclass(b):
        return [] if a == b else ["value"]
    out = []
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(y):
            out += [f"{f.name}.{g}" for g in differing(x, y)]
        elif y is not None and not torch.equal(x, y):
            out.append(f.name)
    return out


ROUTES = ("eager", "per_iteration", "chunk")

# The main path's kernel launches (and K4's) as the eager loop and the
# per-iteration replays counted them on an H100 (this script, before the
# chunk route); every route runs the same iterations, so they must not
# move.
MAIN_PATH_LAUNCHES = {
    "rollout_analytic": (599, 166), "rollout_grid": (54, 1),
    "rollout_analytic:per_cand_world": (1604, 200),
    "rollout_grid:per_cand_overlay": (796, 200),
    "rollout_analytic:con": (51, None), "rollout_grid:con": (51, None),
    "rollout_analytic:per_cand_world:con": (9, None),
    "rollout_grid:per_cand_overlay:con": (9, None),
}


def in_route(route, fn):
    """fn() with the solver's loop on `route`: "eager" (graph.eager()),
    "per_iteration" (graph.per_iteration(): one replay an iteration, the
    draw and the condition's read on the host, the route of a caller's
    noise_fn) or "chunk" (the default: chunks of iterations under IF
    nodes, condition and draws on the device)."""
    from tpustomp_torch.engine import graph

    ctx = {"eager": graph.eager, "per_iteration": graph.per_iteration}
    if route not in ctx:
        return fn()
    with ctx[route]():
        return fn()


def graph_turns(label, run, smi, B=1, turns=4, ticks=None, solves=1,
                profile=True):
    """[graph:<label>]: run(generator) on each route of ROUTES, in turns.
    The cache is emptied first, so the first chunk call and the first
    per-iteration call capture (their walls, and the entries' pools,
    capture and instantiate ms); then `turns` rounds, the routes' order
    rotating, each wall between two syncs. Every result bitwise the first
    call's and the generator's offset after every call equal; the graphed
    calls replay, capture nothing and launch nothing on the memory path,
    the chunk calls on the chunk route only, no eager call replays. Per
    call: the host's reads of the loop's condition per solve (`solves` a
    call) or per tick (an episode of `ticks`: none on the chunk route),
    at most ceil(iterations / CHUNK) + 1 a solve on the chunk route; and
    with `profile`, one profiler window a route (profile_window): host
    launches per call. B: the solves (replans) a call makes. Returns the
    median walls."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.kernels import rollout

    dev = torch.device("cuda")

    def call(route):
        gen = seeded(dev, 0)
        out, wall = synced(lambda: in_route(route, lambda: run(gen)))
        return out, wall, gen.get_offset()

    graph.clear()
    graph.reset_counts()
    first, first_wall, offset = call("chunk")
    replayed(graph)
    graph.reset_counts()
    _, first_per_it_wall, _ = call("per_iteration")
    entries = graph.cached()
    walls = {r: [] for r in ROUTES}
    reads = {r: [] for r in ROUTES}
    for i in range(turns):
        order = ROUTES[i % 3:] + ROUTES[:i % 3]
        for route in (order if i % 2 == 0 else order[::-1]):
            graph.reset_counts()
            memory = rollout.PARAM_ROUTES["memory"]
            out, wall, off = call(route)
            g = dict(graph.GRAPHS)
            if route == "eager":
                assert not g.get("replayed"), g
            else:
                assert g.get("replayed", 0) > 0 and not g.get("captured"), g
                assert rollout.PARAM_ROUTES["memory"] == memory, label
            if route == "chunk":
                replayed(graph)
                if ticks is not None:
                    assert not g.get("flag_reads"), g
                else:
                    assert g.get("flag_reads", 0) <= solves * (
                        -(-g["chunk"] // (graph.CHUNK * solves)) + 1), g
            walls[route].append(wall)
            n = ticks if ticks is not None else solves
            reads[route].append(g.get("flag_reads", 0) / n)
            bad = differing(out, first)
            assert not bad, (label, route, bad)
            assert off == offset, (label, route, off, offset)
    launches = {}
    if profile:
        for route in ROUTES:
            launches[route] = profile_window(
                rollout, lambda: run(seeded(dev, 0)), route)[1][
                    "host_launches"]
    med = {r: float(np.median(w)) for r, w in walls.items()}
    per_tick = {} if ticks is None else {
        f"{r}_ms_per_tick": 1e3 * med[r] / ticks for r in ROUTES}
    unit = "tick" if ticks is not None else "solve"
    say(f"graph:{label}", B=B, ticks=ticks, solves=solves, **per_tick,
        **{f"{r}_wall_s": walls[r] for r in ROUTES},
        **{f"median_{r}_s": med[r] for r in ROUTES},
        **{f"{r}_per_s": B / med[r] for r in ROUTES},
        chunk_over_eager=med["eager"] / med["chunk"],
        chunk_over_per_iteration=med["per_iteration"] / med["chunk"],
        **{f"{r}_flag_reads_per_{unit}": float(np.median(reads[r]))
           for r in ROUTES},
        **{f"{r}_host_launches_per_call": launches.get(r) for r in ROUTES},
        first_chunk_wall_s=first_wall,
        first_per_iteration_wall_s=first_per_it_wall, graphs=entries,
        bitwise_equal=True, generator_offsets_equal=True, card=smi)
    return med


def graph_phases(robot, world, grid, cfg4, cfg2, cfg_con, cone, cfg3, world3,
                 cfg_hmc, scene, doc3, q0b, qNb, smi):
    """Phase 13: each main path with the solver loop replaying its CUDA
    graph against the eager loop, in turns, bitwise: config 4 (B = 1,024)
    over the box and the voxel tabletop, with the cone, and over a box
    world built on the card; config 2's plan (p50 latency over 8 calls a
    mode), also with the robot and world built on the CPU at every call
    (the README's form: the graph is hit all the same); config 3's CHOMP
    plan and plan_batch (B = 1,024), and HMC (B = 256)."""
    from tpustomp_torch import ProblemSpec, plan, plan_batch
    from tpustomp_torch.robot.model import arm_7dof
    from tpustomp_torch.world.sdf import AnalyticWorld

    dev = robot.joint_axis.device
    prob = ProblemSpec(q0=q0b, qN=qNb)
    on_card = AnalyticWorld(*(getattr(world, f.name) * 1.0
                              for f in dataclasses.fields(world)))
    for label, w, cfg, kw in (
            ("config4", world, cfg4, {}), ("config4_grid", grid, cfg4, {}),
            ("config4_constrained", world, cfg_con,
             dict(constraints=cone)),
            ("config4_device_world", on_card, cfg4, {})):
        graph_turns(label, lambda gen, w=w, cfg=cfg, kw=kw: plan_batch(
            robot, w, prob, cfg, generator=gen, **kw), smi,
            B=q0b.shape[0])
    one = ProblemSpec(q0=np.asarray(scene["q0"], np.float32),
                      qN=np.asarray(scene["qN"], np.float32))
    graph_turns("config2", lambda gen: plan(robot, world, one, cfg2,
                                            generator=gen), smi, turns=8)
    graph_turns("config2_host_objects", lambda gen: plan(
        arm_7dof(), tabletop(scene), one, cfg2, device="cuda",
        generator=gen), smi, turns=4)
    one3 = ProblemSpec(q0=np.asarray(doc3["scene"]["q0"], np.float32),
                       qN=np.asarray(doc3["scene"]["qN"], np.float32))
    graph_turns("config3", lambda gen: plan(robot, world3, one3, cfg3,
                                            generator=gen), smi)
    graph_turns("config3_batch", lambda gen: plan_batch(
        robot, world3, prob, cfg3, generator=gen), smi, B=q0b.shape[0])
    small = ProblemSpec(q0=q0b[:256], qN=qNb[:256])
    graph_turns("config3_hmc", lambda gen: plan_batch(
        robot, world3, small, cfg_hmc, generator=gen), smi, B=256, turns=2,
        profile=False)


def host_work_phase(rollout, robot, world, cfg4, q0b, qNb, smi):
    """[host_work:config4]: what a graphed plan_batch still launches
    around its graphs, each in a profiler window (profile_window's host
    launches, HOST_LAUNCHES calls): api.plan._prepare without and with a
    ±0.1 rad goal band on every joint (resolve_goal_tolerance, plain
    torch), building the solver's step, and the whole call (a hit) on the
    chunk route."""
    from tpustomp_torch import ProblemSpec, plan_batch
    from tpustomp_torch.api.plan import _prepare
    from tpustomp_torch.engine import solver

    dev = robot.joint_axis.device
    prob = ProblemSpec(q0=q0b, qN=qNb)
    band = dataclasses.replace(prob, goal_tolerance_below=0.1,
                               goal_tolerance_above=0.1)
    p = _prepare(robot, world, prob, cfg4, dev, None)
    out = {}
    for label, fn in (
            ("prepare", lambda: _prepare(robot, world, prob, cfg4, dev, None)),
            ("prepare_goal_band", lambda: _prepare(robot, world, band, cfg4,
                                                   dev, None)),
            ("make_step", lambda: solver.make_step(
                p.robot, p.world, p.cfg, p.ops, p.q0, p.qN, None)),
            ("plan_batch", lambda: plan_batch(robot, world, prob, cfg4,
                                              generator=seeded(dev, 0)))):
        fn()                                        # warm (and capture)
        out[label] = profile_window(rollout, fn, "chunk")[1]["host_launches"]
    say("host_work:config4", B=q0b.shape[0], host_launches=out, card=smi)


def mpc_graph_phases(robot, world, grid, cfg5, spec5, states5, smi,
                     ticks=20):
    """Phase 13's MPC rows, eager against graphed in turns, bitwise:
    config 5 (every scenario of states5, `ticks` ticks) over the box and
    the voxel tabletop, in replans/s; a fleet of its first 256 scenarios;
    one robot's run_mpc (scenario 0), ms a tick over 8 episodes a
    mode."""
    from tpustomp_torch._tensors import map_tensors
    from tpustomp_torch.engine.mpc import run_mpc, run_mpc_batch

    dev = robot.joint_axis.device
    dt = float(spec5["world_dt"])

    def episode(states, static):
        return lambda gen: run_mpc_batch(robot, cfg5, states, [0.12], ticks,
                                         dt, static_world=static,
                                         device=dev, generator=gen)

    B5 = states5.q.shape[0]
    for label, static in (("config5", world), ("config5_grid", grid)):
        graph_turns(label, episode(states5, static), smi, B=B5 * ticks,
                    ticks=ticks, turns=2, profile=False)
    fleet = map_tensors(states5, lambda v: v[:256])
    graph_turns("config5_fleet256", episode(fleet, world), smi,
                B=256 * ticks, ticks=ticks)
    one = map_tensors(states5, lambda v: v[0])
    graph_turns("mpc_one_robot", lambda gen: run_mpc(
        robot, cfg5, one, [0.12], ticks, dt, static_world=world,
        device=dev, generator=gen), smi, B=ticks, turns=8, ticks=ticks)


def event_ms(fn):
    """(fn(), ms between CUDA events around it, host ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)


def incremental_tabletop(scene, dev):
    """The scene's tabletop on its own grid as an IncrementalSDF on `dev`
    (max_distance 0.5 m, as incremental_phase's)."""
    from tpustomp_torch.world.edt import (IncrementalSDF,
                                          occupancy_from_analytic)

    g = scene["grid"]
    return IncrementalSDF(occupancy_from_analytic(
        tabletop(scene), g["origin"], tuple(g["shape"]), g["resolution"]),
        g["origin"], g["resolution"], max_distance=0.5, device=dev)


def graph_inputs_phase(label, kernel, changes, run, smi, B):
    """[graph_inputs:<label>]: run(generator, **inputs) after each change
    of `changes` (an iterator of (change, its ms, inputs)). The first call
    captures the entry (three regions); after each later change, first the
    replay on the cached entry (the new values loaded into its copies, the
    captured nodes' parameter blocks rewritten where they moved; asserted:
    no region captured, nothing invalidated, the chunk route, `kernel`
    launched), then, in alternating order, a forced miss (graph.clear():
    a capture a change, as before the world was an input) and the eager
    loop; all three bitwise. Per change: its ms, the three walls, the
    inputs loaded and nodes rewritten by the replay."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.kernels import rollout

    dev = torch.device("cuda")

    def call(route, inputs):
        rollout.reset_launches()
        graph.reset_counts()
        out, wall = synced(lambda: in_route(route, lambda: run(
            seeded(dev, 0), **inputs)))
        return out, wall, dict(graph.GRAPHS), rollout.LAUNCHES.get(kernel, 0)

    graph.clear()
    rows, prev = [], None
    for i, (change, change_ms, inputs) in enumerate(changes):
        if i == 0:
            prev, wall, g, _ = call("chunk", inputs)
            assert g.get("captured") == 3, g
            rows.append(dict(change=change, change_ms=change_ms,
                             first_wall_s=wall, mean_iterations=float(
                                 prev.iterations.float().mean())))
            continue
        hit, hit_wall, g, n = call("chunk", inputs)
        assert not g.get("captured") and not g.get("invalidated"), g
        assert g.get("chunk", 0) > 0 and n > 0, (g, n)
        res = {}
        for mode in (("miss", "eager") if i % 2 else ("eager", "miss")):
            if mode == "miss":
                graph.clear()
            res[mode] = call("chunk" if mode == "miss" else "eager", inputs)
        assert res["miss"][2].get("captured") == 3, res["miss"][2]
        for mode, (out, *_) in res.items():
            bad = differing(out, hit)
            assert not bad, (label, change, mode, bad)
        rows.append(dict(
            change=change, change_ms=change_ms, replay_wall_s=hit_wall,
            miss_wall_s=res["miss"][1], eager_wall_s=res["eager"][1],
            regions_captured=g.get("captured", 0),
            inputs_loaded=g.get("inputs_loaded", 0),
            node_updates=g.get("node_updates", 0),
            miss_regions_captured=res["miss"][2]["captured"],
            kernel_launches=n, result_moved=bool(differing(hit, prev)),
            mean_iterations=float(hit.iterations.float().mean()),
            bitwise_equal_miss_and_eager=True))
        prev = hit
    later = rows[1:]
    say(f"graph_inputs:{label}", B=B, changes=rows, **{
        f"median_{m}_wall_s": float(np.median([r[f"{m}_wall_s"]
                                               for r in later]))
        for m in ("replay", "miss", "eager")}, card=smi)
    return rows


def graph_inputs_phases(robot, scene, cfg4, cfg_con, q0b, qNb, smi):
    """Phase 13b, config 4 (B = 1,024) replanned after each change of its
    world or constraint, on one cached entry (graph_inputs_phase):
    `config4_grid`, the tabletop as an IncrementalSDF on the card, four
    edits on the arm's path (set_box, add_points, the box cleared, another
    cloud); `config4_moved_box`, a 10 cm box on the path moved in a new CPU
    AnalyticWorld at each call (the README's form); `config4_cone_target`,
    the cone's target moved at each call."""
    from tpustomp_torch import OrientationConstraint, ProblemSpec, plan_batch
    from tpustomp_torch.world.sdf import AnalyticWorld

    prob = ProblemSpec(q0=q0b, qN=qNb)
    B = q0b.shape[0]
    inc = incremental_tabletop(scene, robot.joint_axis.device)
    rng = np.random.default_rng(5)
    cloud = lambda lo, hi: rng.uniform(lo, hi, (2000, 3))

    def grid_changes():
        yield "initial", 0.0, dict(world=inc.as_world())
        # the forearm's path at mid-trajectory passes (0.64, 0.04, 0.94)
        for change, fn in (
                ("set_box", lambda: inc.set_box((30, 38, 34), (36, 44, 40),
                                                True)),
                ("add_points", lambda: inc.add_points(cloud(
                    (0.55, -0.3, 0.8), (0.65, -0.2, 0.9)))),
                ("set_box_cleared", lambda: inc.set_box(
                    (30, 38, 34), (36, 44, 40), False)),
                ("add_points_2", lambda: inc.add_points(cloud(
                    (0.55, 0.2, 0.8), (0.65, 0.3, 0.9))))):
            _, ms, _ = event_ms(fn)
            yield change, ms, dict(world=inc.as_world())

    def box_changes():
        for dy in (0.0, 0.05, -0.05, 0.1, -0.1):
            world = AnalyticWorld.make(boxes=[
                *((tuple(b["center"]), tuple(b["half"]))
                  for b in scene["boxes"]),
                ((0.64, 0.04 + dy, 0.94), (0.05, 0.05, 0.05))])
            yield f"box_y{dy:+.2f}", 0.0, dict(world=world)

    def cone_changes():
        world = tabletop(scene)
        for tx in (0.0, 0.1, -0.1, 0.2, -0.2):
            cone = OrientationConstraint.make(
                axis_local=(0, 0, 1), target_world=(tx, 0.0, 1.0),
                tolerance=0.25, weight=0.3)
            yield f"target_x{tx:+.1f}", 0.0, dict(world=world,
                                                  constraints=cone)

    for label, kernel, changes, cfg in (
            ("config4_grid", "rollout_grid", grid_changes(), cfg4),
            ("config4_moved_box", "rollout_analytic", box_changes(), cfg4),
            ("config4_cone_target", "rollout_analytic:con", cone_changes(),
             cfg_con)):
        graph_inputs_phase(label, kernel, changes,
                           lambda gen, cfg=cfg, **kw: plan_batch(
                               robot, kw.pop("world"), prob, cfg,
                               generator=gen, **kw), smi, B)


def graph_inputs_mpc_phase(robot, scene, cfg5, spec5, states5, smi,
                           ticks=20, every=5):
    """[graph_inputs:config5_grid]: config 5's scenarios over the tabletop
    as an IncrementalSDF on the card, edited (set_box on the arm's path)
    every `every` of `ticks` ticks: an episode of run_mpc_batch chunks,
    one a world. Graphed (one tick entry: captured in the first chunk,
    asserted), with a forced miss (graph.clear() before each chunk) and
    eager, in turns; every final state bitwise. ms a tick per mode."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.engine.mpc import run_mpc_batch
    from tpustomp_torch.kernels import rollout

    dev = robot.joint_axis.device
    dt = float(spec5["world_dt"])
    inc = incremental_tabletop(scene, dev)
    worlds, edit_ms = [inc.as_world()], []
    for k in range(ticks // every - 1):
        lo = (30 - 4 * k, 38 + 3 * k, 30)
        edit_ms.append(event_ms(lambda: inc.set_box(
            lo, (lo[0] + 4, lo[1] + 4, lo[2] + 6), True))[1])
        worlds.append(inc.as_world())

    def episode(mode):
        gen, state = seeded(dev, 0), states5
        for w in worlds:
            if mode == "miss":
                graph.clear()
            state = in_route("eager" if mode == "eager" else "chunk",
                             lambda s=state, w=w: run_mpc_batch(
                                 robot, cfg5, s, [0.12], every, dt,
                                 static_world=w, device=dev, generator=gen))
        return state

    graph.clear()
    walls = {m: [] for m in ("replay", "miss", "eager")}
    first = None
    for i, order in enumerate((("replay", "miss", "eager"),
                               ("eager", "miss", "replay"))):
        for mode in order:
            rollout.reset_launches()
            graph.reset_counts()
            out, wall = synced(lambda: episode(mode))
            gr = dict(graph.GRAPHS)
            if mode == "replay":
                assert gr.get("captured", 0) == (3 if i == 0 and first is None
                                                 else 0), gr
                assert rollout.LAUNCHES.get("rollout_grid:per_cand_overlay",
                                            0) > 0
                loaded = gr.get("inputs_loaded", 0)
            if mode == "miss":
                assert gr.get("captured") == 3 * len(worlds), gr
            if first is None:
                first = out
            bad = differing(out, first)
            assert not bad, (mode, bad)
            walls[mode].append(wall)
    B5 = states5.q.shape[0]
    say("graph_inputs:config5_grid", B=B5, ticks=ticks, edit_every=every,
        edit_ms=edit_ms, inputs_loaded_per_episode=loaded,
        **{f"{m}_wall_s": w for m, w in walls.items()},
        **{f"median_{m}_ms_per_tick": 1e3 * float(np.median(w)) / ticks
           for m, w in walls.items()},
        regions_captured_after_first=0, bitwise_equal=True, card=smi)


def goal_band_graph_phase(label, rollout, robot, world, cfg, q0b, qNb, smi,
                          band=0.1, turns=8, max_launches=None):
    """[goal_band:<label>]: a ±band goal band on every joint. Host
    launches of api.plan._prepare with the band, in a profiler window
    each (profile_window), eagerly and on the band's cached graph
    (engine/graph.py goal), beside _prepare without a band; then
    resolve_goal_tolerance's wall, eager against graphed in turns (p50),
    the goals bitwise. `max_launches`: the graphed window's bound."""
    from tpustomp_torch import ProblemSpec
    from tpustomp_torch.api.plan import _prepare, resolve_goal_tolerance
    from tpustomp_torch.engine import graph

    dev = robot.joint_axis.device
    B, d = q0b.shape
    prob = ProblemSpec(q0=q0b, qN=qNb, goal_tolerance_below=band,
                       goal_tolerance_above=band)
    plain = ProblemSpec(q0=q0b, qN=qNb)
    _prepare(robot, world, prob, cfg, dev, None)         # captures
    launches = {route: profile_window(rollout, lambda: _prepare(
        robot, world, prob, cfg, dev, None), route)[1]["host_launches"]
        for route in ("eager", "chunk")}
    launches["no_band"] = profile_window(rollout, lambda: _prepare(
        robot, world, plain, cfg, dev, None), "chunk")[1]["host_launches"]
    q0t, qNt = (torch.as_tensor(x, device=dev) for x in (q0b, qNb))
    tol = torch.full((B, d), band, device=dev)
    walls = {"eager": [], "chunk": []}
    outs = {}
    for i in range(turns):
        for route in (("eager", "chunk") if i % 2 == 0
                      else ("chunk", "eager")):
            graph.reset_counts()
            outs[route], wall = synced(lambda: in_route(
                route, lambda: resolve_goal_tolerance(
                    robot, world, cfg, q0t, qNt, tol, tol)))
            if route == "chunk":
                assert graph.GRAPHS["replayed"] == 1, dict(graph.GRAPHS)
                assert not graph.GRAPHS.get("captured"), dict(graph.GRAPHS)
            walls[route].append(wall)
    same = bool(torch.equal(outs["eager"], outs["chunk"]))
    say(f"goal_band:{label}", B=B, band_rad=band,
        prepare_host_launches_eager=launches["eager"],
        prepare_host_launches_graphed=launches["chunk"],
        prepare_host_launches_no_band=launches["no_band"],
        p50_eager_ms=1e3 * float(np.median(walls["eager"])),
        p50_graphed_ms=1e3 * float(np.median(walls["chunk"])),
        eager_wall_s=walls["eager"], graphed_wall_s=walls["chunk"],
        bitwise_equal=same, card=smi)
    assert same
    if max_launches is not None:
        assert launches["chunk"] <= max_launches, launches


# CUDA API calls (runtime cuda*, and their cu* forms) that hand the device
# work: a profiler window's host launches
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_window(rollout, run, route):
    """One utils.tracing.profile window (torch.profiler, CPU and CUDA
    activity, Chrome trace) over run(), the solver loop on `route`
    (in_route): (result, dict of the window's counts and times)."""
    import tempfile

    from torch.autograd import DeviceType

    from tpustomp_torch.engine import graph
    from tpustomp_torch.utils import tracing

    rollout.reset_launches()
    graph.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with tracing.profile(tmp) as prof:
            sol, wall = synced(lambda: in_route(route, run))
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    out = dict(wall_us=1e6 * wall, busy_us=0.0, kernels=0, host_launches=0,
               evaluator_us=0.0, evaluator_launches=0, top=[],
               trace_bytes=trace_bytes, graphs=dict(graph.GRAPHS),
               kernel_launches={k: v for k, v in rollout.LAUNCHES.items()
                                if v})
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            out["host_launches"] += e.count if e.key in HOST_LAUNCHES else 0
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        out["busy_us"] += us
        out["kernels"] += e.count
        out["top"].append((us / 1e3, e.count, e.key[:60]))
        if "rollout_" in e.key:
            out["evaluator_us"] += us
            out["evaluator_launches"] += e.count
    return sol, out


def profile_phase(rollout, robot, world, cfg4, q0b, qNb, smi):
    """[profile:config4]: a profiler window (profile_window) over a config-4
    plan_batch on each route of ROUTES (graphs captured before the
    window): kernels and host launches
    (HOST_LAUNCHES calls) per iteration, device busy time, the idle share
    of the window (1 - busy / wall; the profiler's host cost inflates the
    wall), the evaluator's share, the largest kernels. Then, per mode, the
    slope between two windows of 6 and 14 iterations (no early stop):
    host launches and idle share of the loop's iterations alone, init and
    finalize excluded. Returns the analytic launches of the chunk route's
    window."""
    from tpustomp_torch import ProblemSpec, plan_batch
    from tpustomp_torch.engine import graph

    dev = robot.joint_axis.device
    prob = ProblemSpec(q0=q0b, qN=qNb)

    def run(cfg):
        return lambda: plan_batch(robot, world, prob, cfg,
                                  generator=seeded(dev, 0))

    plain_sol, plain_wall = synced(run(cfg4))
    launches, windows = {}, {}
    for mode in ROUTES:
        synced(lambda: in_route(mode, run(cfg4)))     # captures
        sol, w = profile_window(rollout, run(cfg4), mode)
        iters = int(sol.iterations.max())
        slope = {}
        for k in (6, 14):
            fixed = cfg4.replace(max_iterations=k,
                                 max_iterations_after_collision_free=10**6)
            synced(lambda: in_route(mode, run(fixed)))   # captures
            slope[k] = profile_window(rollout, run(fixed), mode)[1]
        d = {key: (slope[14][key] - slope[6][key]) / 8
             for key in ("host_launches", "kernels", "busy_us", "wall_us")}
        say("profile:config4", mode=mode, B=q0b.shape[0], iterations=iters,
            wall_ms=w["wall_us"] / 1e3, unprofiled_wall_ms=1e3 * plain_wall,
            device_kernel_ms=w["busy_us"] / 1e3,
            idle_pct=100 * (1 - w["busy_us"] / w["wall_us"]),
            kernels=w["kernels"], kernels_per_iteration=w["kernels"] / (
                iters + 1), host_launches=w["host_launches"],
            host_launches_per_iteration=w["host_launches"] / (iters + 1),
            loop_host_launches_per_iteration=d["host_launches"],
            loop_kernels_per_iteration=d["kernels"],
            loop_device_ms_per_iteration=d["busy_us"] / 1e3,
            loop_wall_ms_per_iteration=d["wall_us"] / 1e3,
            loop_idle_pct=100 * (1 - d["busy_us"] / d["wall_us"]),
            evaluator_launches=w["evaluator_launches"],
            evaluator_pct_of_kernel_time=100 * w["evaluator_us"] / max(
                w["busy_us"], 1e-9),
            graphs=w["graphs"], trace_bytes=w["trace_bytes"],
            kernel_launches=w["kernel_launches"],
            top_kernels_ms_count=sorted(w["top"], reverse=True)[:8],
            card=smi)
        assert torch.equal(sol.trajectory, plain_sol.trajectory)
        assert w["kernels"] > 0
        if mode == "chunk":
            launches = w["kernel_launches"]
        windows[mode] = (w, slope[6], slope[14])
        for i, win in enumerate(windows[mode]):
            # the evaluator kernels the profiler saw, in a graph's replays
            # too, are the launches the wrappers counted (a replay adds
            # what its capture counted). The profiler misnames kernels
            # inside IF-node bodies, so a chunk window is held to the
            # per-iteration window's counted launches instead (a chunk adds
            # its iterations' share of its capture's count)
            if mode == "chunk":
                assert win["kernel_launches"] == windows["per_iteration"][
                    i]["kernel_launches"], win
            else:
                assert (win["evaluator_launches"]
                        == win["kernel_launches"]["rollout_analytic"]), win
            graphs = win["graphs"]
            if mode == "eager":
                assert not graphs.get("replayed"), graphs
            else:
                assert graphs.get("replayed", 0) > 0, graphs
                assert graphs.get("chunk" if mode == "chunk" else
                                  "per_iteration:requested", 0) > 0, graphs
    return launches["rollout_analytic"]


def mpc_profile_phase(rollout, robot, world, cfg5, spec5, states5, smi):
    """[profile:config5]: profiler windows (profile_window) over config-5
    episodes (every scenario of states5, the box tabletop), on each route
    of ROUTES (the tick's graphs captured before the windows), of 2 and 4
    ticks; per tick, the slope between them (the load and the copy out
    cancel): host launches (HOST_LAUNCHES calls), kernels, kernel ms, wall
    ms and the idle share (1 - kernel ms / wall ms; the profiler's host
    cost inflates the wall); the 4-tick window's idle share, the
    evaluator's share and largest kernels."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.engine.mpc import run_mpc_batch

    dev = robot.joint_axis.device
    dt = float(spec5["world_dt"])
    name = "rollout_analytic:per_cand_world"

    def run(n):
        return lambda: run_mpc_batch(robot, cfg5, states5, [0.12], n, dt,
                                     static_world=world, device=dev,
                                     generator=seeded(dev, 0))

    graph.clear()
    windows = {}
    for mode in ROUTES:
        synced(lambda: in_route(mode, run(1)))    # captures the tick
        win = {n: profile_window(rollout, run(n), mode)[1] for n in (2, 4)}
        d = {key: (win[4][key] - win[2][key]) / 2
             for key in ("host_launches", "kernels", "busy_us", "wall_us")}
        w = win[4]
        say("profile:config5", mode=mode, B=states5.q.shape[0],
            host_launches_per_tick=d["host_launches"],
            kernels_per_tick=d["kernels"],
            kernel_ms_per_tick=d["busy_us"] / 1e3,
            wall_ms_per_tick=d["wall_us"] / 1e3,
            idle_pct_per_tick=100 * (1 - d["busy_us"] / d["wall_us"]),
            window_ticks=4, window_wall_ms=w["wall_us"] / 1e3,
            window_kernel_ms=w["busy_us"] / 1e3,
            window_idle_pct=100 * (1 - w["busy_us"] / w["wall_us"]),
            window_host_launches=w["host_launches"],
            evaluator_launches=w["evaluator_launches"],
            evaluator_pct_of_kernel_time=100 * w["evaluator_us"] / max(
                w["busy_us"], 1e-9),
            graphs=w["graphs"], trace_bytes=w["trace_bytes"],
            kernel_launches=w["kernel_launches"],
            top_kernels_ms_count=sorted(w["top"], reverse=True)[:8],
            card=smi)
        windows[mode] = win
        for n in (2, 4):
            # the evaluator kernels the profiler saw, in the replays too,
            # are the launches the wrappers counted (a chunk window: the
            # per-iteration window's, as in profile_phase)
            if mode == "chunk":
                assert win[n]["kernel_launches"] == windows[
                    "per_iteration"][n]["kernel_launches"], win[n]
            else:
                assert (win[n]["evaluator_launches"]
                        == win[n]["kernel_launches"][name]), win[n]
            graphs = win[n]["graphs"]
            if mode == "eager":
                assert not graphs.get("replayed"), win[n]
            else:
                assert graphs.get("replayed", 0) > 0, win[n]
                assert not graphs.get("captured"), win[n]
            if mode == "chunk":         # no read inside the episode
                assert graphs.get("chunk", 0) > 0, win[n]
                assert not graphs.get("flag_reads"), win[n]


def main():
    t_start = time.perf_counter()
    # --- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    say("card", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    sys.path.insert(0, ROOT)
    import yaml

    from tpustomp_torch import (NoiseConfig, OrientationConstraint,
                                PositionConstraint)
    from tpustomp_torch._tensors import map_tensors
    from tpustomp_torch.api.config import CostWeights, PlannerConfig, from_dict
    from tpustomp_torch.engine.mpc import _tick_world_batch
    from tpustomp_torch.kernels import rollout
    from tpustomp_torch.robot import load_urdf
    from tpustomp_torch.robot.model import arm_7dof
    from tpustomp_torch.world.sdf import CompositeWorld

    # --- 2. build: the runtime chain and the static chains of arm_7dof and
    # the URDF robot, one nvcc per source and chain, all started together
    robot = arm_7dof().to(dev)
    urdf_robot = load_urdf(torso_arm_urdf()).to(dev)
    chains = {"runtime": None, "arm_7dof": rollout.chain_of(robot),
              "torso_arm_urdf": rollout.chain_of(urdf_robot)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # the IF-node helper beside them
        helper = pool.submit(rollout.build, ("graph_if", "propose", "pi2"))
        rollout.build(chains=tuple(chains.values()))
        helper.result()
    from tpustomp_torch.kernels import graph_if
    graph_if.load(dev)
    say("build", kernels=sorted(rollout.LAUNCHES),
        seconds=round(time.perf_counter() - t0, 3),
        libraries=len(rollout.BUILD_SECONDS),
        graph_if_build_seconds=rollout.BUILD_SECONDS.get(("graph_if", None)),
        propose_build_seconds=rollout.BUILD_SECONDS.get(("propose", None)),
        pi2_build_seconds=rollout.BUILD_SECONDS.get(("pi2", None)),
        first_build_seconds={
            f"{src}:{label}": rollout.BUILD_SECONDS.get((src, c))
            for label, c in chains.items() for src in rollout._SOURCES},
        chains={label: None if c is None else rollout.chain_definition(c)
                for label, c in chains.items()})

    with open(os.path.join(ROOT, "configs", "config4_batch.yaml")) as f:
        doc4 = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "config2_tabletop.yaml")) as f:
        doc2 = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "config5_mpc.yaml")) as f:
        doc5 = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "config3_chomp.yaml")) as f:
        doc3 = yaml.safe_load(f)
    cfg4 = from_dict(doc4["planner"])
    cfg2 = from_dict(doc2["planner"])
    cfg5, spec5 = from_dict(doc5["planner"]), doc5["mpc"]
    scene = doc2["scene"]             # the default tabletop scene
    world = tabletop(scene).to(dev)
    t0 = time.perf_counter()
    grid = voxel_tabletop(scene).to(dev)
    say("voxel_world", shape=list(grid.grid.shape),
        resolution=float(grid.resolution), edt_seconds=round(
            time.perf_counter() - t0, 3))
    composite = CompositeWorld.make(
        grid, spheres=[((0.35, 0.3, 0.55), 0.12)]).to(dev)
    # phase 8's "glass of water" cone (bench.py's constrained row) and a
    # tool-point target: the constraint route's inputs
    cone = OrientationConstraint.make(axis_local=(0, 0, 1),
                                      target_world=(0, 0, 1), tolerance=0.25,
                                      weight=0.3).to(dev)
    spot = PositionConstraint.make((0.7, 0.1, 0.9), tolerance=0.05,
                                   weight=2.0).to(dev)
    B = int(doc4["batch"]["scenarios_per_chip"])
    C = B * (1 + cfg4.num_rollouts + cfg4.noise.num_rollouts_reused)
    T = cfg4.num_timesteps + 2
    dt, clearance = cfg4.dt, cfg4.collision_clearance

    # --- 2p. the propose kernel at the config-4 and config-5 shapes --------
    B5 = int(spec5["scenarios"])
    propose_ms = {
        "config4": propose_phase(
            "config4", robot, B, cfg4.num_timesteps, cfg4.num_rollouts,
            cfg4.noise.num_rollouts_reused, smi),
        "config5": propose_phase(
            "config5", robot, B5, cfg5.num_timesteps, cfg5.num_rollouts,
            cfg5.noise.num_rollouts_reused, smi),
        "config4:B1": propose_phase(
            "config4:B1", robot, 1, cfg4.num_timesteps, cfg4.num_rollouts,
            cfg4.noise.num_rollouts_reused, smi)}

    # --- 2π. PI²'s tail at the config-4 and config-5 shapes and B = 1 -------
    pi2_ms = {
        "config4": pi2_phase("config4", B, cfg4.num_timesteps,
                             cfg4.num_rollouts
                             + cfg4.noise.num_rollouts_reused, smi),
        "config5": pi2_phase("config5", B5, cfg5.num_timesteps,
                             cfg5.num_rollouts
                             + cfg5.noise.num_rollouts_reused, smi),
        "single": pi2_phase("single", 1, cfg4.num_timesteps,
                            cfg4.num_rollouts
                            + cfg4.noise.num_rollouts_reused, smi)}

    # --- 2c. the CHOMP gradient kernel at config 3's shape ------------------
    cfg3 = from_dict(doc3["planner"])
    chomp_grad_res = chomp_grad_phase(robot, tabletop(doc3["scene"]).to(dev),
                                      cfg3, smi)

    # --- 3 / 3g. kernels against plain at the config-4 shape -----------------
    rng = np.random.default_rng(0)
    lo = robot.joint_lower.cpu().numpy()
    hi = robot.joint_upper.cpu().numpy()
    fulls = torch.as_tensor(rng.uniform(lo, hi, (C, T, 7)).astype(np.float32),
                            device=dev)                       # [C, T, d]
    table = {}
    # --- 10. static chain against plain and runtime, config-4 shape -------
    chain_res = {}
    for name, w in (("rollout_analytic", world), ("rollout_grid", grid)):
        chain_res.update(chain_phase(name, rollout, robot, w, fulls, dt,
                                     clearance, cone))
    lo_u = urdf_robot.joint_lower.cpu().numpy()
    hi_u = urdf_robot.joint_upper.cpu().numpy()
    fulls_u = torch.as_tensor(np.random.default_rng(3).uniform(
        lo_u, hi_u, (C, T, urdf_robot.num_joints)).astype(np.float32),
        device=dev)
    chain_phase("rollout_analytic", rollout, urdf_robot, world, fulls_u, dt,
                clearance, cone, tag=":torso_arm_urdf")
    del fulls_u
    # config 4's problems (the CLI's --seed 0 jitter) and, for the kernels'
    # ms_smooth, solver-like candidates on them (min-jerk + sigma L z)
    q0 = np.asarray(scene["q0"], np.float32)
    qN = np.asarray(scene["qN"], np.float32)
    jitter = float(doc4["batch"]["start_goal_jitter"])
    rng = np.random.default_rng(0)                 # as the CLI's --seed 0
    q0b = (np.tile(q0, (B, 1))
           + rng.uniform(-jitter, jitter, (B, 7))).astype(np.float32)
    qNb = (np.tile(qN, (B, 1))
           + rng.uniform(-jitter, jitter, (B, 7))).astype(np.float32)
    problems4 = SimpleNamespace(q=torch.as_tensor(q0b, device=dev),
                                qN=torch.as_tensor(qNb, device=dev))
    smooth4 = solver_like(robot, cfg4, problems4, C // B).permute(
        2, 1, 0).contiguous()
    smooth_ms, timings = {}, {}
    for name, w in (("rollout_analytic", world), ("rollout_grid", grid)):
        *table[name], smooth_ms[name], timings[name] = kernel_phase(
            name, rollout, robot, w, fulls, dt, clearance, smi,
            chain_res[name], smooth4)
    err = check_kernel("rollout_grid:composite", rollout, robot, composite,
                       fulls, dt, clearance)
    packed_vs_dense("rollout_grid:composite", rollout, robot, composite,
                    fulls.permute(2, 1, 0).contiguous(), dt, clearance)
    e, k_ms, p_ms = table["rollout_grid"]
    table["rollout_grid"] = (max(e, err), k_ms, p_ms)
    # --- 7. the :ee forms at the config-4 shape -------------------------------
    for name, w in (("rollout_analytic", world), ("rollout_grid", grid)):
        *table[name + ":ee"], smooth_ms[name + ":ee"] = ee_phase(
            name, rollout, robot, w, fulls, dt, clearance, smi,
            chain_res[name + ":ee"], smooth=smooth4)
    # --- 7c. the :con forms (the constraint route) at the config-4 shape -------
    for name, w in (("rollout_analytic", world), ("rollout_grid", grid)):
        *table[name + ":con"], smooth_ms[name + ":con"] = con_phase(
            name, rollout, robot, w, fulls, dt, clearance, cone, spot, smi,
            chain_res[name + ":con"], smooth=smooth4)
    # ... with a cone made on the card (no host copy: the block, after one
    # read of its device vector at its second launch; its first, here
    # before the counts, takes the memory path) and moved under
    # inference_mode (the memory path)
    made_cone = dataclasses.replace(cone, weight=cone.weight.clone())
    rollout.obstacle_cost_batch(robot, world, fulls[:EDGE_C], dt, clearance,
                                constraints=(made_cone, spot))
    with torch.inference_mode():
        inf_cone = cone.to("cpu").to(dev)
    for tag, c, route, reads in ((":device_read", made_cone, "block", 1),
                                 (":memory_path", inf_cone, "memory", 0)):
        rollout.reset_launches()
        err = con_check("rollout_analytic", rollout, robot, world,
                        fulls[:EDGE_C], dt, clearance, (c, spot),
                        ~inactive_rows(EDGE_C, dev), tag=tag)
        # the :con launch on its route; the two without constraints take
        # the block
        memory = int(route == "memory")
        assert rollout.PARAM_ROUTES == {
            "block": 3 - memory, "large_block": 0, "memory": memory}, (
            rollout.PARAM_ROUTES)
        assert rollout.PARAM_READS["device"] == reads, rollout.PARAM_READS
        e, k_ms, p_ms = table["rollout_analytic:con"]
        table["rollout_analytic:con"] = (max(e, err), k_ms, p_ms)
    del smooth4
    # --- 3e. the lane plan's edges; the parameter routes ----------------------
    err = edges_phase(rollout, robot, world, grid, smi)
    for name in ("rollout_analytic", "rollout_grid"):
        e, k_ms, p_ms = table[name]
        table[name] = (max(e, err), k_ms, p_ms)
    # --- 3s. two streams, two worlds built on the card ------------------------
    two_stream_phase(rollout, robot, world, fulls, dt, clearance, smi)
    # --- 10s. no host sync in a launch ----------------------------------------
    tm_small = fulls[:4096].permute(2, 1, 0).contiguous()
    # a world built on the card, after the one read of its vector (its
    # second launch); another at its first launch (the memory path)
    made_world = dataclasses.replace(world, box_half=world.box_half.clone())
    for _ in range(2):
        rollout.obstacle_cost_batch(robot, made_world, tm_small, dt,
                                    clearance, time_major=True)
    new_world = dataclasses.replace(world, box_half=world.box_half.clone())
    sync_cases = [("rollout_analytic", robot, world, tm_small, None),
                  ("rollout_analytic", robot, made_world, tm_small, None),
                  ("rollout_analytic", robot, new_world, tm_small, None),
                  ("rollout_grid", robot, grid, tm_small, None),
                  ("rollout_analytic:runtime", shuffled(robot, 0), world,
                   tm_small, None),
                  ("rollout_analytic:con", robot, world, tm_small, None,
                   cone),
                  ("rollout_grid:con", robot, grid, tm_small, None, cone)]
    del fulls, tm_small
    torch.cuda.empty_cache()

    # --- 3m. the per-row-world variants at the config-5 shape ---------------
    B5 = int(spec5["scenarios"])
    per5 = 1 + cfg5.num_rollouts + cfg5.noise.num_rollouts_reused
    states5 = config5_states(robot, cfg5, B5, q0, qN,
                             float(spec5["obstacle_speed"]))
    fulls = torch.as_tensor(np.random.default_rng(5).uniform(
        lo, hi, (B5 * per5, cfg5.num_timesteps + 2, 7)).astype(np.float32),
        device=dev)
    smooth = solver_like(robot, cfg5, states5, per5)
    for name, static in (("rollout_analytic:per_cand_world", world),
                         ("rollout_grid:per_cand_overlay", grid)):
        chain_res.update(chain_phase(
            name, rollout, robot, _tick_world_batch(
                states5.sphere_center.to(dev),
                torch.tensor([0.12], device=dev), static),
            fulls, cfg5.dt, cfg5.collision_clearance, cone,
            cands_per_row=per5))
    for name, static in (("rollout_analytic:per_cand_world", world),
                         ("rollout_grid:per_cand_overlay", grid)):
        *table[name], smooth_ms[name] = percand_phase(
            name, rollout, robot, static, states5.sphere_center.to(dev),
            torch.tensor([0.12], device=dev), fulls, smooth, per5, cfg5.dt,
            cfg5.collision_clearance, smi, chain_res[name])
    del smooth
    # --- 7. the :ee forms of the per-row variants at the config-5 shape ----
    for name, static in (("rollout_analytic:per_cand_world", world),
                         ("rollout_grid:per_cand_overlay", grid)):
        *table[name + ":ee"], _ = ee_phase(
            name, rollout, robot, _tick_world_batch(
                states5.sphere_center.to(dev),
                torch.tensor([0.12], device=dev), static),
            fulls, cfg5.dt, cfg5.collision_clearance, smi,
            chain_res[name + ":ee"], cands_per_row=per5)
    # --- 7c. the :con forms of the per-row variants at the config-5 shape ---
    for name, static in (("rollout_analytic:per_cand_world", world),
                         ("rollout_grid:per_cand_overlay", grid)):
        *table[name + ":con"], _ = con_phase(
            name, rollout, robot, _tick_world_batch(
                states5.sphere_center.to(dev),
                torch.tensor([0.12], device=dev), static),
            fulls, cfg5.dt, cfg5.collision_clearance, cone, spot, smi,
            chain_res[name + ":con"], cands_per_row=per5)
    rows5 = 200
    tm5 = fulls[:rows5 * per5].permute(2, 1, 0).contiguous()
    for name, static in (("rollout_analytic:per_cand_world", world),
                         ("rollout_grid:per_cand_overlay", grid)):
        rows_world = _tick_world_batch(
            states5.sphere_center[:rows5].to(dev),
            torch.tensor([0.12], device=dev), static)
        sync_cases += [(name, robot, rows_world, tm5, per5),
                       (name + ":con", robot, rows_world, tm5, per5, cone)]
    sync_free_phase(rollout, sync_cases, cfg5.dt, cfg5.collision_clearance)
    del fulls, tm5, sync_cases
    torch.cuda.empty_cache()

    # --- 4 / 4g. plan_batch on config 4 -------------------------------------
    launches = {
        "rollout_analytic": plan_batch_phase(
            "config4", "rollout_analytic", rollout, robot, world, cfg4, q0b,
            qNb, smi, success_floor=0.9),
    }
    cuda_vs_cpu_phase("config4", robot, world, cfg4, q0b, qNb)
    launches["rollout_grid"] = plan_batch_phase(
        "config4_grid", "rollout_grid", rollout, robot, grid, cfg4, q0b, qNb,
        smi, success_floor=0.5, exact_world=world)
    cuda_vs_cpu_phase("config4_grid", robot, grid, cfg4, q0b, qNb)
    # --- 10u / 10g. a URDF robot on its chain; a stale joint_static ---------
    q0u, qNu = torso_problems(q0b, qNb)
    launches["rollout_analytic"] += plan_batch_phase(
        "config4_urdf", "rollout_analytic", rollout, urdf_robot, world, cfg4,
        q0u, qNu, smi, success_floor=0.0)
    cuda_vs_cpu_phase("config4_urdf", urdf_robot, world, cfg4, q0u, qNu)
    guard_phase(rollout, robot, world, cfg4, q0b[:64], qNb[:64])

    # --- 5 / 5g. plan on config 2 ------------------------------------------
    plan_phase("config2", "rollout_analytic", rollout, robot, world, cfg2,
               scene, smi)
    plan_phase("config2_grid", "rollout_grid", rollout, robot, grid,
               cfg2.replace(num_restarts=4), scene, smi)

    # --- 6 / 6g / 6c. run_mpc_batch on config 5 -----------------------------
    ticks5 = int(spec5["ticks"])
    name = "rollout_analytic:per_cand_world"
    launches[name], rate, episode5 = mpc_phase(
        "config5", name, rollout, robot, cfg5, spec5, world, states5, ticks5,
        smi)
    assert rate <= 0.15, rate     # the JAX package: 0.062 at B=1024 x 120
    name = "rollout_grid:per_cand_overlay"
    launches[name], rate, _ = mpc_phase("config5_grid", name, rollout, robot,
                                        cfg5, spec5, grid, states5, ticks5,
                                        smi)
    assert rate < 0.5, rate       # the CLI's pass line (tpustomp/cli.py:266)
    # the main path's STOMP steps went through the propose kernel
    main_propose = {k: PROPOSE_LAUNCHES[k] for k in
                    ("config4", "config4_grid", "config5", "config5_grid")}
    say("propose:main_path", launches=main_propose, ms=propose_ms)
    assert all(n > 0 for n in main_propose.values()), main_propose
    # ... and through PI²'s tail, once an iteration as the propose kernel
    main_pi2 = {k: PI2_LAUNCHES[k] for k in main_propose}
    say("pi2:main_path", launches=main_pi2, ms=pi2_ms)
    assert main_pi2 == main_propose, (main_pi2, main_propose)
    eight = map_tensors(states5, lambda v: v[:8])
    mpc_cuda_vs_cpu_phase("config5", robot, cfg5, world, eight)
    mpc_cuda_vs_cpu_phase("config5_grid", robot, cfg5, grid, eight)

    # --- 8. constraints and torque on the main path ------------------------
    # bench.py:193-196: config 2 at 50 iterations without the early stop,
    # so both runs do the same work
    cfg_con = cfg2.replace(max_iterations=50,
                           max_iterations_after_collision_free=10**6)
    launches["rollout_analytic:con"] = constrained_phase(
        "config4_constrained", "rollout_analytic:con", rollout, robot, world,
        cfg_con, cone, q0b, qNb, smi)
    launches["rollout_grid:con"] = constrained_phase(
        "config4_grid_constrained", "rollout_grid:con", rollout, robot, grid,
        cfg_con, cone, q0b, qNb, smi)
    for name, static in (("rollout_analytic:per_cand_world:con", world),
                         ("rollout_grid:per_cand_overlay:con", grid)):
        launches[name] = percand_constrained_phase(
            "config5_constrained" + ("_grid" if static is grid else ""),
            name, rollout, robot, cfg5, static, states5, cone, smi)
    # bench.py:349 with bench/common.py:88-100's config (50 iterations)
    cfg_tau = PlannerConfig(
        num_timesteps=100, duration=5.0, num_rollouts=50,
        noise=NoiseConfig(stddev=0.08, decay=0.995, num_rollouts_reused=5),
        weights=CostWeights(obstacle=1.0, smoothness=0.1, torque=0.005),
        collision_clearance=0.05, max_iterations=50,
        max_iterations_after_collision_free=5, record_metrics=False)
    launches["rollout_analytic"] += plan_batch_phase(
        "config4_torque", "rollout_analytic", rollout, robot, world, cfg_tau,
        q0b[:256], qNb[:256], smi, success_floor=0.0)

    # --- 9. CHOMP and HMC (config 3) ------------------------------------------
    world3 = tabletop(doc3["scene"]).to(dev)
    plan_phase("config3", "rollout_analytic", rollout, robot, world3, cfg3,
               doc3["scene"], smi)
    launches["rollout_analytic"] += plan_batch_phase(
        "config3", "rollout_analytic", rollout, robot, world3, cfg3, q0b, qNb,
        smi, success_floor=0.9)
    # bench/experiment_suite.py:198-211 (chomp-hmc)
    cfg_hmc = cfg_tau.replace(
        mode="chomp", learning_rate=0.6, max_iterations=150,
        weights=CostWeights(obstacle=20.0, smoothness=0.1),
        use_hamiltonian_monte_carlo=True, hmc_step_size=0.3,
        hmc_leapfrog_steps=3, hmc_temperature=0.05,
        noise=NoiseConfig(stddev=0.08, decay=0.95, num_rollouts_reused=5))
    launches["rollout_analytic"] += plan_batch_phase(
        "config3_hmc", "rollout_analytic", rollout, robot, world3, cfg_hmc,
        q0b[:256], qNb[:256], smi, success_floor=0.0)
    # the main path's CHOMP gradients went through the kernel: one launch
    # an iteration, L + 1 an HMC iteration (its leapfrog's forces)
    per_iteration = {"plan:config3": 1, "config3": 1,
                     "config3_hmc": cfg_hmc.hmc_leapfrog_steps + 1}
    main_grads = {k: CHOMP_GRAD_LAUNCHES[k] for k in per_iteration}
    want_grads = {k: n * LOOP_ITERATIONS[k] for k, n in per_iteration.items()}
    say("chomp_grad:main_path", launches=main_grads, iterations_times_per=
        want_grads, ms=chomp_grad_res["ms"])
    assert main_grads == want_grads, (main_grads, want_grads)
    assert all(n > 0 for n in main_grads.values()), main_grads
    cuda_vs_cpu_modes_phase("config4_constrained", robot, world,
                            cfg_con.replace(max_iterations=10), q0b, qNb,
                            constraints=cone)
    cuda_vs_cpu_modes_phase("config3", robot, world3, cfg3, q0b, qNb)

    # --- 11. the rest of the planning API ------------------------------------
    launches["rollout_analytic"] += goal_band_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi)
    launches["rollout_analytic"] += plan_timed_phase(
        rollout, robot, world, cfg2, scene, smi)
    launches["rollout_analytic"] += compaction_phase(
        "config4_compacted", "rollout_analytic", rollout, robot, world, cfg4,
        q0b, qNb, smi)
    launches["rollout_grid"] += compaction_phase(
        "config4_compacted_grid", "rollout_grid", rollout, robot, grid, cfg4,
        q0b, qNb, smi)
    launches["rollout_analytic"] += smooth_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi)
    launches["rollout_analytic"] += retry_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi)
    # a budget near config 4's mean iterations, where about half the rows
    # fail the first pass
    launches["rollout_analytic"] += retry_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi, iters=12,
        label="config4:max_iterations_12")
    launches["rollout_analytic"] += stream_phase(
        rollout, robot, world, cfg4, q0, qN, jitter, smi)
    launches["rollout_analytic"] += tune_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi)

    # --- 12. IncrementalSDF, scale-out, the CLI, checkpoint, profile ---------
    launches["rollout_grid"] += incremental_phase(
        rollout, robot, scene, cfg4, q0b, qNb, smi)
    n, ref_sol = sharded_phase(rollout, robot, world, cfg4, q0b, qNb, smi)
    launches["rollout_analytic"] += n
    launches["rollout_analytic"] += two_rank_phase(ref_sol, smi, "cuda:0")
    del ref_sol
    cli_phases(smi)
    launches["rollout_analytic:per_cand_world"] += checkpoint_phase(
        rollout, robot, cfg5, spec5, world, states5, ticks5, episode5, smi)
    # --- 13. the solver loop's CUDA graphs against the eager loop --------
    graph_phases(robot, world, grid, cfg4, cfg2, cfg_con, cone, cfg3, world3,
                 cfg_hmc, scene, doc3, q0b, qNb, smi)
    mpc_graph_phases(robot, world, grid, cfg5, spec5, states5, smi)
    host_work_phase(rollout, robot, world, cfg4, q0b, qNb, smi)
    # --- 13b. the world, the constraints and the goal band as inputs ------
    graph_inputs_phases(robot, scene, cfg4, cfg_con, q0b, qNb, smi)
    graph_inputs_mpc_phase(robot, scene, cfg5, spec5, states5, smi)
    goal_band_graph_phase("config4", rollout, robot, world, cfg4, q0b, qNb,
                          smi, max_launches=15)
    goal_band_graph_phase("config2", rollout, robot, world, cfg2,
                          q0b[:1], qNb[:1], smi)
    launches["rollout_analytic"] += profile_phase(
        rollout, robot, world, cfg4, q0b, qNb, smi)
    mpc_profile_phase(rollout, robot, world, cfg5, spec5, states5, smi)

    pallas = "tpustomp/kernels/rollout_pallas.py"
    replaces = {
        "rollout_analytic": f"{pallas}:741",
        "rollout_grid": f"{pallas}:770",
        "rollout_analytic:per_cand_world": f"{pallas}:741 (per_cand_world)",
        "rollout_grid:per_cand_overlay":
            f"{pallas}:770 + _grid_finish per_cand (:818-829)",
        "rollout_analytic:ee": f"{pallas}:741 (ee_out, :672-682)",
        "rollout_grid:ee": f"{pallas}:770 + ee_out frame (:672-682)",
        "rollout_analytic:per_cand_world:ee":
            f"{pallas}:741 (per_cand_world, ee_out)",
        "rollout_grid:per_cand_overlay:ee":
            f"{pallas}:770 + _grid_finish per_cand + ee_out frame",
    }
    # the constraint route: ee_out and the constraint tail on its frame
    # (tpustomp/costs/constraints.py:112-117, engine/solver.py:540-543)
    for name in list(replaces)[:4]:
        replaces[name + ":con"] = (replaces[name + ":ee"]
                                   + " + constraint_cost_tm tail")
    # each kernel's bound at the shape it was timed at, on the chain it ran
    # (arm_7dof's static chain)
    voxels = grid.grid.numel()
    nb, d = robot.num_bodies, robot.num_joints
    fk = fk_ops(rollout, robot)
    C5, T5 = B5 * per5, cfg5.num_timesteps + 2
    nx4 = world.box_half.shape[0]
    shapes = {
        "rollout_analytic": dict(C=C, T=T, ns=0, nx=nx4),
        "rollout_grid": dict(C=C, T=T, ns=0, nx=0, grid_voxels=voxels),
        "rollout_analytic:per_cand_world": dict(C=C5, T=T5, ns=1, nx=nx4,
                                                rows=B5),
        "rollout_grid:per_cand_overlay": dict(C=C5, T=T5, ns=1, nx=0,
                                              rows=B5, grid_voxels=voxels),
    }
    say("smoke", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    rows = []
    for name in replaces:
        base = name.removesuffix(":ee").removesuffix(":con")
        # the :con forms' times are the cone's (the main path's constraint)
        bound_ms, bound_by = bound(
            d=d, fk=fk, nb=nb, ee=name.endswith(":ee"),
            con_ops=OPS_CONE if name.endswith(":con") else None,
            **shapes[base])
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"tpustomp_torch/csrc/{name.split(':')[0]}.cu",
            "replaces": replaces[name],
            # the :ee forms are off the main path: the constraint route
            # replaced them there
            "launches": launches.get(name, 0),
            "max_abs_err": table[name][0],
            "ms": table[name][1],
            "plain_ms": table[name][2],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,   # no single PyTorch call computes FK→SDF→cost
            "runtime_ms": chain_res[name]["runtime_ms"],
            "static_vs_runtime_max_abs":
                chain_res[name]["static_vs_runtime_max_abs"],
        })
        if name in smooth_ms:
            rows[-1]["ms_smooth"] = smooth_ms[name]
        if name in timings:
            # K4 (candidate-major, staged by the kernel) and K1 / K2 (bodies
            # sorted on the card): their launches over the main-path runs
            # that read K4's (rollout.BODY_ORDER)
            t = timings[name]
            rows[-1].update(
                candidate_major_ms=t["candidate_major_ms"],
                candidate_major_ms_C1024=t[
                    f"candidate_major_ms_C{K4_SMALL_C}"],
                time_major_ms_C1024=t[f"time_major_ms_C{K4_SMALL_C}"],
                unsorted_bodies_ms=t["unsorted_bodies_ms"],
                unsorted_bodies_launches=UNSORTED_LAUNCHES[name])
        if name in K4_LAUNCHES:
            rows[-1]["candidate_major_launches"] = K4_LAUNCHES[name]
    # the CHOMP gradient kernel (replaces no Pallas kernel: the JAX package
    # computes ∇U in XLA), timed and bounded at config 3's shape (phase 2c);
    # its launches over the main path's CHOMP plan, plan_batch and HMC
    rows.append({
        "name": "chomp_grad",
        "route": "cuda",
        "source": "tpustomp_torch/csrc/chomp_grad.cu",
        "replaces": "tpustomp/engine/chomp.py obstacle_functional_gradient "
                    "+ chomp_gradient (XLA)",
        "launches": sum(main_grads.values()),
        "max_abs_err": chomp_grad_res["max_abs_err"],
        "ms": chomp_grad_res["ms"],
        "plain_ms": chomp_grad_res["plain_ms"],
        "bound_ms": chomp_grad_res["bound_ms"],
        "bound_by": chomp_grad_res["bound_by"],
        "library_ms": None,
        "runtime_ms": None,
        "static_vs_runtime_max_abs": None,
    })
    # the chunk route counts the iterations that ran, as the per-iteration
    # replays and the eager loop did: the main path's launches are theirs
    # (K3, K5, K3-pcw, K5-pco, :con; K4 in brackets)
    for name, (n, k4) in MAIN_PATH_LAUNCHES.items():
        row = next(r for r in rows if r["name"] == name)
        assert (row["launches"], row.get("candidate_major_launches")) == (
            n, k4), (name, row["launches"],
                     row.get("candidate_major_launches"), n, k4)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

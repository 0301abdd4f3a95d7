#!/usr/bin/env python3
"""Compare the port's evaluator kernels with another version of the package
on one NVIDIA GPU.

    git archive <commit> tpustomp_torch | tar -x -C _scratch/other
    python3 chip_compare.py --against _scratch/other [--phases ...]

DIR (--against) holds another ``tpustomp_torch``, for example the parent
commit's, unpacked under the git-ignored ``_scratch/``; it builds its
kernels into its own ``_build/``. Only each version's public surface is
used: its ``csrc/*.cu`` sources, ``kernels/rollout.py``'s ``build`` and
``obstacle_cost_batch``, and ``engine.mpc.run_mpc_batch``. Phases (all by
default):

  build     nvcc -Xptxas -v of both versions' csrc/*.cu for sm_90a:
            registers, spill bytes and stack frame per kernel; the loops
            of this tree's per-row kernels in their SASS (cuobjdump); this
            tree's sources also with the static chains of arm_7dof and
            chip_smoke.py's URDF robot (-DROLLOUT_CHAIN); on arm_7dof's
            chain, both versions' SASS accounting of K3, K5, K3-pcw and
            K5-pco (instructions of one pass by class) and an issue-rate
            figure (pass instructions x lane-FKs over the schedulers' issue
            rate at the maximum SM clock);
  kernels   both versions' kernel wrappers loaded side by side (each with
            its own kernels, both on this tree's other modules), on the
            inputs of chip_smoke.py's kernel phases: the config-5 shape
            (C = 210,000, T = 52: per-row worlds on uniform random and on
            solver-like candidates, masked, :ee, the grid with and without
            its packed corner table, the shared world of equal rows) and
            the config-4 shape (C = 57,344, T = 102: K3, K4, K1, K5, K2,
            composite, :ee; uniform and solver-like candidates, all rows
            active and a third masked), config 3's (C = B = 1,024: K3, K4,
            K5 in both layouts) and config 2's (B = 1); the config-5 flush
            (C = 10,000 per-row, both layouts); every parameter trigger
            (chip_smoke.py param_triggers) at configs 4 and 3, between
            two launches of the same robot and world moved with .to(); a
            world built on the card anew, or changed in place, at every
            call (`every_call` cases, configs 4, 3 and 2), also timed as
            calls back to back without synchronisation; the
            constraint route (:con, phase 8's cone) at both shapes, where
            a version without it runs its :ee form (`:con` cases) or its
            :ee form and the constraint tail on the frame, as its solver
            did (`:con+tail` cases). Median ms of
            20 launches by CUDA events, in the order other, this, this,
            other; each side's spread; max |this - other|; resident blocks
            per SM (a version's rollout_occupancy(), where it has one); one launch's
            registers, shared memory and estimated occupancy from the
            profiler's CUDA activity record; --cases keeps the cases whose
            label holds one of its strings;
  episodes  run_mpc_batch on config 5 (10,000 scenarios x 100 ticks, as
            chip_smoke.py) over the box and the voxel tabletop, each
            version in a process of its own (the package is picked by
            sys.path), in the order other, this, this, other: replans/s,
            collision and reached rates; then a torch.profiler window of 3
            ticks after 30: the evaluator's ms per launch and share of the
            device's kernel time; then chip_smoke.py phase 13's small
            episodes on the box tabletop, a fleet of the first 256
            scenarios and one robot's run_mpc (scenario 0), 20 ticks,
            median ms a tick of 8 runs after one that captures;
  constrained
            chip_smoke.py phase 8's runs (config 4's 1,024 problems, config
            2's planner at 50 iterations without the early stop, the cone)
            over the box and the voxel tabletop, each version in a process
            of its own, in the order other, this, this, other: in each,
            three turns of unconstrained then constrained plan_batch
            (overhead %, success, mean max cone excess), then one
            torch.profiler window over each: kernels per iteration, the
            constrained run's extra kernels per iteration, idle share;
  solver    chip_smoke.py phase 13's solves (config 4 over the box and the
            voxel tabletop and with the cone, config 2's plan, config 3's
            CHOMP plan_batch), and config 4 and 2 with a robot and world
            built on the CPU at every call, a box world built on the card
            and an IncrementalSDF edited before every call, with each
            version's own solver loop (a version with engine/graph.py also
            its eager loop, in turns), each version in a process of its
            own, in the order other, this, this, other: median wall,
            solves/s, and a hash of each result (equal hashes: the same
            bits).

Imports nothing of JAX. Prints one JSON object per result, tagged
``[compare:<phase>]``, and the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "episodes", "constrained", "solver")
# the package's own nvcc target (tpustomp_torch/kernels/rollout.py)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
cs = None   # chip_smoke, imported once the package's root is on sys.path


def say(phase, **kv):
    print(f"[compare:{phase}] " + json.dumps(kv), flush=True)


def cuda_tool(name):
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", name)


def demangle(names):
    try:
        out = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def signature_name(demangled):
    """A demangled kernel signature without its parameter list (template
    arguments such as (int)1 stay)."""
    name = demangled.replace("(anonymous namespace)", "<unnamed>")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def build_phase(label, pkg, tmp, loops_of=(), chains=(("runtime", ()),),
                account_chain=None):
    """nvcc -Xptxas -v of every csrc/*.cu of the package at pkg into cubins
    under tmp, for each (chain label, extra nvcc flags) of chains, all at
    once; prints registers, spills and stack per kernel, the SASS loops
    of the kernels whose name holds a string of loops_of, and on the chain
    labelled account_chain (a label, or a tuple of them) the instruction
    accounting of ACCOUNTED.
    Returns {(chain, kernel): instructions of one pass}."""
    csrc = os.path.join(pkg, "csrc")
    procs, passes = {}, {}
    for chain, flags in chains:
        for cu in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
            out = os.path.join(tmp, f"{label}_{chain}_"
                               + cu.replace(".cu", ".cubin"))
            procs[out] = (chain, subprocess.Popen(
                [cuda_tool("nvcc"), *ARCH, *flags, "-cubin", "-Xptxas", "-v",
                 "-o", out, os.path.join(csrc, cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for cubin, (chain, p) in procs.items():
        text, _ = p.communicate()
        assert p.returncode == 0, text
        kernels, fn = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                kernels[fn] = {}
            elif fn and "spill" in line:
                kernels[fn].update(
                    stack=int(re.search(r"(\d+) bytes stack frame", line)[1]),
                    **{f"spill_{k}": int(v) for v, k in re.findall(
                        r"(\d+) bytes spill (stores|loads)", line)})
            elif fn and "Used" in line:
                kernels[fn]["registers"] = int(
                    re.search(r"Used (\d+) reg", line)[1])
        for name, info in zip(demangle(kernels), kernels.values()):
            say("build", version=label, chain=chain,
                kernel=signature_name(name), **info)
        account = chain in (account_chain if isinstance(account_chain, tuple)
                            else (account_chain,))
        if loops_of or account:
            passes.update({(chain, k): v for k, v in sass_loops(
                cubin, loops_of, account).items()})
    return passes


# The instantiations of the accounting, by the world type and the parameter
# route (the kernel's last template argument) in their name: K3 and K5 on a
# shared world (2 boxes; the grid), and the per-row variants at config 5 (1
# sphere and 2 boxes; the grid with 1 overlay sphere), on the parameter
# block, at the shape each runs on the main path (C, T); and the routes K1,
# K2 and the other parameter triggers take: the memory path (ParamPtr, the
# world's counts at run time), and in a version that has it the large
# parameter block (LargeParamBlock, the world's counts at run time).
ACCOUNTED = {
    ("SharedPrims<(int)0, (int)2>", "ParamBlock"): ("K3", 57344, 102),
    ("GridDist<(int)0, (int)0>", "ParamBlock"): ("K5", 57344, 102),
    ("RowPrims<(int)1, (int)2>", "ParamBlock"): ("K3-pcw", 210000, 52),
    ("GridRowDist<(int)1, (int)0>", "ParamBlock"): ("K5-pco", 210000, 52),
    ("SharedPrims<(int)-1, (int)-1>", "ParamBlock"):
        ("K3-any-block", 57344, 102),
    ("SharedPrims<(int)-1, (int)-1>", "ParamPtr"): ("K3-memory", 57344, 102),
    ("GridDist<(int)-1, (int)-1>", "ParamPtr"): ("K5-memory", 57344, 102),
    ("SharedPrims<(int)-1, (int)-1>", "LargeParamBlock"):
        ("K3-large", 57344, 102),
    ("GridDist<(int)-1, (int)-1>", "LargeParamBlock"):
        ("K5-large", 57344, 102),
}
SMS, SCHEDULERS = 132, 4     # H100 SXM: SMs, warp schedulers per SM


def accounted_as(demangled):
    """The ACCOUNTED key of a demangled kernel name, or None."""
    return next((k for k in ACCOUNTED if k[0] in demangled
                 and f"rollout::{k[1]}>" in demangled), None)


def lane_fks(mod, C, T, d=7, ee=False, active=None):
    """Lanes that run a waypoint's FK in one launch of the lane plan of
    kernels/rollout.py `mod` (each window's 32 lanes), over the active
    candidates (a [C] bool array; None: all)."""
    cpb, n_slab = mod._plan(C, T, d, ee)
    act = np.ones(C, bool) if active is None else np.asarray(active, bool)
    per_block = np.add.reduceat(act.astype(np.int64), np.arange(0, C, cpb))
    total = 0
    for s in range(n_slab):
        n_seq = mod._slab(T, n_slab, s)[3]
        total += int((-(-(per_block * n_seq) // mod._CORE)).sum())
    return mod._WARP * total


def lane_fk_ratio(mod, C, T):
    """Lanes that run a waypoint's FK per owned waypoint, all rows active,
    in the version of kernels/rollout.py `mod`: its lane plan, or the
    segment plan of the versions before it (32 lanes a segment)."""
    if hasattr(mod, "_segments"):
        return 32 * mod._segments(T)[1] / T
    return lane_fks(mod, C, T) / (C * T)


def issue_figure(label, mod, passes, clock_mhz):
    """The accounting's issue-rate figure per accounted kernel: pass
    instructions x lane-FKs / (SMs x schedulers x 32 lanes x SM clock), the
    time the card's schedulers take to issue the kernel's warp instructions
    at one a cycle (a diagnostic beside the work-based bound)."""
    for (chain, kernel), n in sorted(passes.items()):
        name, C, T = ACCOUNTED[accounted_as(kernel)]
        ratio = lane_fk_ratio(mod, C, T)
        say("build", version=label, chain=chain, accounted=name, C=C, T=T,
            pass_instructions=n, lane_fks_per_owned_waypoint=ratio,
            sm_clock_mhz=clock_mhz, issue_ms=1e3 * n * C * T * ratio / (
                SMS * SCHEDULERS * 32 * clock_mhz * 1e6))


# SASS opcodes by class for the accounting (the opcode without modifiers)
CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD"),
    "fp32_other": ("FMNMX", "FSETP", "FSEL", "FCHK", "FRND", "F2I", "I2F",
                   "FSWZADD"),
    "mufu": ("MUFU",),
    "lds": ("LDS",), "sts": ("STS",), "shfl": ("SHFL",),
    "ldg": ("LDG",), "stg": ("STG",), "ldc": ("LDC", "ULDC"),
    "local": ("LDL", "STL"),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR",
                "WARPSYNC", "BMOV", "VOTE", "YIELD"),
}


def opcode_classes(texts):
    """{class: count} and {opcode: count} of SASS instruction texts."""
    ops = {}
    for text in texts:
        op = re.sub(r"^@!?U?P\w+\s+", "", text.strip()).split()[0]
        ops[op] = ops.get(op, 0) + 1
    classes = {k: 0 for k in CLASSES}
    classes["other"] = 0
    for op, n in ops.items():
        base = op.split(".")[0]
        cls = next((k for k, v in CLASSES.items() if base in v), "other")
        classes[cls] += n
    return classes, ops


def sass_loops(cubin, loops_of, account=False):
    """Backward branches of the kernels whose mangled name holds one of
    loops_of: (loop start, branch address, instructions). With `account`,
    for the kernels of ACCOUNTED (accounted_as), the instructions of one
    pass by class: of the hot code (up to the last EXIT), the largest loop
    when it holds at least half of it (a warp's loop over windows), else
    all of it (one waypoint a lane); each sincosf / sqrtf / division
    expansion shows as its MUFU (RSQ, RCP) and its slow-path CALLs, the
    slow paths themselves as cold instructions. Returns {kernel:
    instructions of one pass}."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    passes = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        demangled = signature_name(demangle([name])[0])
        accounted = account and accounted_as(demangled) is not None
        if not any(m in name for m in loops_of) and not accounted:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", part)
        loops = []
        for a, text in ins:
            tgt = re.search(r"BRA\s+(?:.*?)0x([0-9a-f]+)", text)
            if tgt and int(tgt[1], 16) < int(a, 16):
                loops.append((hex(int(tgt[1], 16)), hex(int(a, 16)),
                              (int(a, 16) - int(tgt[1], 16)) // 16 + 1))
        info = {}
        if accounted:
            # the hot code: up to the kernel's last EXIT (the slow paths of
            # sincosf, sqrtf and division are placed after it and branch
            # back); its largest loop is a warp's loop over windows
            last = max(int(a, 16) for a, t in ins if t.split()[0] == "EXIT")
            hot = [(a, t) for a, t in ins if int(a, 16) <= last]
            big = max((x for x in loops if int(x[1], 16) <= last),
                      key=lambda x: x[2], default=None)
            if big is not None and 2 * big[2] >= len(hot):
                lo, hi = int(big[0], 16), int(big[1], 16)
                body = [t for a, t in hot if lo <= int(a, 16) <= hi]
                scope = "largest loop"
            else:
                body, scope = [t for _, t in hot], "kernel to its last EXIT"
            classes, ops = opcode_classes(body)
            passes[demangled] = len(body)
            info = dict(pass_scope=scope, pass_instructions=len(body),
                        pass_classes=classes, pass_opcodes=ops,
                        cold_instructions=len(ins) - len(hot))
        say("build", cubin=os.path.basename(cubin), kernel=demangled,
            instructions=len(ins), loops=loops, **info)
    return passes


def load_wrapper(pkg, name):
    """kernels/rollout.py of the package at pkg as module `name`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "kernels", "rollout.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_info(fn):
    """Registers, shared memory, block and estimated occupancy of the
    rollout kernel fn() launches, from the profiler's CUDA activity
    record (None where the record lacks them), and the resident blocks per
    SM that occupancy means (the profiler's figure is the occupancy
    calculator's, cudaOccupancyMaxActiveBlocksPerMultiprocessor's
    arithmetic, over 64 warps an SM)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for e in events:
        if e.get("cat") == "kernel" and "rollout_" in e.get("name", ""):
            a = e.get("args", {})
            out = {k: a.get(k) for k in (
                "registers per thread", "shared memory", "block",
                "est. achieved occupancy %")}
            # every kernel of the call: a layout copy before the evaluator
            # shows here
            out["kernels_in_call"] = len(kernels)
            out["other_kernels"] = [k[:60] for k in kernels
                                    if "rollout_" not in k]
            occ, block = out["est. achieved occupancy %"], out["block"]
            if occ is not None and block:
                warps = -(-int(np.prod(block)) // 32)
                out["resident_blocks_per_sm"] = round(occ / 100 * 64 / warps,
                                                      2)
            return out
    return None


def cone(dev):
    """chip_smoke.py phase 8's "glass of water" cone, on dev."""
    from tpustomp_torch import OrientationConstraint

    return OrientationConstraint.make(axis_local=(0, 0, 1),
                                      target_world=(0, 0, 1), tolerance=0.25,
                                      weight=0.3).to(dev)


class Bench:
    """The inputs of chip_smoke.py's kernel and MPC phases, on the card."""

    def __init__(self, dev):
        import yaml

        from tpustomp_torch.api.config import from_dict
        from tpustomp_torch.engine.mpc import _tick_world_batch
        from tpustomp_torch.robot.model import arm_7dof
        from tpustomp_torch.world.sdf import CompositeWorld

        def doc(name):
            with open(os.path.join(ROOT, "configs", name)) as f:
                return yaml.safe_load(f)

        doc5, doc4 = doc("config5_mpc.yaml"), doc("config4_batch.yaml")
        scene = doc("config2_tabletop.yaml")["scene"]
        self.cfg5, self.spec5 = from_dict(doc5["planner"]), doc5["mpc"]
        self.cfg4 = from_dict(doc4["planner"])
        self.B4 = int(doc4["batch"]["scenarios_per_chip"])
        self.robot = arm_7dof().to(dev)
        self.world = cs.tabletop(scene).to(dev)
        self.grid = cs.voxel_tabletop(scene).to(dev)
        self.composite = CompositeWorld.make(
            self.grid, spheres=[((0.35, 0.3, 0.55), 0.12)]).to(dev)
        q0 = np.asarray(scene["q0"], np.float32)
        qN = np.asarray(scene["qN"], np.float32)
        self.B5 = int(self.spec5["scenarios"])
        self.per5 = (1 + self.cfg5.num_rollouts
                     + self.cfg5.noise.num_rollouts_reused)
        self.states5 = cs.config5_states(self.robot, self.cfg5, self.B5, q0,
                                         qN, float(self.spec5["obstacle_speed"]))
        self.lo = self.robot.joint_lower.cpu().numpy()
        self.hi = self.robot.joint_upper.cpu().numpy()
        centers = self.states5.sphere_center.to(dev)
        radius = torch.tensor([0.12], device=dev)
        self.row_world = {
            w: _tick_world_batch(centers, radius, s)
            for w, s in (("box", self.world), ("voxel", self.grid),
                         ("voxel_dense", cs.dense_twin(self.grid)))}
        self.same_rows = _tick_world_batch(centers[:1].expand_as(centers),
                                           radius, self.world)
        # config 4's problems as chip_smoke.py phase 4 draws them (the CLI's
        # --seed 0 jitter), and config 2's one query
        jitter = float(doc4["batch"]["start_goal_jitter"])
        rng = np.random.default_rng(0)
        self.problems4 = SimpleNamespace(**{
            k: torch.as_tensor(np.tile(q, (self.B4, 1)) + rng.uniform(
                -jitter, jitter, (self.B4, 7)), dtype=torch.float32,
                device=dev) for k, q in (("q", q0), ("qN", qN))})
        self.problems2 = SimpleNamespace(
            q=torch.as_tensor(q0, device=dev)[None],
            qN=torch.as_tensor(qN, device=dev)[None])
        self.cfg2 = from_dict(doc("config2_tabletop.yaml")["planner"])
        self.cone = cone(dev)

    def uniform(self, C, T, seed):
        return torch.as_tensor(np.random.default_rng(seed).uniform(
            self.lo, self.hi, (C, T, 7)).astype(np.float32),
            device=self.robot.joint_axis.device)


def kernel_cases(b):
    """(label, robot, world, x, dt, clearance, kwargs) of the kernels
    phase."""
    dev = b.robot.joint_axis.device
    cfg5, cfg4 = b.cfg5, b.cfg4
    tm5 = b.uniform(b.B5 * b.per5, cfg5.num_timesteps + 2, 5).permute(
        2, 1, 0).contiguous()
    sm5 = cs.solver_like(b.robot, cfg5, b.states5, b.per5).permute(
        2, 1, 0).contiguous()
    C4 = b.B4 * (1 + cfg4.num_rollouts + cfg4.noise.num_rollouts_reused)
    fulls4 = b.uniform(C4, cfg4.num_timesteps + 2, 0)
    tm4 = fulls4.permute(2, 1, 0).contiguous()
    per4 = 1 + cfg4.num_rollouts + cfg4.noise.num_rollouts_reused
    # solver-like config-4 candidates (min-jerk + sigma L z, as phase 3m
    # draws config 5's), and config 2's one scenario (B = 1)
    sm4 = cs.solver_like(b.robot, cfg4, b.problems4, per4).permute(
        2, 1, 0).contiguous()
    cfg2 = b.cfg2
    per2 = 1 + cfg2.num_rollouts + cfg2.noise.num_rollouts_reused
    tm2 = b.uniform(per2, cfg2.num_timesteps + 2, 2).permute(
        2, 1, 0).contiguous()
    sm2 = cs.solver_like(b.robot, cfg2, b.problems2, per2).permute(
        2, 1, 0).contiguous()
    c2 = (cfg2.dt, cfg2.collision_clearance)
    masked4 = dict(time_major=True,
                   row_active=~cs.inactive_rows(C4, dev))
    k5 = dict(time_major=True, cands_per_row=b.per5)
    c5 = (cfg5.dt, cfg5.collision_clearance)
    c4 = (cfg4.dt, cfg4.collision_clearance)
    tmk = dict(time_major=True)
    unsorted = cs.shuffled(b.robot, 0)
    pcw, pco = b.row_world["box"], b.row_world["voxel"]
    # the shared world of equal rows as a user's .to() brings it (the
    # parameter block) and as built on the card (the memory path)
    shared = cs.shared_row(b.same_rows)
    # config 3's CHOMP shape (C = B = 1,024, T = 102: every finalize and
    # CHOMP step evaluates one candidate a scenario) and config 5's flush
    # (C = B = 10,000 per-row, T = 52, candidate-major: _flush_margin_batch)
    fulls3 = b.uniform(b.B4, cfg4.num_timesteps + 2, 3)
    tm3 = fulls3.permute(2, 1, 0).contiguous()
    flush5 = b.uniform(b.B5, cfg5.num_timesteps + 2, 6)
    flush_tm5 = flush5.permute(2, 1, 0).contiguous()
    flush_rows = b.row_world            # B5 rows: one candidate each
    one = dict(cands_per_row=1)
    # each shape's triggers on the tabletop world between two runs of the
    # same robot and world moved with .to() (the 3 KB block), so each is
    # timed beside the block in neighbouring turns; then the sets above the
    # block (they have no 3 KB twin)
    listed = cs.param_triggers(b.robot, b.world) + [
        ("above_block:robot489", cs.big_robot(dev, 163), b.world)]
    small = [t for t in listed if not t[0].startswith("above_block")]
    triggers = [
        (f"K3 {shape} trigger {label}", r, w, x, *c4, tmk)
        for shape, x in (("config4", tm4), ("config3", tm3))
        for label, r, w in [("block_first", b.robot, b.world), *small,
                            ("block_last", b.robot, b.world),
                            *[t for t in listed if t not in small]]]
    # a set without host copies as a user's loop makes it at every call: a
    # world built on the card anew (new tensors, so a new key each time), or
    # the same world changed in place (a new version each time)
    in_place = b.world.to("cpu").to(dev)
    every_call = [
        (f"K3 {shape} every_call {how}", b.robot,
         in_place if how == "in_place" else b.world, x, *c,
         dict(tmk, every_call=how))
        for shape, x, c in (("config4", tm4, c4), ("config3", tm3, c4),
                            ("config2 B=1", tm2, c2))
        for how in ("new_set", "in_place")]
    return [
        *triggers,
        *every_call,
        ("K2 config4 unsorted memory_path", cs.made_on_card(unsorted),
         b.grid, tm4, *c4, tmk),
        ("K3 config3", b.robot, b.world, tm3, *c4, tmk),
        ("K4 config3 candidate_major", b.robot, b.world, fulls3, *c4, {}),
        ("K5 config3", b.robot, b.grid, tm3, *c4, tmk),
        ("K5 config3 candidate_major", b.robot, b.grid, fulls3, *c4, {}),
        ("K5 config4 candidate_major", b.robot, b.grid, fulls4, *c4, {}),
        ("pcw config5 flush", b.robot, flush_rows["box"], flush_tm5, *c5,
         dict(tmk, **one)),
        ("K4 pcw config5 flush candidate_major", b.robot, flush_rows["box"],
         flush5, *c5, one),
        ("pco config5 flush", b.robot, flush_rows["voxel"], flush_tm5, *c5,
         dict(tmk, **one)),
        ("K4 pco config5 flush candidate_major", b.robot,
         flush_rows["voxel"], flush5, *c5, one),
        ("pcw random", b.robot, pcw, tm5, *c5, k5),
        ("pcw solver_like", b.robot, pcw, sm5, *c5, k5),
        ("pco random", b.robot, pco, tm5, *c5, k5),
        ("pco solver_like", b.robot, pco, sm5, *c5, k5),
        ("K3 config4", b.robot, b.world, tm4, *c4, tmk),
        ("K5 config4", b.robot, b.grid, tm4, *c4, tmk),
        ("pco dense_grid random", b.robot, b.row_world["voxel_dense"], tm5,
         *c5, k5),
        ("pco dense_grid solver_like", b.robot, b.row_world["voxel_dense"],
         sm5, *c5, k5),
        ("pcw masked_third", b.robot, pcw, tm5, *c5,
         dict(k5, row_active=~cs.inactive_rows(tm5.shape[-1], dev))),
        ("pcw every_row_equal", b.robot, b.same_rows, tm5, *c5, k5),
        ("pcw shared_world", b.robot, shared.to("cpu").to(dev), tm5, *c5,
         tmk),
        ("pcw shared_world memory_path", b.robot, shared, tm5, *c5, tmk),
        ("K1 config4 unsorted memory_path", cs.made_on_card(unsorted),
         b.world, tm4, *c4, tmk),
        ("pcw:ee random", b.robot, pcw, tm5, *c5, dict(k5, want_ee=True)),
        ("pco:ee random", b.robot, pco, tm5, *c5, dict(k5, want_ee=True)),
        ("K4 config4 candidate_major", b.robot, b.world, fulls4, *c4, {}),
        ("K1 config4 unsorted", unsorted, b.world, tm4, *c4, tmk),
        ("K3 config4 masked_third", b.robot, b.world, tm4, *c4,
         dict(tmk, row_active=~cs.inactive_rows(C4, dev))),
        ("K5 config4 dense_grid", b.robot, cs.dense_twin(b.grid), tm4, *c4,
         tmk),
        ("K2 config4 unsorted", unsorted, b.grid, tm4, *c4, tmk),
        ("K5 config4 composite", b.robot, b.composite, tm4, *c4, tmk),
        ("K5 config4 masked_third", b.robot, b.grid, tm4, *c4, masked4),
        ("K3 config4 solver_like", b.robot, b.world, sm4, *c4, tmk),
        ("K5 config4 solver_like", b.robot, b.grid, sm4, *c4, tmk),
        ("K3 config4 solver_like masked_third", b.robot, b.world, sm4, *c4,
         masked4),
        ("K5 config4 solver_like masked_third", b.robot, b.grid, sm4, *c4,
         masked4),
        *[(f"{k}{form} config4{tag}", b.robot, w, x, *c4, dict(kw, **extra))
          for form, extra in ((":ee", dict(want_ee=True)),
                              (":con", dict(constraints=b.cone)),
                              (":con+tail", dict(constraints=b.cone,
                                                 tail=True)))
          for k, w in (("K3", b.world), ("K5", b.grid))
          for tag, x, kw in (("", tm4, tmk), (" masked_third", tm4, masked4),
                             (" solver_like", sm4, tmk))],
        *[(f"{k}{form} random", b.robot, w, tm5, *c5, dict(k5, **extra))
          for form, extra in ((":con", dict(constraints=b.cone)),
                              (":con+tail", dict(constraints=b.cone,
                                                 tail=True)))
          for k, w in (("pcw", pcw), ("pco", pco))],
        # the 31 KB parameter's cost a launch: robots just within and just
        # above the 3 KB block (156 and 159 bodies on the runtime chain:
        # 768 and 780 floats with the tabletop)
        *[(f"K3 {shape} payload {label}", cs.big_robot(dev, n), b.world, x,
           *c, tmk)
          for shape, x, c in (("config2 B=1", tm2, c2), ("config4", tm4, c4))
          for label, n in (("block_156_bodies", 52),
                           ("large_block_159_bodies", 53))],
        ("K3 config2 B=1", b.robot, b.world, tm2, *c2, tmk),
        ("K5 config2 B=1", b.robot, b.grid, tm2, *c2, tmk),
        ("K3 config2 B=1 solver_like", b.robot, b.world, sm2, *c2, tmk),
        ("K5 config2 B=1 solver_like", b.robot, b.grid, sm2, *c2, tmk),
    ]


def has_con(mod):
    """Whether the version of kernels/rollout.py `mod` has the constraint
    route (obstacle_cost_batch's `constraints`)."""
    return "constraints" in inspect.signature(
        mod.obstacle_cost_batch).parameters


def route(mod, kw):
    """(the case's kwargs for `mod`, its constraint tail or None). A case
    with constraints on a version without the constraint route takes that
    version's :ee form and, with tail=True, the constraint tail on its
    frame (costs/constraints.py constraint_cost_tm), as its solver did."""
    kw = dict(kw)
    kw.pop("every_call", None)
    tail = kw.pop("tail", False)
    cons = kw.get("constraints")
    if cons is None or has_con(mod):
        return kw, None
    del kw["constraints"]
    kw["want_ee"] = True
    return kw, cons if tail else None


def caller(mod, robot, world, x, dt, clearance, kw):
    """fn() running the case on `mod` (route); returns q_obs, margin and,
    where there is one, q_con. With every_call="new_set" each call first
    builds the world's box_half anew on the card, with "in_place" it
    multiplies it by 1 in place (a new version, the same values)."""
    from tpustomp_torch.costs.constraints import constraint_cost_tm

    every = kw.get("every_call")
    kw, tail = route(mod, kw)

    def fn():
        w = world
        if every == "new_set":
            w = dataclasses.replace(world, box_half=world.box_half.clone())
        elif every == "in_place":
            world.box_half.mul_(1.0)
        out = mod.obstacle_cost_batch(robot, w, x, dt, clearance, **kw)
        if tail is not None:
            return out[0], out[1], constraint_cost_tm(robot, tail, out[2])
        return out

    return fn


def back_to_back_ms(fn, calls=20, reps=5):
    """Median over reps of the milliseconds a call of fn() takes within
    calls issued back to back between two CUDA events (no synchronisation
    between them), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[reps // 2]


def kernels_phase(this, other, cases, only=None):
    """Each case in turns (other, this, this, other); `only`: the cases
    whose label holds one of these strings."""
    for label, robot, world, x, dt, clearance, kw in cases:
        if only and not any(o in label for o in only):
            continue
        f_o, f_t = (caller(m, robot, world, x, dt, clearance, kw)
                    for m in (other, this))
        o1 = cs.cuda_time_ms(f_o, 20)
        t1 = cs.cuda_time_ms(f_t, 20)
        t2 = cs.cuda_time_ms(f_t, 20)
        o2 = cs.cuda_time_ms(f_o, 20)
        # the outputs both sides have (an :ee frame has no q_con beside it)
        pairs = [(u, v) for u, v in zip(f_o(), f_t()) if u.shape == v.shape]
        o_ms, t_ms = (o1 + o2) / 2, (t1 + t2) / 2
        blocks = {side: mod.rollout_occupancy(robot, world, x, dt, clearance,
                                              **route(mod, kw)[0])
                  for side, mod in (("other", other), ("this", this))
                  if hasattr(mod, "rollout_occupancy")}
        if "every_call" in kw:
            # calls back to back, as a loop issues them: a host sync in the
            # launch (a read of the parameters) waits for the work queued
            # before it
            ob1, tb1, tb2, ob2 = (back_to_back_ms(f)
                                  for f in (f_o, f_t, f_t, f_o))
            say("kernels", case=label + " back_to_back",
                other_ms=[ob1, ob2], this_ms=[tb1, tb2],
                speedup=(ob1 + ob2) / (tb1 + tb2))
        say("kernels", case=label, other_ms=[o1, o2], this_ms=[t1, t2],
            resident_blocks_per_sm=blocks,
            speedup=o_ms / t_ms, other_spread_pct=100 * abs(o1 - o2) / o_ms,
            this_spread_pct=100 * abs(t1 - t2) / t_ms,
            max_abs_this_vs_other=max(float((u - v).abs().max())
                                      for u, v in pairs),
            bitwise_equal=all(torch.equal(u, v) for u, v in pairs),
            outputs_compared=len(pairs),
            this_launch=launch_info(f_t), other_launch=launch_info(f_o))


def episode(b, static, ticks, state=None):
    from tpustomp_torch.engine.mpc import run_mpc_batch

    dev = b.robot.joint_axis.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_mpc_batch(b.robot, b.cfg5, b.states5 if state is None
                        else state, [0.12], ticks,
                        float(b.spec5["world_dt"]), static_world=static,
                        device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def episodes_worker(label):
    """One version's episodes and profile windows, in this process's
    package."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpustomp_torch

    b = Bench(torch.device("cuda"))
    ticks = int(b.spec5["ticks"])
    for world, static in (("box", b.world), ("voxel", b.grid)):
        episode(b, static, 2)                       # build and warm up
        out, wall = episode(b, static, ticks)
        say("episodes", world=world, version=label, wall_s=wall,
            replans_per_s=b.B5 * ticks / wall,
            collision_rate=float(out.collided.float().mean()),
            reached_rate=float((out.reached_tick >= 0).float().mean()),
            package=os.path.dirname(tpustomp_torch.__file__))
        mid, _ = episode(b, static, 30)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = episode(b, static, 3, mid)
        busy = ev = 0.0
        n_ev = n_k = 0
        top = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            busy += us
            n_k += e.count
            top.append((us / 1e3, e.count, e.key[:60]))
            if "rollout_" in e.key:
                ev += us
                n_ev += e.count
        say("episodes", world=world, version=label, profiled_ticks=3,
            wall_ms=1e3 * wall, device_kernel_ms=busy / 1e3,
            idle_pct=100 * (1 - busy / 1e6 / wall), kernels=n_k,
            evaluator_launches=n_ev,
            evaluator_ms_per_launch=ev / 1e3 / max(n_ev, 1),
            evaluator_pct_of_kernel_time=100 * ev / max(busy, 1e-9),
            top_kernels_ms_count=sorted(top, reverse=True)[:6])
    small_episodes(b, label)


def small_episodes(b, label, ticks=20, runs=8):
    """A fleet of the first 256 scenarios (run_mpc_batch) and one robot
    (run_mpc, scenario 0) on the box tabletop: ms a tick, the median of
    `runs` episodes after one that captures the tick."""
    from tpustomp_torch._tensors import map_tensors
    from tpustomp_torch.engine.mpc import run_mpc

    dev = b.robot.joint_axis.device
    dt = float(b.spec5["world_dt"])
    fleet = map_tensors(b.states5, lambda v: v[:256])
    one = map_tensors(b.states5, lambda v: v[0])
    cases = {
        "fleet256": lambda: episode(b, b.world, ticks, fleet)[1],
        "one_robot": lambda: cs.synced(lambda: run_mpc(
            b.robot, b.cfg5, one, [0.12], ticks, dt, static_world=b.world,
            device=dev, generator=torch.Generator(dev).manual_seed(0)))[1],
    }
    for name, run in cases.items():
        run()
        walls = [run() for _ in range(runs)]
        say("episodes", world="box", case=name, version=label, ticks=ticks,
            wall_s=walls, ms_per_tick=1e3 * float(np.median(walls)) / ticks)


def profiled(fn):
    """(fn(), its torch.profiler window: CUDA kernels launched, their
    device ms, the idle share of the window's wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_k = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
            n_k += e.count
    return out, dict(kernels=n_k, device_kernel_ms=busy / 1e3,
                     wall_ms=1e3 * wall,
                     idle_pct=100 * (1 - busy / 1e6 / wall))


def constrained_worker(label):
    """One version's chip_smoke.py phase-8 runs, in this process's
    package: three turns of unconstrained then constrained plan_batch over
    each tabletop, then a profiler window over each run."""
    import tpustomp_torch
    from tpustomp_torch import ProblemSpec, plan_batch
    from tpustomp_torch.kernels import rollout

    dev = torch.device("cuda")
    b = Bench(dev)
    cfg = b.cfg2.replace(max_iterations=50,
                         max_iterations_after_collision_free=10**6)
    q0b = b.problems4.q.cpu().numpy()
    qNb = b.problems4.qN.cpu().numpy()
    for world, w in (("box", b.world), ("voxel", b.grid)):
        for turn in range(3):
            free, wall_f, _ = cs.timed_plan_batch(rollout, b.robot, w, cfg,
                                                  q0b, qNb)
            sol, wall_c, launches = cs.timed_plan_batch(
                rollout, b.robot, w, cfg, q0b, qNb, constraints=b.cone)
            say("constrained", world=world, version=label, turn=turn,
                overhead_pct=100.0 * (wall_c / wall_f - 1.0),
                solves_per_s=b.B4 / wall_c,
                unconstrained_solves_per_s=b.B4 / wall_f,
                success_rate=float(sol.success.float().mean()),
                unconstrained_success_rate=float(
                    free.success.float().mean()),
                mean_max_cone_excess_rad=float(cs.cone_excess(
                    b.robot, sol.trajectory, b.cone).mean()),
                unconstrained_mean_max_cone_excess_rad=float(cs.cone_excess(
                    b.robot, free.trajectory, b.cone).mean()),
                kernel_launches=launches,
                package=os.path.dirname(tpustomp_torch.__file__))
        prob = ProblemSpec(q0=q0b, qN=qNb)
        window = {}
        for run, kw in (("unconstrained", {}),
                        ("constrained", dict(constraints=b.cone))):
            sol, window[run] = profiled(lambda: plan_batch(
                b.robot, w, prob, cfg, device=dev,
                generator=torch.Generator(dev).manual_seed(0), **kw))
            window[run]["kernels_per_iteration"] = (
                window[run]["kernels"] / (int(sol.iterations.max()) + 1))
        say("constrained", world=world, version=label, profile=window,
            extra_kernels_per_iteration=(
                window["constrained"]["kernels_per_iteration"]
                - window["unconstrained"]["kernels_per_iteration"]))


def solver_worker(label):
    """One version's solves, in this process's package: chip_smoke.py
    phase 13's cases, and the forms a user's calls take: a robot and world
    built on the CPU anew at every call with device="cuda" (the README's;
    `host_objects`), a box world built on the card (`device_world`), and
    the voxel tabletop as an IncrementalSDF edited (a small box set and
    cleared in turn, untimed) before every call (`incremental`). Each case
    is a first call (a version with engine/graph.py captures its graph
    there) then timed calls (4; config 2's 8), each between two syncs; a
    version with engine/graph.py times its graphed loop and its eager loop
    (graph.eager()) in turns. The median wall and solves/s per loop, and a
    hash of the first result's trajectory and cost (the same in both
    versions and loops when nothing moved a bit)."""
    import contextlib
    import hashlib

    import yaml

    import tpustomp_torch
    from tpustomp_torch import ProblemSpec, plan, plan_batch
    from tpustomp_torch.api.config import from_dict
    from tpustomp_torch.robot.model import arm_7dof
    from tpustomp_torch.world.edt import IncrementalSDF, occupancy_from_analytic
    from tpustomp_torch.world.sdf import AnalyticWorld

    dev = torch.device("cuda")
    b = Bench(dev)
    with open(os.path.join(ROOT, "configs", "config3_chomp.yaml")) as f:
        doc3 = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "config2_tabletop.yaml")) as f:
        scene = yaml.safe_load(f)["scene"]
    cfg3 = from_dict(doc3["planner"])
    world3 = cs.tabletop(doc3["scene"]).to(dev)
    prob4 = ProblemSpec(q0=b.problems4.q, qN=b.problems4.qN)
    prob2 = ProblemSpec(q0=b.problems2.q[0], qN=b.problems2.qN[0])
    cfg_con = b.cfg2.replace(max_iterations=50,
                             max_iterations_after_collision_free=10**6)
    device_world = AnalyticWorld(*(getattr(b.world, f.name).to(dev) * 1.0
                                   for f in dataclasses.fields(b.world)))
    spec = scene["grid"]
    inc = IncrementalSDF(occupancy_from_analytic(
        cs.tabletop(scene), spec["origin"], tuple(spec["shape"]),
        spec["resolution"]), spec["origin"], spec["resolution"],
        max_distance=0.5, device=dev)
    edits = []

    def edit():
        inc.set_box((30, 40, 30), (34, 44, 34), len(edits) % 2 == 0)
        edits.append(1)

    def gen():
        return torch.Generator(dev).manual_seed(0)

    cases = {
        "config4": (b.B4, lambda: plan_batch(b.robot, b.world, prob4, b.cfg4,
                                             device=dev, generator=gen())),
        "config4_grid": (b.B4, lambda: plan_batch(
            b.robot, b.grid, prob4, b.cfg4, device=dev, generator=gen())),
        "config4_constrained": (b.B4, lambda: plan_batch(
            b.robot, b.world, prob4, cfg_con, device=dev,
            constraints=b.cone, generator=gen())),
        "config2": (1, lambda: plan(b.robot, b.world, prob2, b.cfg2,
                                    device=dev, generator=gen())),
        "config3_batch": (b.B4, lambda: plan_batch(
            b.robot, world3, prob4, cfg3, device=dev, generator=gen())),
        "config4_host_objects": (b.B4, lambda: plan_batch(
            arm_7dof(), cs.tabletop(scene), prob4, b.cfg4, device="cuda",
            generator=gen())),
        "config2_host_objects": (1, lambda: plan(
            arm_7dof(), cs.tabletop(scene), prob2, b.cfg2, device="cuda",
            generator=gen())),
        "config4_device_world": (b.B4, lambda: plan_batch(
            b.robot, device_world, prob4, b.cfg4, device=dev,
            generator=gen())),
        "config4_incremental": (b.B4, lambda: plan_batch(
            b.robot, inc.as_world(), prob4, b.cfg4, device=dev,
            generator=gen())),
    }
    try:
        from tpustomp_torch.engine import graph
        loops = {"graphed": contextlib.nullcontext, "eager": graph.eager}
    except ImportError:
        loops = {"eager": contextlib.nullcontext}
    for name, (B, run) in cases.items():
        edited = name.endswith("incremental")
        if edited:
            edit()
        first, first_wall = cs.synced(run)
        walls = {mode: [] for mode in loops}
        order = list(loops)
        for i in range(8 if B == 1 else 4):
            for mode in (order if i % 2 == 0 else order[::-1]):
                if edited:
                    edit()
                with loops[mode]():
                    walls[mode].append(cs.synced(run)[1])
        med = {mode: float(np.median(w)) for mode, w in walls.items()}
        digest = hashlib.sha256(
            first.trajectory.cpu().numpy().tobytes()
            + first.cost.cpu().numpy().tobytes()).hexdigest()[:16]
        say("solver", case=name, version=label, B=B, first_wall_s=first_wall,
            wall_s=walls, median_wall_s=med,
            per_s={mode: B / m for mode, m in med.items()},
            result_sha256_16=digest,
            package=os.path.dirname(tpustomp_torch.__file__))


def main():
    global cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="directory holding the other tpustomp_torch")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--cases", default="",
                    help="kernels phase: only the cases whose label holds "
                         "one of these comma-separated strings")
    ap.add_argument("--worker", choices=("this", "other"),
                    help="run one version's episodes or constrained runs "
                         "in this process")
    ap.add_argument("--worker-phase",
                    choices=("episodes", "constrained", "solver"),
                    default="episodes")
    args = ap.parse_args()
    roots = {"this": ROOT, "other": os.path.abspath(args.against)}
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.worker:
        sys.path.insert(0, roots[args.worker])
        import chip_smoke
        cs = chip_smoke
        {"episodes": episodes_worker, "constrained": constrained_worker,
         "solver": solver_worker}[args.worker_phase](args.worker)
        return
    import chip_smoke
    cs = chip_smoke
    phases = args.phases.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if "build" in phases:
        from tpustomp_torch.kernels import rollout as this
        from tpustomp_torch.robot import load_urdf
        from tpustomp_torch.robot.model import arm_7dof

        chains = [("runtime", ())] + [
            (label, this._nvcc_flags(this.chain_of(robot))[
                len(this._NVCC_FLAGS):])
            for label, robot in (("arm_7dof", arm_7dof()),
                                 ("torso_arm_urdf",
                                  load_urdf(cs.torso_arm_urdf())))]
        say("build", nvcc=subprocess.run(
            [cuda_tool("nvcc"), "--version"], capture_output=True,
            text=True).stdout.strip().splitlines()[-2:])
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], check=True,
            capture_output=True, text=True).stdout.split()[0])
        other_pkg = os.path.join(roots["other"], "tpustomp_torch")
        with tempfile.TemporaryDirectory() as tmp:
            passes = build_phase("other", other_pkg, tmp, chains=chains[:2],
                                 account_chain=("arm_7dof", "runtime"))
            issue_figure("other", load_wrapper(other_pkg, "rollout_other"),
                         passes, clock)
            passes = build_phase("this", os.path.join(ROOT, "tpustomp_torch"),
                                 tmp, loops_of=("RowPrims", "GridRowDist"),
                                 chains=chains,
                                 account_chain=("arm_7dof", "runtime"))
            issue_figure("this", this, passes, clock)
    if "kernels" in phases:
        from tpustomp_torch.kernels import rollout as this

        other = load_wrapper(os.path.join(roots["other"], "tpustomp_torch"),
                             "rollout_other")
        t0 = time.perf_counter()
        this.build()
        other.build()
        say("kernels", build_seconds_both=time.perf_counter() - t0)
        kernels_phase(this, other, kernel_cases(Bench(torch.device("cuda"))),
                      [c for c in args.cases.split(",") if c])
        torch.cuda.empty_cache()
    for phase in ("episodes", "constrained", "solver"):
        if phase not in phases:
            continue
        for side in ("other", "this", "this", "other"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--against", roots["other"], "--worker", side,
                            "--worker-phase", phase], check=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()

"""Where an evaluator launch's parameters live (kernels/rollout.py
``param_route`` / ``_launch_params``), and how the kernels stage the
candidate-major input (the TPU's K4).

Parameter routes: the 3 KB kernel parameter block for a set of at most
kParamFloats floats, the 31 KB large block up to kLargeParamFloats, both
filled on the host, from the tensors' host copies or, for a set without
them (built on the card, changed in place since it was moved), from one
read of pack_params's device vector per set of tensors and versions; the
memory path (staged in shared memory) above the large block and for
tensors moved under torch.inference_mode(), which keep no version counter.
The route is decided from shapes and tensor kinds alone, so the "meta"
device stands in for the card; the device read is replayed on CPU tensors
(which have no host copies either), where the vector it caches must never
outlive a change to a tensor.

The joint tile's stage (csrc/rollout_common.cuh ``evaluate``): thread
(r0, cc) of a block of 256 threads, cc = i % cpb, r0 = i / cpb, loads
rows r0, r0 + 256 / cpb, .. of column cc for every joint, element (j, t,
c) at j * sj + t * st + c * sc: strides (T * C, C, 1) for the time-major
[d, T, C], (1, d, T * d) for the candidate-major [C, T, d] (the TPU's
K4, staged by the kernel: ``cand_major``). Replayed here in numpy for both
layouts, it must give the tile [d][cpb][n_seq] of permute(2, 1, 0), masked
columns untouched.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from tpustomp_torch.costs.constraints import (OrientationConstraint,
                                              PositionConstraint)
from tpustomp_torch.kernels import rollout as tr
from torch.utils._python_dispatch import TorchDispatchMode

from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.edt import grid_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]
_BLOCK = tr._WARP * tr._WARPS


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spheres(n, seed=7):
    rng = np.random.default_rng(seed)
    return AnalyticWorld.make(
        spheres=[(tuple(rng.uniform(-0.8, 0.8, 3)), rng.uniform(0.05, 0.2))
                 for _ in range(n)], boxes=_BOXES)


def _grid():
    return grid_from_analytic(AnalyticWorld.make(boxes=_BOXES),
                              (-0.2, -0.8, -0.1), (12, 14, 10), 0.1)


def _triggers(device="meta"):
    """(label, robot, world, route) for each way a launch leaves the 3 KB
    block of a robot and world moved with .to() (the triggers chip_smoke.py
    param_triggers builds on the card), with the route it takes."""
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    moved_robot, moved_world = robot.to(device), world.to(device)
    changed = world.to(device)
    changed.box_half.add_(0.0)
    with torch.inference_mode():
        inf_robot, inf_world = robot.to(device), world.to(device)
    big = dataclasses.replace(tmodel.arm_7dof(spheres_per_link=70),
                              joint_static=None)
    return [
        ("moved", moved_robot, moved_world, "block"),
        ("above_block:world", moved_robot, _spheres(200).to(device),
         "large_block"),
        ("above_block:robot", big.to(device), moved_world, "large_block"),
        ("above_block:robot489",
         tmodel.arm_7dof(spheres_per_link=163).to(device), moved_world,
         "large_block"),
        ("made_on_card:world", moved_robot, dataclasses.replace(
            moved_world, box_half=torch.ones(2, 3, device=device)), "block"),
        ("made_on_card:robot", dataclasses.replace(
            moved_robot, body_offset=torch.zeros(12, 3, device=device)),
         moved_world, "block"),
        ("changed_in_place", moved_robot, changed, "block"),
        ("inference_mode", inf_robot, inf_world, "memory"),
        ("inference_world_only", moved_robot, inf_world, "memory"),
        ("above_large_block", moved_robot, _spheres(2000).to(device),
         "memory"),
    ]


@pytest.mark.parametrize("i", range(10))
def test_param_route_of_each_trigger(i):
    """The route a launch would take for each trigger, from shapes and
    tensor kinds alone; the block routes' vectors from host copies where
    every tensor has one."""
    label, robot, world, route = _triggers()[i]
    assert tr.param_route(robot, world) == route, label
    host = tr._host_params(robot, world, True)
    has_copies = label in ("moved", "above_block:world",
                           "above_block:robot", "above_block:robot489")
    assert (host is not None) == has_copies, label
    if host is not None:
        assert host.size == tr._param_floats(robot, world, True)


@pytest.mark.parametrize("kind", ["analytic", "empty", "grid", "composite",
                                  "rows"])
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r", "unsorted",
                                        "big"])
def test_param_floats_equals_pack_params(robot_name, kind):
    """The route's count, from shapes, is pack_params's length, with and
    without the constraint section."""
    robot = {"arm_7dof": tmodel.arm_7dof, "planar_2r": tmodel.planar_2r,
             "big": lambda: tmodel.arm_7dof(spheres_per_link=70)}.get(
        robot_name, tmodel.arm_7dof)()
    if robot_name == "unsorted":
        robot = dataclasses.replace(robot, body_counts=None)
    world = {"analytic": lambda: _spheres(3), "empty": AnalyticWorld.make,
             "grid": _grid,
             "composite": lambda: CompositeWorld.make(
                 _grid(), spheres=[((0.3, 0.3, 0.5), 0.1)]),
             "rows": lambda: AnalyticWorld(
                 sphere_center=torch.zeros(5, 1, 3),
                 sphere_radius=torch.ones(5, 1),
                 box_center=torch.zeros(5, 2, 3),
                 box_half=torch.ones(5, 2, 3))}[kind]()
    shared = kind != "rows"
    cons = (OrientationConstraint.make(tolerance=0.2, weight=0.3),
            PositionConstraint.make((0.5, 0.1, 0.9), tolerance=0.05,
                                    weight=2.0))
    for c in ((), cons):
        assert tr._param_floats(robot, world, shared, len(c)) == (
            tr.pack_params(robot, world, c).numel())


@pytest.mark.parametrize("case", ["robot489", "world200", "both"])
def test_large_block_equals_pack_params(case):
    """The large block's vector, from host copies, is pack_params's bit for
    bit for a 489-body robot, a world of 200 spheres and both, above the
    3 KB block and within the large one."""
    robot = (tmodel.arm_7dof(spheres_per_link=163)
             if case != "world200" else tmodel.arm_7dof())
    world = _spheres(200) if case != "robot489" else AnalyticWorld.make(
        boxes=_BOXES)
    block = tr._host_params(robot.to("meta"), world.to("meta"), True)
    ref = tr.pack_params(robot, world).numpy()
    assert block.dtype == np.float32 and np.array_equal(block, ref)
    assert tr._PARAM_FLOATS < block.size <= tr._LARGE_PARAM_FLOATS
    assert tr.param_route(robot.to("meta"), world.to("meta")) == (
        "large_block")


def test_device_read_cache_never_serves_a_changed_tensor():
    """A set without host copies takes the memory path at its first launch
    (its device vector, no read) and is read once at its second, per set
    of tensors and versions (PARAM_READS): a third launch reads nothing and
    gets the same vector; a tensor changed in place, or a new tensor, is a
    new set (memory path, then one read of pack_params's new vector); the
    large block's set the same; a set above the large block (the memory
    path) and tensors moved under inference_mode are packed on the device
    again at every launch, never cached (a launch on another stream would
    read a cached device vector without an ordering)."""
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    tr.reset_launches()

    def launched_twice(w, route):
        """The set's first launch (memory path, no read), then its
        second (its route, one read); returns the second's vector."""
        reads = tr.PARAM_READS["device"]
        kind, dev_vec = tr._launch_params(robot, w, True)
        assert kind == "memory" and isinstance(dev_vec, torch.Tensor)
        assert torch.equal(dev_vec, tr.pack_params(robot, w))
        assert tr.PARAM_READS["device"] == reads
        kind, vec = tr._launch_params(robot, w, True)
        assert kind == route and tr.PARAM_READS["device"] == reads + 1
        assert np.array_equal(vec, tr.pack_params(robot, w).numpy())
        return vec

    first = launched_twice(world, "block")
    again = tr._launch_params(robot, world, True)[1]
    assert again is first and tr.PARAM_READS["device"] == 1
    world.box_half.mul_(1.5)                        # in place: version moves
    changed = launched_twice(world, "block")
    assert tr.PARAM_READS["device"] == 2
    assert not np.array_equal(changed, first)
    other = dataclasses.replace(world, box_center=world.box_center + 0.1)
    assert not np.array_equal(launched_twice(other, "block"), changed)
    assert tr.PARAM_READS["device"] == 3
    # the large block's set
    big = _spheres(200)
    launched_twice(big, "large_block")
    big.sphere_radius.add_(0.01)
    launched_twice(big, "large_block")
    assert tr.PARAM_READS["device"] == 5
    # above the large block: the device vector, packed at every launch
    huge = _spheres(2000)
    route, dev_vec = tr._launch_params(robot, huge, True)
    assert route == "memory" and isinstance(dev_vec, torch.Tensor)
    again = tr._launch_params(robot, huge, True)[1]
    assert again is not dev_vec and torch.equal(again, dev_vec)
    huge.box_half.add_(0.1)
    moved = tr._launch_params(robot, huge, True)[1]
    assert moved is not dev_vec
    assert torch.equal(moved, tr.pack_params(robot, huge))
    assert tr.PARAM_READS["device"] == 5
    # inference tensors: no cache, the memory path
    with torch.inference_mode():
        inf = AnalyticWorld.make(boxes=_BOXES)
        route, v1 = tr._launch_params(robot, inf, True)
        inf.box_half.mul_(2.0)
        v2 = tr._launch_params(robot, inf, True)[1]
        v3 = tr._launch_params(robot, inf, True)[1]
    assert route == "memory" and v1 is not v2 and v3 is not v2
    assert torch.equal(v2, tr.pack_params(robot, inf))
    assert tr.PARAM_READS["device"] == 5


@pytest.mark.parametrize("how", ["new_set", "in_place"])
def test_a_set_used_once_is_never_read(how):
    """A loop that builds its world anew, or changes it in place, before
    every launch gives a new set of tensors or versions each time: every
    launch takes the memory path with that call's values and none reads
    the device (no host sync); the cache stays bounded."""
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    tr.reset_launches()
    for i in range(80):
        if how == "new_set":
            world = dataclasses.replace(world,
                                        box_half=world.box_half + 0.001)
        else:
            world.box_half.add_(0.001)
        route, vec = tr._launch_params(robot, world, True)
        assert route == "memory"
        assert torch.equal(vec, tr.pack_params(robot, world))
    assert tr.PARAM_READS["device"] == 0
    assert len(tr._LAUNCH_PARAMS) <= 64


def test_a_full_cache_keeps_the_set_it_takes_in():
    """The cache is emptied before it takes in a 65th set, never after: a
    set first launched into a full cache is known at its second launch,
    which reads it (the block), whatever the cache held before."""
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    tr.reset_launches()
    for i in range(200):
        world = dataclasses.replace(world, box_half=world.box_half + 0.001)
        assert tr._launch_params(robot, world, True)[0] == "memory"
        route, vec = tr._launch_params(robot, world, True)
        assert route == "block" and tr.PARAM_READS["device"] == i + 1
        assert np.array_equal(vec, tr.pack_params(robot, world).numpy())


def test_reset_launches_clears_every_count():
    """reset_launches sets every launch count to 0: launches, parameter
    routes, device reads, layouts and body orders (the TPU's K1 / K2
    launches are the "unsorted" ones)."""
    counts = (tr.LAUNCHES, tr.PARAM_ROUTES, tr.PARAM_READS, tr.LAYOUTS,
              tr.BODY_ORDER)
    assert set(tr.BODY_ORDER) == {"sorted", "unsorted"}
    for c in counts:
        for k in c:
            c[k] = 3
    tr.reset_launches()
    assert all(v == 0 for c in counts for v in c.values())


def test_plan_with_the_routes_shared_memory():
    """Both blocks stage nothing in shared memory, so they plan as the main
    path (7 candidates at T = 102, 9 at T = 52, 8 with ee). The memory path
    stages its parameters beside the tile, on top of the tile's budget: it
    plans as the blocks do even for a set above the large block (whose
    parameters alone pass the 32 KB budget), within the card's 227 KB of
    shared memory a block."""
    C4, C5 = 57344, 210000
    assert tr._plan(C4, 102, 7, staged=0) == (7, 1)
    assert tr._plan(C5, 52, 7, staged=0) == (9, 1)
    robot = tmodel.arm_7dof(spheres_per_link=70)
    n = tr._param_floats(robot, AnalyticWorld.make(boxes=_BOXES), True)
    for k in (n, 4000, tr._LARGE_PARAM_FLOATS + 1, 20000):
        for C, T, ee in ((C4, 102, False), (C5, 52, False), (C4, 102, True),
                         (1024, 1000, False)):
            plan = tr._plan(C, T, 7, ee=ee, staged=k)
            assert plan == tr._plan(C, T, 7, ee=ee), (k, C, T, ee)
            staged = (k + 31) & ~31
            tile = tr._smem_floats(k, 7, *plan[:1], T, plan[1], ee) - staged
            assert tile <= (tr._SMEM_BUDGET_EE if ee else tr._SMEM_BUDGET)
            assert 4 * (staged + tile) <= 232448


def _stage(flat, cand_major, C, T, d, cpb, n_slab, s, c0, active):
    """The kernel's stage of block (c0 / cpb, s), thread by thread, from
    `flat` in either layout: the tile [d * cpb * n_seq] (NaN where nothing
    was stored)."""
    _, _, a, n_seq = tr._slab(T, n_slab, s)
    n_c = min(cpb, C - c0)
    sj, st, sc = (1, d, T * d) if cand_major else (T * C, C, 1)
    tile = np.full(d * cpb * n_seq, np.nan, np.float32)
    tid = np.arange(_BLOCK)
    cc, r0, r_step = tid % cpb, tid // cpb, _BLOCK // cpb
    mine = (r0 < r_step) & (cc < n_c)
    mine &= active[np.minimum(c0 + cc, C - 1)]
    cc, r0 = cc[mine], r0[mine]
    for j in range(d):
        r = r0.copy()
        while (r < n_seq).any():
            live = r < n_seq
            tile[((j * cpb + cc) * n_seq + r)[live]] = flat[
                (a * st + (c0 + cc) * sc + j * sj + r * st)[live]]
            r = r + r_step
    return tile


@pytest.mark.parametrize("T", [2, 3, 31, 32, 33, 101, 102, 103])
def test_candidate_major_stage_matches_the_permute(T):
    """For cpb 1..16 (and 2-3 slabs at the longer T), d = 7 and 2, a ragged
    last block and masked candidates: the replayed stage's tile from the
    candidate-major [C, T, d] and from the time-major [d, T, C] is the tile
    of permute(2, 1, 0), element for element."""
    rng = np.random.default_rng(T)
    for d in (7, 2):
        for cpb in range(1, tr._MAX_CANDS + 1):
            C = 2 * cpb + max(cpb // 2, 1)         # a ragged last block
            cand = rng.standard_normal((C, T, d)).astype(np.float32)
            tm = np.ascontiguousarray(cand.transpose(2, 1, 0))  # [d, T, C]
            active = rng.random(C) > 0.3
            for n_slab in sorted({1, min(2, T), min(3, T)}):
                L = -(-T // n_slab)
                if -(-T // L) != n_slab:
                    continue
                for s in range(n_slab):
                    _, _, a, n_seq = tr._slab(T, n_slab, s)
                    for c0 in range(0, C, cpb):
                        n_c = min(cpb, C - c0)
                        for major, flat in ((True, cand), (False, tm)):
                            got = _stage(flat.reshape(-1), major, C, T, d,
                                         cpb, n_slab, s, c0, active).reshape(
                                d, cpb, n_seq)
                            for col in range(cpb):
                                if col < n_c and active[c0 + col]:
                                    want = tm[:, a:a + n_seq, c0 + col]
                                    assert np.array_equal(got[:, col], want), (
                                        major, d, cpb, n_slab, s, c0, col)
                                else:
                                    assert np.isnan(got[:, col]).all()


# aten ops that launch no kernel: allocations and views
NO_KERNEL_OPS = frozenset({"empty", "empty_strided", "t", "select", "view",
                           "alias", "as_strided", "detach"})


def device_ops(fn, device_type):
    """(fn(), names of the aten ops it ran on tensors of `device_type`)."""

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = [*args, *(kwargs or {}).values(),
                    *(out if isinstance(out, (tuple, list)) else (out,))]
            if any(isinstance(t, torch.Tensor)
                   and t.device.type == device_type for t in flat):
                names.append(func.overloadpacket.__name__)
            return out

    names = []
    with Record():
        out = fn()
    return out, names


@pytest.mark.parametrize("kind", ["analytic", "grid"])
def test_candidate_major_launch_hands_over_the_callers_storage(
        kind, monkeypatch):
    """The wrapper of a candidate-major launch (the TPU's K4) hands the
    kernel the caller's [C, T, d] storage with cand_major = 1, and a
    time-major launch its [d, T, C] with 0: no permute or copy runs before
    the kernel, and the only ops on the candidates' device are allocations
    and views (a library that records its arguments stands in for the
    kernel's; the robot and world on the "meta" device keep host copies,
    so their block is filled on the host, as on the card)."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(**{e[1]: entry
                                   for e in tr._ENTRIES.values()})
    monkeypatch.setattr(tr, "build", lambda sources, chains: {
        (s, c): lib for s in sources for c in chains})
    monkeypatch.setattr(tr, "_sm_count", lambda index: tr._SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    robot = tmodel.arm_7dof().to("meta")
    world = (AnalyticWorld.make(boxes=_BOXES) if kind == "analytic"
             else _grid()).to("meta")
    grid, prims = tr._world_parts(world)
    rng = np.random.default_rng(5)
    cand = torch.as_tensor(rng.uniform(-1, 1, (37, 33, 7)).astype(np.float32))
    tm = cand.permute(2, 1, 0).contiguous()
    tr.reset_launches()
    for x, time_major in ((cand, False), (tm, True)):
        tr._launch(robot, world, grid, prims, None, x, 0.1, 0.05, None,
                   time_major, False, None)        # warm the host cache
        (q, m), ops = device_ops(lambda: tr._launch(
            robot, world, grid, prims, None, x, 0.1, 0.05, None,
            time_major, False, None), "cpu")
        assert calls[-1][0] == x.data_ptr()
        assert calls[-1][-3] == int(not time_major)
        assert q.shape == (37, 33) and m.shape == (37,)
        assert set(ops) <= NO_KERNEL_OPS, ops
    assert tr.LAYOUTS == {"time_major": 2, "candidate_major": 2}

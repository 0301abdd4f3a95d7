"""The evaluator kernels' parameter block (kernels/rollout.py
``_host_params``): the robot's parameters and a shared world's primitives,
built on the host from the host copies to_device keeps of small tensors
(_tensors.host_mirror), passed to the kernel as a __grid_constant__
parameter of csrc/rollout_common.cuh kParamFloats floats.

It must hold pack_params's layout (the memory path's, which the kernels'
other route reads from device memory), refuse what exceeds the block, and
never serve a stale world: a new world object, or a tensor changed in place
since it was moved, gives another block or none. The "meta" device stands
in for the card here: moving to it keeps host copies as a move to CUDA
does, and the launch never reads a device tensor's values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_compare import lane_fks
from tpustomp_torch._tensors import host_mirror
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.edt import grid_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]


def _world(kind):
    boxes = AnalyticWorld.make(boxes=_BOXES,
                               spheres=[((0.3, 0.3, 0.9), 0.1)])
    if kind == "analytic":
        return boxes
    if kind == "empty":
        return AnalyticWorld.make()
    grid = grid_from_analytic(AnalyticWorld.make(boxes=_BOXES),
                              (-0.2, -0.8, -0.1), (12, 14, 10), 0.1)
    if kind == "grid":
        return grid
    return CompositeWorld.make(grid, spheres=[((0.35, 0.3, 0.55), 0.12)])


def _unsorted(robot):
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        robot.num_bodies))
    return dataclasses.replace(
        robot, body_link=robot.body_link[perm],
        body_offset=robot.body_offset[perm],
        body_radius=robot.body_radius[perm], body_counts=None)


@pytest.mark.parametrize("kind", ["analytic", "empty", "grid", "composite"])
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r", "unsorted"])
def test_host_params_equal_pack_params(robot_name, kind):
    """The block built from host copies is pack_params's vector bit for
    bit (unsorted bodies stable-sorted by link as on the device)."""
    robot = (tmodel.planar_2r() if robot_name == "planar_2r"
             else tmodel.arm_7dof())
    if robot_name == "unsorted":
        robot = _unsorted(robot)
    world = _world(kind)
    block = tr._host_params(robot.to("meta"), world.to("meta"), True)
    ref = tr.pack_params(robot, world).numpy()
    assert block.dtype == np.float32 and np.array_equal(block, ref)
    assert block.size <= tr._PARAM_FLOATS


def test_host_params_of_a_row_world_hold_the_robot_only():
    """A world with a row axis puts only its grid's origin and resolution
    in the block (its rows go to the kernel as arrays)."""
    robot = tmodel.arm_7dof()
    rows = AnalyticWorld(sphere_center=torch.zeros(5, 1, 3),
                         sphere_radius=torch.ones(5, 1),
                         box_center=torch.zeros(5, 2, 3),
                         box_half=torch.ones(5, 2, 3))
    for world in (rows, CompositeWorld(_world("grid"), rows)):
        block = tr._host_params(robot.to("meta"), world.to("meta"), False)
        assert np.array_equal(block, tr.pack_params(robot, world).numpy())


def test_host_params_size_limit():
    """A world whose vector would pass kParamFloats takes the large block
    (the same vector, route "large_block"), and so does a robot with that
    many bodies; a world just within the block takes the block; a set
    above kLargeParamFloats has no block (None: the memory path)."""
    robot = tmodel.arm_7dof()
    base = tr.pack_params(robot, AnalyticWorld.make()).numel()
    fit = (tr._PARAM_FLOATS - base) // 4
    large = (tr._LARGE_PARAM_FLOATS - base) // 4
    rng = np.random.default_rng(1)

    def spheres(n):
        return AnalyticWorld.make(spheres=[(tuple(rng.uniform(-1, 1, 3)),
                                            0.1) for _ in range(n)])

    meta = robot.to("meta")
    for n, route in ((fit, "block"), (fit + 1, "large_block"),
                     (large, "large_block")):
        world = spheres(n).to("meta")
        assert tr._host_params(meta, world, True).size == base + 4 * n
        assert tr.param_route(meta, world) == route
    world = spheres(large + 1).to("meta")
    assert tr._host_params(meta, world, True) is None
    assert tr.param_route(meta, world) == "memory"
    empty = AnalyticWorld.make().to("meta")
    for per_link, route in ((tr._PARAM_FLOATS // 12, "large_block"),
                            (tr._LARGE_PARAM_FLOATS // 12, "memory")):
        big = tmodel.arm_7dof(spheres_per_link=per_link).to("meta")
        assert tr.param_route(big, empty) == route
        assert (tr._host_params(big, empty, True) is None) == (
            route == "memory")


def test_host_params_cache_never_serves_a_stale_world():
    """The block is built once per set of tensors (_launch_params's cache);
    a new world object gives its own block, a tensor changed in place since
    it was moved gives none (the launch reads the device instead), and a
    tensor made on the device has no host copy."""
    robot = tmodel.arm_7dof().to("meta")
    world = _world("analytic").to("meta")
    first = tr._launch_params(robot, world, True)[1]
    assert tr._launch_params(robot, world, True)[1] is first
    assert np.array_equal(tr._host_params(robot, world, True), first)
    moved = AnalyticWorld.make(boxes=[((0.1, 0.2, 0.3), (0.2, 0.2, 0.2))])
    other = tr._host_params(robot, moved.to("meta"), True)
    assert np.array_equal(other, tr.pack_params(tmodel.arm_7dof(),
                                                moved).numpy())
    assert not np.array_equal(other[:first.size], first)
    world.box_half.add_(1.0)                  # in place: version moves
    assert host_mirror(world.box_half) is None
    assert tr._host_params(robot, world, True) is None
    made = dataclasses.replace(world, box_half=torch.ones(2, 3,
                                                          device="meta"))
    assert tr._host_params(robot, made, True) is None
    # an updated grid world keeps its origin's copy
    grid = _world("grid").to("meta")
    patched = dataclasses.replace(grid, grid=grid.grid + 0)
    assert np.array_equal(tr._host_params(robot, patched, True),
                          tr._host_params(robot, grid, True))


def test_lane_plan_lanes_per_waypoint_at_the_main_shapes():
    """The plan fills its warps' rounds: at config 4 (T = 102) 7 candidates
    a block are 24 windows, 3 rounds of 8 warps, 1.076 lane slots per owned
    waypoint; at config 5 (T = 52) 9 candidates, 16 windows, 1.094; against
    the segment plan's 1.255 and 1.231. With ee, 8 (whole sectors). A
    masked third costs a third fewer lanes."""
    C4, C5 = 57344, 210000
    assert tr._plan(C4, 102, 7) == (7, 1) and tr._plan(C5, 52, 7) == (9, 1)
    assert tr._plan(C4, 102, 7, ee=True) == (8, 1)
    for C, T, cpb, windows in ((C4, 102, 7, 24), (C5, 52, 9, 16)):
        assert tr._slots(cpb, T, 1) == windows * 32
        assert lane_fks(tr, C, T) / (C * T) == pytest.approx(
            windows * 32 / (cpb * T), rel=1e-3)
    active = np.arange(C4) % 3 != 0
    assert lane_fks(tr, C4, 102, active=active) < 0.7 * lane_fks(tr, C4, 102)


def test_to_inside_inference_mode_takes_the_memory_path():
    """Tensors moved under torch.inference_mode() keep no version counter:
    .to() works as outside it and keeps no host copy, and no read of the
    device may be cached for them, so the launch takes the memory path (no
    parameter block), inside the mode and outside it."""
    with torch.inference_mode():
        robot = tmodel.arm_7dof().to("meta")
        world = _world("composite").to("meta")
        assert robot.joint_axis.is_inference()
        assert host_mirror(robot.joint_axis) is None
        assert tr._host_params(robot, world, True) is None
        assert tr.param_route(robot, world) == "memory"
    assert host_mirror(world.grid.origin) is None
    assert tr._host_params(robot, world, True) is None
    assert tr.param_route(robot, world) == "memory"
    # one inference tensor is enough
    plain = tmodel.arm_7dof().to("meta")
    assert tr.param_route(plain, _world("composite").to("meta")) == "block"
    assert tr.param_route(plain, world) == "memory"


def test_lane_plan_fill_follows_the_sm_count():
    """A batch that would leave fewer than _FILL_PER_SM blocks on each of
    the card's SMs takes fewer candidates a block: 2,000 candidates at
    T = 52 take 3 a block on 132 SMs and 9 (the full plan) on 16."""
    assert tr._plan(2000, 52, 7, sms=132) == (3, 1)
    assert tr._plan(2000, 52, 7, sms=16) == (9, 1)
    assert tr._plan(7168, 102, 7, sms=132) == (7, 1)
    assert tr._plan(7168, 102, 7, sms=512)[0] < 7

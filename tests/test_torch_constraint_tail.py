"""The evaluators' constraint route (kernels/rollout.py ``constraints=``,
the ``:con`` form of every variant): the Cartesian constraints' cost
computed by the kernel on the end-effector frame it holds in registers,
q_con [C, T], instead of the frame ``ee [12, T, C]`` and the solver's
elementwise tail on it (costs/constraints.py ``constraint_cost_tm``).

On the CPU the route is its plain version,
``constraint_cost_tm(robot, cons, ee_frames(robot, fulls))``: held here
bit for bit, and against the JAX package's ``constraint_cost_tm`` on the
frame of its Pallas kernel in interpret mode (rtol 1e-5, atol 1e-6: the
frames differ by float32 FK rounding, the JAX package's ee gate). The
kernel's parameter section for the constraints (pack_params / the host
parameter block) is decoded here in numpy, in the kernel's operation
order, and must reproduce the plain tail (rtol 1e-5, atol 1e-6: numpy's
arccos against torch's). The solver's plans with constraints are the
frame route's bit for bit. The kernels themselves run on the card only
(tests/test_torch_cuda.py, marker ``cuda``).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_solver import (_ReplayJaxNoise, _configs, _fields,
                                     _jitter, _scene)
from tpustomp.costs import constraints as jcon
from tpustomp.kernels import rollout_pallas as jrp
from tpustomp.robot import model as jmodel
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp_torch import ProblemSpec, convert, plan_batch
from tpustomp_torch._tensors import host_mirror
from tpustomp_torch.costs import constraints as tcon
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.edt import grid_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]
# per robot: a cone and a tool-point target its random poses often leave
# (planar_2r moves in z = 0: its cone is on the first link axis)
_CONS = {
    "arm_7dof": (dict(axis_local=(0, 0, 1), target_world=(0, 0, 1),
                      tolerance=0.25, weight=0.3),
                 dict(target_world=(0.7, 0.1, 0.9), tolerance=0.05,
                      weight=2.0)),
    "planar_2r": (dict(axis_local=(1, 0, 0), target_world=(0.6, 0.8, 0.0),
                       tolerance=0.3, weight=0.7),
                  dict(target_world=(1.0, 1.0, 0.0), tolerance=0.05,
                       weight=1.5)),
}
_KINDS = ["orientation", "position", "both"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _robot(name):
    return tmodel.arm_7dof() if name == "arm_7dof" else tmodel.planar_2r()


def _jax_robot(name):
    return jmodel.arm_7dof() if name == "arm_7dof" else jmodel.planar_2r()


def _constraints(robot_name, kind):
    """(the JAX constraints, the port's) as tuples."""
    cone, spot = _CONS[robot_name]
    jc = []
    if kind in ("orientation", "both"):
        jc.append(jcon.OrientationConstraint.make(**cone))
    if kind in ("position", "both"):
        jc.append(jcon.PositionConstraint.make(**spot))
    return tuple(jc), tuple(convert.constraint_from_numpy(_fields(c))
                            for c in jc)


def _trajs(robot, C, T, seed):
    lo = robot.joint_lower.numpy()
    hi = robot.joint_upper.numpy()
    return np.random.default_rng(seed).uniform(
        lo, hi, (C, T, robot.num_joints)).astype(np.float32)


def _world(kind):
    boxes = AnalyticWorld.make(boxes=_BOXES)
    if kind == "analytic":
        return boxes
    grid = grid_from_analytic(boxes, (-0.2, -0.8, -0.1), (12, 14, 10), 0.1)
    return CompositeWorld.make(grid, spheres=[((0.35, 0.3, 0.55), 0.12)])


def _row_world(C, seed=3):
    rng = np.random.default_rng(seed)
    return AnalyticWorld(
        sphere_center=torch.from_numpy(
            rng.uniform(0.2, 0.8, (C, 1, 3)).astype(np.float32)),
        sphere_radius=torch.full((C, 1), 0.15),
        box_center=torch.tensor([[[0.6, 0.0, 0.2]]]).expand(C, 1, 3).clone(),
        box_half=torch.tensor([[[0.45, 0.6, 0.25]]]).expand(C, 1, 3).clone())


def _meta(cons):
    return tuple(c.to("meta") for c in cons)


def _decode_tail(section, ee):
    """The kernel's constraint route (csrc/rollout_common.cuh
    constraint_cost) in numpy float32, reading the parameters' constraint
    section (9 floats a constraint: type, a[3], b[3], tolerance, weight)
    and the frame ee [12, T, C]: -> q_con [C, T]."""
    f32 = np.float32
    p, R = ee[:3].astype(f32), ee[3:].astype(f32)

    def dot(x, y):
        return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]

    total = np.zeros(ee.shape[1:], f32)
    for c in section.reshape(-1, 9).astype(f32):
        a, b, tol, w = c[1:4], c[4:7], c[7], c[8]
        if c[0] == 0:
            ach = [dot(R[3 * i:3 * i + 3], a) for i in range(3)]
            cos = np.clip(dot(ach, b), f32(-1), f32(1))
            excess = np.maximum(np.arccos(cos) - tol, f32(0))
        else:
            rel = [((p[i] + R[3 * i] * a[0]) + R[3 * i + 1] * a[1])
                   + R[3 * i + 2] * a[2] - b[i] for i in range(3)]
            excess = np.maximum(np.sqrt(dot(rel, rel)) - tol, f32(0))
        total = total + w * (excess * excess)
    return total.T


@pytest.mark.parametrize("world_kind", ["analytic", "composite", "rows"])
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_host_params_with_constraints_equal_pack_params(robot_name, kind,
                                                        world_kind):
    """The parameter block built from host copies holds pack_params's
    vector with the constraint section, bit for bit; the section is the
    vector's last 9 floats a constraint, after the robot and the world."""
    robot = _robot(robot_name)
    cons = _constraints(robot_name, kind)[1]
    shared = world_kind != "rows"
    world = _world(world_kind) if shared else _row_world(16)
    block = tr._host_params(robot.to("meta"), world.to("meta"), shared,
                            _meta(cons))
    ref = tr.pack_params(robot, world, cons).numpy()
    assert block is not None and np.array_equal(block, ref)
    bare = tr.pack_params(robot, world).numpy()
    assert np.array_equal(ref[:bare.size], bare)
    assert ref.size == bare.size + tr._CON_FLOATS * len(cons)
    for i, c in enumerate(cons):
        row = ref[bare.size + 9 * i:bare.size + 9 * (i + 1)]
        orient = isinstance(c, tcon.OrientationConstraint)
        a = c.axis_local if orient else robot.ee_offset
        assert row[0] == (0.0 if orient else 1.0)
        assert np.array_equal(row[1:4], a.numpy())
        assert np.array_equal(row[4:7], c.target_world.numpy())
        assert row[7] == float(c.tolerance) and row[8] == float(c.weight)


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_constraint_section_decodes_to_the_plain_tail(robot_name, kind):
    """A numpy decoder of the constraint section, in the kernel's order of
    operations on the plain frame, reproduces constraint_cost_tm."""
    robot = _robot(robot_name)
    cons = _constraints(robot_name, kind)[1]
    fulls = torch.from_numpy(_trajs(robot, 48, 10, 1))
    world = _world("analytic")
    params = tr.pack_params(robot, world, cons).numpy()
    section = params[params.size - tr._CON_FLOATS * len(cons):]
    ee = tr.ee_frames(robot, fulls)
    ref = tcon.constraint_cost_tm(robot, cons, ee).numpy()
    got = _decode_tail(section, ee.numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert ref.max() > 0.0                      # the cost is exercised


def test_constraint_section_size_matches_the_kernel():
    """kConFloats of csrc/rollout_common.cuh is the wrapper's _CON_FLOATS."""
    src = (tr._CSRC / "rollout_common.cuh").read_text()
    assert int(re.search(r"constexpr int kConFloats = (\d+);", src)[1]) \
        == tr._CON_FLOATS == 9


def test_host_params_cache_never_serves_a_stale_constraint():
    """The launch's block is built once per set of tensors (_launch_params's
    cache); a constraint changed in place since it was moved has no host
    copy (the launch reads the device instead); a new constraint object
    gives its own block; one made on the device gives none; the robot's
    ee_offset is read only for a position constraint."""
    robot = tmodel.arm_7dof().to("meta")
    world = _world("analytic").to("meta")
    cone = tcon.OrientationConstraint.make(tolerance=0.25).to("meta")
    first = tr._launch_params(robot, world, True, (cone,))[1]
    assert tr._launch_params(robot, world, True, (cone,))[1] is first
    assert np.array_equal(tr._host_params(robot, world, True, (cone,)),
                          first)
    bare = tr._host_params(robot, world, True)
    assert first.size == bare.size + 9
    wider = tcon.OrientationConstraint.make(tolerance=0.4).to("meta")
    other = tr._host_params(robot, world, True, (wider,))
    assert other[-2] == np.float32(0.4) and first[-2] == np.float32(0.25)
    cone.weight.mul_(2.0)                       # in place: version moves
    assert host_mirror(cone.weight) is None
    assert tr._host_params(robot, world, True, (cone,)) is None
    made = dataclasses.replace(wider, weight=torch.ones((), device="meta"))
    assert tr._host_params(robot, world, True, (made,)) is None
    # a robot whose ee_offset was made on the device: only a position
    # constraint needs it
    robot2 = dataclasses.replace(robot, ee_offset=torch.zeros(
        3, device="meta"))
    spot = tcon.PositionConstraint.make((0.7, 0.1, 0.9)).to("meta")
    assert tr._host_params(robot2, world, True, (wider,)) is not None
    assert tr._host_params(robot2, world, True, (spot,)) is None
    assert tr._host_params(robot, world, True, (spot,)) is not None


@pytest.mark.parametrize("world_kind", ["analytic", "composite", "rows"])
def test_constraint_route_on_the_cpu_is_the_frame_tail_bitwise(world_kind):
    """On CPU tensors the route returns (q_obs, margin) of the launch
    without constraints and constraint_cost_tm on ee_frames, bit for bit,
    in either layout; the plain twin is the same; the routes exclude each
    other; no constraint (an empty tuple) gives zeros."""
    robot = tmodel.arm_7dof()
    cons = _constraints("arm_7dof", "both")[1]
    C, T = 64, 12
    shared = world_kind != "rows"
    world = _world(world_kind) if shared else _row_world(C // 4)
    per = None if shared else 4
    x = torch.from_numpy(_trajs(robot, C, T, 2))
    q, m, q_con = tr.obstacle_cost_batch(robot, world, x, 0.05, 0.05,
                                         cands_per_row=per, constraints=cons)
    q0, m0 = tr.obstacle_cost_batch(robot, world, x, 0.05, 0.05,
                                    cands_per_row=per)
    assert torch.equal(q, q0) and torch.equal(m, m0)
    ref = tcon.constraint_cost_tm(robot, cons, tr.ee_frames(robot, x))
    assert q_con.shape == (C, T) and torch.equal(q_con, ref)
    tm = x.permute(2, 1, 0).contiguous()
    got = tr.obstacle_cost_batch(robot, world, tm, 0.05, 0.05,
                                 time_major=True, cands_per_row=per,
                                 constraints=cons)
    assert all(torch.equal(a, b) for a, b in zip(got, (q, m, q_con)))
    plain = tr.obstacle_cost_batch_plain(robot, world, x, 0.05, 0.05,
                                         cands_per_row=per,
                                         constraints=cons[0])
    assert torch.equal(plain[2], tcon.constraint_cost_tm(
        robot, cons[0], tr.ee_frames(robot, x)))
    none = tr.obstacle_cost_batch(robot, world, x, 0.05, 0.05,
                                  cands_per_row=per, constraints=())
    assert torch.equal(none[2], torch.zeros(C, T))
    with pytest.raises(ValueError, match="exclusive"):
        tr.obstacle_cost_batch(robot, world, x, 0.05, 0.05,
                               cands_per_row=per, want_ee=True,
                               constraints=cons)
    with pytest.raises(ValueError, match="constraint tensors"):
        tr.obstacle_cost_batch(robot, world, x, 0.05, 0.05,
                               cands_per_row=per, constraints=_meta(cons))


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_plain_route_matches_jax_tail_on_the_pallas_frame(robot_name, kind):
    """The plain route's q_con against the JAX package's constraint_cost_tm
    on the ee_out frame of its Pallas kernel in interpret mode; q_obs and
    margin against the kernel's (1e-5, float32 FK)."""
    jr, robot = _jax_robot(robot_name), _robot(robot_name)
    jc, tc = _constraints(robot_name, kind)
    jw = JWorld.make(spheres=[((0.5, 0.2, 0.5), 0.15)])
    world = convert.world_from_numpy(_fields(jw))
    C, T = 128, 12
    cand = _trajs(robot, C, T, 5)
    q_r, m_r, ee_r = jrp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), 0.05, 0.08, interpret=True, want_ee=True)
    ref = np.asarray(jcon.constraint_cost_tm(jr, jc, ee_r))
    q, m, q_con = tr.obstacle_cost_batch(robot, world, torch.from_numpy(cand),
                                         0.05, 0.08, constraints=tc)
    np.testing.assert_allclose(q_con.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=1e-5)
    assert ref.max() > 0.0


def _frame_route(monkeypatch):
    """Make the solver's evaluator the frame route: the :ee form and
    constraint_cost_tm on its frame, as the solver computed it before the
    constraint route."""
    real = tsolver.obstacle_cost_batch

    def frame_route(robot, world, fulls, dt, clearance, constraints=None,
                    **kw):
        if constraints is None:
            return real(robot, world, fulls, dt, clearance, **kw)
        q, m, ee = real(robot, world, fulls, dt, clearance, want_ee=True,
                        **kw)
        return q, m, tcon.constraint_cost_tm(robot, constraints, ee)

    monkeypatch.setattr(tsolver, "obstacle_cost_batch", frame_route)


def test_constrained_plan_batch_is_the_frame_route_bitwise(monkeypatch):
    """plan_batch with both constraint types on the CPU: the constraint
    route's plans are the frame route's, bit for bit."""
    _, ct = _configs(max_iterations=5)
    _, _, robot, world = _scene()
    tc = _constraints("arm_7dof", "both")[1]
    q0, qN = _jitter(3, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)

    def run():
        return plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                          device="cpu", constraints=tc,
                          noise_fn=_ReplayJaxNoise(keys, 7, ct.num_rollouts,
                                                   ct.num_timesteps))

    got = run()
    _frame_route(monkeypatch)
    ref = run()
    for f in ("trajectory", "cost", "success", "iterations"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.metrics.constraint_cost,
                       ref.metrics.constraint_cost)
    assert float(got.metrics.constraint_cost.max()) > 0.0


def test_constrained_solve_batch_per_row_worlds_is_the_frame_route_bitwise(
        monkeypatch):
    """solve_batch over per-scenario worlds (world_batched) with the cone:
    the constraint route's solution is the frame route's, bit for bit."""
    from tpustomp_torch.dynamics.device import device_ops

    _, ct = _configs(max_iterations=4)
    robot = tmodel.arm_7dof()
    B = 3
    world = _row_world(B, seed=4)
    ops = device_ops(ct.num_timesteps, ct.dt, ct.smoothness, "cpu")
    q0, qN = (torch.from_numpy(a) for a in _jitter(B, 1))
    tc = _constraints("arm_7dof", "orientation")[1]
    z = np.random.default_rng(6).standard_normal(
        (ct.max_iterations, 7, B, ct.num_rollouts, ct.num_timesteps)
    ).astype(np.float32)

    def run():
        return tsolver.solve_batch(
            robot, world, ct, ops, q0, qN,
            lambda it, active: torch.from_numpy(z[it]), world_batched=True,
            constraints=tc)

    got = run()
    _frame_route(monkeypatch)
    ref = run()
    assert torch.equal(got.trajectory, ref.trajectory)
    assert torch.equal(got.cost, ref.cost)
    assert torch.equal(got.metrics.constraint_cost,
                       ref.metrics.constraint_cost)


def test_lane_plan_of_the_constraint_route():
    """The route plans as without ee: one more staged plane within the
    32 KB budget, 7 candidates a block at config 4's T = 102 and 9 at
    config 5's T = 52 (the ee frame's plan takes 8 and a 72 KB budget)."""
    C4, C5 = 57344, 210000
    assert tr._plan(C4, 102, 7, con=True) == tr._plan(C4, 102, 7) == (7, 1)
    assert tr._plan(C5, 52, 7, con=True) == tr._plan(C5, 52, 7) == (9, 1)
    assert tr._plan(C4, 102, 7, ee=True) == (8, 1)
    for C, T, cpb in ((C4, 102, 7), (C5, 52, 9)):
        plane = cpb * (T | 1)
        assert (tr._smem_floats(0, 7, cpb, T, 1, False, True)
                == tr._smem_floats(0, 7, cpb, T, 1, False) + plane)
        assert (tr._smem_floats(0, 7, cpb, T, 1, False, True)
                <= tr._SMEM_BUDGET)
    # the ee frame stages 14 planes of [cpb][opitch], the route 3
    ee = tr._smem_floats(0, 7, 8, 102, 1, True) - tr._smem_floats(
        0, 7, 8, 102, 1, False)
    con = tr._smem_floats(0, 7, 8, 102, 1, False, True) - tr._smem_floats(
        0, 7, 8, 102, 1, False)
    assert ee == 12 * con

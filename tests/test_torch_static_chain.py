"""The evaluators' joint chain on the CPU: the static chain the wrapper
derives for a robot (kernels/rollout.py ``chain_of``: the TPU kernel's
``static_joints`` plus the body partition) and the library it names, and
the stale-spec guard (robot/model.py ``check_joint_static``) against the
JAX package's ``_check_joint_static`` and at the port's entry points (the
cases of tests/integration/test_api_guards.py, on device="cpu").

No nvcc here: the chain's kernels are held to the runtime chain and the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import general_axis_robot, rpr_robot
from tests.test_torch_solver import _fields
from tpustomp.kernels.rollout_pallas import _check_joint_static as j_check
from tpustomp.robot import model as jmodel
from tpustomp_torch import NoiseConfig, PlannerConfig, ProblemSpec, convert
from tpustomp_torch import plan, plan_batch
from tpustomp_torch.api.config import CostWeights
from tpustomp_torch.engine import mpc as tmpc
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.sdf import AnalyticWorld

_OTHER = 2


_ROBOTS = {
    "arm_7dof": (lambda m: m.arm_7dof(),
                 (1,) + (0, 0, 0, 1, 0) + (0, 0, 1, 0, 0) + (0, 1, 0, 0, 4)
                 + (0, 0, 1, 0, 0) + (0, 1, 0, 0, 4) + (0, 0, 1, 0, 0)
                 + (0, 1, 0, 0, 4)),
    "planar_2r": (lambda m: m.planar_2r(bodies_per_link=3),
                  (1, 0, 0, 0, 1, 3, 0, 0, 0, 1, 3)),
    "rpr_prismatic": (rpr_robot, (0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 1,
                                  0, 2)),
    "general_axis": (general_axis_robot,
                     (0, 0, _OTHER, 0, _OTHER, 1, 0, 0, -1, 0, 2,
                      1, 0, _OTHER, _OTHER, 1, 0, -1, 0, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(_ROBOTS))
def test_chain_descriptor_and_definition(name):
    make, expected = _ROBOTS[name]
    robot = make(tmodel)
    chain = tr.chain_of(robot)
    assert chain == expected
    assert tr._nvcc_flags(chain)[-1] == "-DROLLOUT_CHAIN=chain" + "".join(
        "_" + str(c).replace("-", "n") for c in expected)
    assert tr._nvcc_flags(chain)[:-1] == tr._NVCC_FLAGS
    # the same robot from the JAX package's spec: the same chain
    assert tr.chain_of(convert.robot_from_numpy(
        _fields(make(jmodel)))) == expected


@pytest.mark.parametrize("field", ["joint_static", "body_counts"])
def test_runtime_chain_without_static_fields(field):
    """No joint_static, or no body partition (the TPU's rolled kernels
    K1/K2): the runtime chain, the library built without the definition."""
    robot = dataclasses.replace(tmodel.arm_7dof(), **{field: None})
    assert tr.chain_of(robot) is None
    assert tr._nvcc_flags(None) == tr._NVCC_FLAGS
    for src in tr._SOURCES:
        assert tr._lib_path(src, None) == tr._lib_path(src)


def test_library_per_source_and_chain():
    """Equal robots name one library; different chains, and the runtime
    chain, name different ones."""
    chains = {n: tr.chain_of(make(tmodel)) for n, (make, _) in
              _ROBOTS.items()}
    assert tr.chain_of(tmodel.arm_7dof()) == chains["arm_7dof"]
    paths = {(src, c): tr._lib_path(src, c) for src in tr._SOURCES
             for c in list(chains.values()) + [None]}
    assert len(set(paths.values())) == len(paths) == 2 * (len(chains) + 1)
    moved = dataclasses.replace(
        tmodel.arm_7dof(), joint_offset=torch.zeros(7, 3))
    assert tr._lib_path("rollout_grid", tr.chain_of(moved)) == paths[
        ("rollout_grid", chains["arm_7dof"])]     # offsets stay run-time


def test_launch_names():
    """Static-chain launches count under <variant>, runtime-chain ones
    under <variant>:runtime, each with its :ee and its :con form."""
    for v in tr._ENTRIES:
        for key in (v, v + ":ee", v + ":con", v + ":runtime",
                    v + ":runtime:ee", v + ":runtime:con"):
            assert tr.LAUNCHES[key] >= 0
    assert len(tr.LAUNCHES) == 6 * len(tr._ENTRIES)


def _stale(m, robot, kind):
    if kind == "axis":
        axes = np.asarray(robot.joint_axis).copy()
        axes[1] = [0.0, 0.0, 1.0]
        return dataclasses.replace(robot, joint_axis=jnp.asarray(axes))
    if kind == "type":
        types = np.asarray(robot.joint_type).copy()
        types[0] = m.PRISMATIC
        return dataclasses.replace(robot, joint_type=jnp.asarray(types))
    if kind == "none":
        return dataclasses.replace(robot, joint_static=None)
    return robot


@pytest.mark.parametrize("robot_name", ["arm_7dof", "rpr_prismatic",
                                        "general_axis"])
@pytest.mark.parametrize("kind", ["honest", "axis", "type", "none"])
def test_guard_matches_jax(robot_name, kind):
    """check_joint_static takes the JAX guard's decision on the same robot:
    a stale spec warns (UserWarning naming joint_static) and comes back
    with joint_static=None; a consistent one, or none, passes unchanged."""
    jr = _stale(jmodel, _ROBOTS[robot_name][0](jmodel), kind)
    robot = convert.robot_from_numpy(_fields(jr))
    with warnings.catch_warnings(record=True) as j_warn:
        warnings.simplefilter("always")
        j_out = j_check(jr)
    with warnings.catch_warnings(record=True) as t_warn:
        warnings.simplefilter("always")
        t_out = tmodel.check_joint_static(robot)
    assert [(w.category, str(w.message)) for w in t_warn] == [
        (w.category, str(w.message)) for w in j_warn]
    assert (t_out.joint_static is None) == (j_out.joint_static is None)
    assert (t_out is robot) == (j_out is jr)
    stale = kind in ("axis", "type")
    assert bool(t_warn) == stale
    if stale:
        assert "joint_static" in str(t_warn[0].message)
        assert tr.chain_of(t_out) is None


def _cfg():
    return PlannerConfig(
        num_timesteps=12, duration=1.5, num_rollouts=6,
        noise=NoiseConfig(stddev=0.2, decay=0.995, num_rollouts_reused=2),
        weights=CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.08, max_iterations=8,
        max_iterations_after_collision_free=3, record_metrics=False)


def _stale_arm():
    """arm_7dof with joint 1's axis replaced and joint_static left stale,
    and the honest robot with the same arrays and no joint_static."""
    robot = tmodel.arm_7dof()
    axes = robot.joint_axis.clone()
    axes[1] = torch.tensor([0.0, 0.0, 1.0])
    stale = dataclasses.replace(robot, joint_axis=axes)
    return stale, dataclasses.replace(stale, joint_static=None)


_WORLD = AnalyticWorld.make(spheres=[((0.5, 0.2, 0.5), 0.15)])


def _guard_warnings(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [w for w in caught if issubclass(w.category, UserWarning)
                 and "joint_static" in str(w.message)]


def test_plan_warns_and_drops_stale_joint_static():
    stale, honest = _stale_arm()
    prob = ProblemSpec(q0=np.zeros(7, np.float32),
                       qN=np.full(7, 0.4, np.float32))
    a, warned = _guard_warnings(lambda: plan(stale, _WORLD, prob, _cfg(),
                                             device="cpu"))
    assert len(warned) == 1
    b = plan(honest, _WORLD, prob, _cfg(), device="cpu")
    assert torch.equal(a.trajectory, b.trajectory)
    assert bool(a.success) == bool(b.success)


def test_plan_batch_warns_on_stale_joint_static():
    stale, _ = _stale_arm()
    B = 4
    prob = ProblemSpec(q0=np.zeros((B, 7), np.float32),
                       qN=np.full((B, 7), 0.4, np.float32))
    _, warned = _guard_warnings(lambda: plan_batch(stale, _WORLD, prob,
                                                   _cfg(), device="cpu"))
    assert len(warned) == 1


def _mpc_states(robot, B):
    rng = np.random.default_rng(0)
    return tmpc.init_mpc(robot, _cfg(), np.zeros((B, 7), np.float32),
                         np.full((B, 7), 0.3, np.float32),
                         np.tile([[[0.6, 0.3, 0.4]]], (B, 1, 1)),
                         rng.normal(0, 0.1, (B, 1, 3)))


@pytest.mark.parametrize("entry", ["run_mpc_batch", "run_mpc",
                                   "run_mpc_resilient"])
def test_mpc_entries_warn_once_on_stale_joint_static(entry):
    """The MPC entry points run the same guard, once per call (the
    resilient driver's chunks do not warn again)."""
    stale, _ = _stale_arm()
    B = 2
    states = _mpc_states(stale, B)
    if entry == "run_mpc":
        states = dataclasses.replace(states, **{
            f.name: getattr(states, f.name)[0]
            for f in dataclasses.fields(states)})
    kw = dict(chunk_ticks=1) if entry == "run_mpc_resilient" else {}
    _, warned = _guard_warnings(lambda: getattr(tmpc, entry)(
        stale, _cfg(), states, [0.1], 2, 0.1, device="cpu", **kw))
    assert len(warned) == 1


def test_consistent_robot_does_not_warn():
    prob = ProblemSpec(q0=np.zeros(7, np.float32),
                       qN=np.full(7, 0.4, np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        plan(tmodel.arm_7dof(), _WORLD, prob, _cfg(), device="cpu")
        tmpc.run_mpc_batch(tmodel.arm_7dof(), _cfg(),
                           _mpc_states(tmodel.arm_7dof(), 2), [0.1], 1, 0.1,
                           device="cpu")

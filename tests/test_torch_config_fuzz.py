"""Config-surface fuzz for the port: the reference's random-but-valid
PlannerConfigs (tests/integration/test_config_fuzz.py ``_random_config``,
the same seeds) through the port's public ``plan(device="cpu")``.

Each sampled configuration must solve a tiny planar_2r problem without
breaking the solver's invariants: finite costs, exactly preserved
endpoints, joint limits respected where enforced, metrics present iff
record_metrics, iterations within the budget. A configuration that asks
for ``prng_impl="rbg"`` (the TPU's hardware generator) is refused by the
port's ``check_supported``; the same configuration with threefry must then
hold the invariants, through ``plan`` and, where the reference drives the
flag's live path (STOMP without torque), through the batched time-major
``plan_batch`` at B = 2. What is exercised is feature composition, not
numerics (the parity tests own those).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import tpustomp.api.config as jcfg
import tpustomp_torch.api.config as tcfg
from tpustomp_torch import ProblemSpec, plan, plan_batch
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.sdf import AnalyticWorld

_spec = importlib.util.spec_from_file_location(
    "_reference_config_fuzz",
    Path(__file__).parent / "integration" / "test_config_fuzz.py")
_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref)
SEEDS = _ref.SEEDS


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    tiny, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(seed):
    """The reference's sampled configuration as the port's PlannerConfig."""
    return tcfg.from_dict(jcfg.to_dict(
        _ref._random_config(np.random.default_rng(seed))))


def _threefry(cfg):
    return cfg.replace(noise=dataclasses.replace(cfg.noise,
                                                 prng_impl="threefry"))


def _check(robot, cfg, sol, q0, qN):
    traj = sol.trajectory.numpy()
    assert np.isfinite(traj).all(), cfg
    assert np.isfinite(float(sol.cost)), cfg
    np.testing.assert_allclose(traj[0], q0, atol=1e-6)
    np.testing.assert_allclose(traj[-1], qN, atol=1e-6)
    lim = robot.joint_limited.numpy()
    lo = robot.joint_lower.numpy() - 1e-5
    hi = robot.joint_upper.numpy() + 1e-5
    if lim.any():
        inner = traj[1:-1][:, lim]
        assert (inner >= lo[lim]).all() and (inner <= hi[lim]).all(), cfg
    if cfg.record_metrics:
        assert sol.metrics is not None
        assert np.isfinite(
            sol.metrics.total_cost.numpy()[:int(sol.iterations)]).all()
    else:
        assert sol.metrics is None
    assert 0 < int(sol.iterations) <= cfg.max_iterations


@pytest.mark.parametrize("seed", SEEDS)
def test_random_config_solves_with_invariants(seed):
    cfg = _config(seed)
    robot = tmodel.planar_2r(masses=(1.0, 1.0))  # masses: torque-cost ready
    world = AnalyticWorld.make(spheres=[((1.0, 0.8, 0.0), 0.2)])
    q0 = np.zeros(2, np.float32)
    qN = np.array([2.0, -0.8], np.float32)
    problem = ProblemSpec(q0=q0, qN=qN)
    if cfg.noise.prng_impl == "rbg":
        with pytest.raises(NotImplementedError, match="prng_impl"):
            tcfg.check_supported(cfg)
        with pytest.raises(NotImplementedError, match="prng_impl"):
            plan(robot, world, problem, cfg, device="cpu")
    run = _threefry(cfg)
    sol = plan(robot, world, problem, run, device="cpu",
               generator=torch.Generator().manual_seed(seed))
    _check(robot, run, sol, q0, qN)
    if (cfg.noise.prng_impl == "rbg" and cfg.mode == "stomp"
            and cfg.weights.torque == 0.0):
        q0b = np.stack([q0, q0 + 0.01])
        qNb = np.stack([qN, qN - 0.01])
        solB = plan_batch(robot, world, ProblemSpec(q0=q0b, qN=qNb), run,
                          device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        trajB = solB.trajectory.numpy()
        assert np.isfinite(trajB).all(), run
        np.testing.assert_allclose(trajB[:, 0], q0b, atol=1e-6)
        np.testing.assert_allclose(trajB[:, -1], qNb, atol=1e-6)


def test_fuzz_covers_both_modes_and_impls():
    """Guard the sweep's coverage as the reference does: both solver
    modes, both prng impls (an rbg config on the STOMP path without
    torque), both limit methods and all three stencils; and every sampled
    configuration converts to the port's without loss."""
    cfgs = [_config(s) for s in SEEDS]
    assert {c.mode for c in cfgs} == {"stomp", "chomp"}
    assert any(c.noise.prng_impl == "rbg" and c.mode == "stomp"
               and c.weights.torque == 0.0 for c in cfgs)
    assert {c.noise.prng_impl for c in cfgs} == {"threefry", "rbg"}
    assert {c.joint_limit_method for c in cfgs} == {"jacobi", "sequential"}
    assert {c.smoothness.stencil for c in cfgs} == {"fd3", "fd5", "fd7"}
    for s, c in zip(SEEDS, cfgs):
        assert tcfg.to_dict(c) == jcfg.to_dict(
            _ref._random_config(np.random.default_rng(s)))

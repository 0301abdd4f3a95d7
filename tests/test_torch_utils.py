"""The port's tooling (tpustomp_torch/utils): checkpoint round trips and a
resumed MPC episode (the JAX package's tests/unit/test_checkpoint.py, with
the generator's state saved beside the MPC state: the port's noise is a
generator, not a key in the state), debug_mode's per-iteration check,
the profiler window, and every figure dump (matplotlib Agg, on the host).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpustomp_torch import PlannerConfig, ProblemSpec, plan, plan_batch
from tpustomp_torch._tensors import map_tensors
from tpustomp_torch.api.config import NoiseConfig
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import mpc, solver
from tpustomp_torch.robot.model import arm_7dof, planar_2r
from tpustomp_torch.utils import checkpoint, tracing, viz
from tpustomp_torch.world.sdf import AnalyticWorld

_SPHERE = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)])


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif dataclasses.is_dataclass(x):
            _equal(x, y)
        else:
            assert x == y, f.name


def test_solver_state_roundtrip(tmp_path):
    robot = planar_2r()
    cfg = PlannerConfig(num_timesteps=10, duration=1.0, max_iterations=20)
    q0 = torch.tensor([[0.1, -0.2], [0.3, 0.0]])
    qN = torch.tensor([[0.5, 0.4], [-0.5, 0.2]])
    state = solver.init_state(robot, cfg, q0, qN)
    state = dataclasses.replace(
        state, iteration=torch.tensor([7, 3], dtype=torch.int32),
        best_cost=torch.tensor([1.25, float("inf")]),
        theta=state.theta + 0.01)
    path = str(tmp_path / "solver.pt")
    checkpoint.save(path, state)
    template = solver.init_state(robot, cfg, q0 * 0, qN * 0)
    restored = checkpoint.restore(path, template)
    _equal(restored, state)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, solver.init_state(robot, cfg, q0[:1],
                                                   qN[:1]))


def test_solution_with_metrics_and_numbers_roundtrip(tmp_path):
    """A Solution with its nested IterationMetrics, beside plain numbers
    and a None, in one dict."""
    cfg = PlannerConfig(num_timesteps=8, num_rollouts=4, max_iterations=3,
                        record_metrics=True)
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    sol = plan_batch(planar_2r(), _SPHERE, prob, cfg, device="cpu")
    blob = {"sol": sol, "tick": 12, "scale": 0.5, "none": None}
    path = str(tmp_path / "sol.pt")
    checkpoint.save(path, blob)
    template = {"sol": map_tensors(sol, torch.zeros_like), "tick": 0,
                "scale": 0.0, "none": None}
    back = checkpoint.restore(path, template)
    _equal(back["sol"], sol)
    assert back["tick"] == 12 and back["scale"] == 0.5 and back["none"] is None
    with pytest.raises(TypeError, match="checkpoint"):
        checkpoint.save(path, {"bad": object()})


def test_solution_to_the_host_on_the_cpu_is_itself():
    """Solution.to("cpu") of a solution made on the CPU hands back its own
    tensors, as before the pinned copy from the card."""
    cfg = PlannerConfig(num_timesteps=8, num_rollouts=4, max_iterations=3,
                        record_metrics=True)
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    sol = plan_batch(planar_2r(), _SPHERE, prob, cfg, device="cpu")
    host = sol.to("cpu")
    assert host.trajectory is sol.trajectory
    assert host.metrics.total_cost is sol.metrics.total_cost
    _equal(host, sol)


def _mpc_setup():
    robot = planar_2r(body_radius=0.05)
    cfg = PlannerConfig(
        num_timesteps=12, duration=1.2, num_rollouts=4,
        noise=NoiseConfig(stddev=0.2, decay=1.0, num_rollouts_reused=1),
        max_iterations=3, max_iterations_after_collision_free=2,
        record_metrics=False)
    rng = np.random.default_rng(0)
    B = 3
    state = mpc.init_mpc(
        robot, cfg,
        np.tile([-0.5, 1.5], (B, 1)) + rng.uniform(-0.05, 0.05, (B, 2)),
        np.tile([1.0, -1.4], (B, 1)),
        np.tile([[[2.4, -0.6, 0.0]]], (B, 1, 1)),
        np.tile([[[-0.1, 0.1, 0.0]]], (B, 1, 1)))
    return robot, cfg, state


def test_mpc_state_roundtrip_and_resume(tmp_path):
    """Three ticks, a checkpoint of (state, generator), then two more ticks
    from a fresh template and generator: bitwise the five-tick episode."""
    robot, cfg, state = _mpc_setup()
    kw = dict(device="cpu")
    whole = mpc.run_mpc_batch(robot, cfg, state, [0.2], 5, 0.1, **kw,
                              generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    mid = mpc.run_mpc_batch(robot, cfg, state, [0.2], 3, 0.1, **kw,
                            generator=gen)
    path = str(tmp_path / "mpc.pt")
    checkpoint.save(path, {"state": mid, "generator": gen})
    gen.manual_seed(99)                          # the live one moves on
    _, _, fresh = _mpc_setup()
    back = checkpoint.restore(path, {"state": fresh,
                                     "generator": torch.Generator()})
    _equal(back["state"], mid)
    out = mpc.run_mpc_batch(robot, cfg, back["state"], [0.2], 2, 0.1, **kw,
                            generator=back["generator"])
    _equal(out, whole)
    assert out.steps.tolist() == [5, 5, 5]


def test_debug_mode_raises_on_injected_nan():
    """A NaN in the noise at iteration 2 poisons theta: under debug_mode
    solve_batch raises naming the iteration; outside it the solve runs on
    and returns the poisoned result."""
    robot = planar_2r(body_radius=0.05)
    cfg = PlannerConfig(num_timesteps=10, num_rollouts=4, max_iterations=6,
                        max_iterations_after_collision_free=6,
                        record_metrics=False)
    ops = device_ops(10, cfg.dt, cfg.smoothness, "cpu")
    q0 = torch.tensor([[-0.56, 1.65]])
    qN = torch.tensor([[1.16, -1.46]])

    def noise(iteration, active):
        z = torch.randn((2, 1, 4, 10),
                        generator=torch.Generator().manual_seed(iteration))
        if iteration == 2:
            z[0, 0, 0, 3] = float("nan")
        return z

    sol = solver.solve_batch(robot, _SPHERE, cfg, ops, q0, qN, noise)
    assert int(sol.iterations[0]) == 6
    with pytest.raises(FloatingPointError, match="after iteration 2"):
        tracing.checked_solve(robot, _SPHERE, cfg, ops, q0, qN, noise)
    assert not tracing.debug_enabled()
    with tracing.debug_mode():
        assert tracing.debug_enabled()
        assert torch.is_anomaly_enabled()
        ok = solver.solve_batch(robot, _SPHERE, cfg, ops, q0, qN,
                                lambda it, a: torch.zeros(2, 1, 4, 10))
    assert bool(torch.isfinite(ok.trajectory).all())
    assert not torch.is_anomaly_enabled()


def test_profile_writes_a_trace(tmp_path):
    cfg = PlannerConfig(num_timesteps=8, num_rollouts=4, max_iterations=2)
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    logdir = str(tmp_path / "trace")
    with tracing.profile(logdir) as prof:
        plan_batch(planar_2r(), _SPHERE, prob, cfg, device="cpu")
    trace = os.path.join(logdir, "trace.json")
    assert os.path.getsize(trace) > 0
    assert len(prof.key_averages()) > 0


def _solution(robot, world, cfg):
    return plan(robot, world, ProblemSpec(q0=[-0.56, 1.65],
                                          qN=[1.16, -1.46]), cfg,
                device="cpu")


@pytest.mark.parametrize("fn", ["plot_planar", "plot_metrics",
                                "plot_ee_path_3d", "animate_trajectory"])
def test_viz_writes_a_file(tmp_path, fn):
    cfg = PlannerConfig(num_timesteps=10, num_rollouts=4, max_iterations=4,
                        record_metrics=True)
    robot = planar_2r(body_radius=0.05)
    world = AnalyticWorld.make(spheres=[((1.88, 0.42, 0.0), 0.27)],
                               boxes=[((0.0, -1.5, 0.0), (0.2, 0.2, 0.2))])
    sol = _solution(robot, world, cfg)
    path = str(tmp_path / ("out.gif" if fn == "animate_trajectory"
                           else "out.png"))
    if fn == "plot_metrics":
        assert viz.plot_metrics(sol, path=path) == path
    else:
        assert getattr(viz, fn)(robot, sol, world, path=path) == path
    assert os.path.getsize(path) > 0


def test_animate_knobs_dump_figures_and_never_break_planning(
        tmp_path, monkeypatch, capsys):
    """cfg.animate_path through plan writes tpustomp_viz/ (the JAX hook,
    api/plan.py:312-335); a failing dump is printed and planning returns."""
    monkeypatch.chdir(tmp_path)
    cfg = PlannerConfig(num_timesteps=10, num_rollouts=4, max_iterations=4,
                        record_metrics=True, animate_path=True)
    robot = arm_7dof()
    world = AnalyticWorld.make(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))])
    sol = plan(robot, world, ProblemSpec(
        q0=[-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0],
        qN=[0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0]), cfg, device="cpu")
    for name in ("ee_path.png", "trajectory.gif", "metrics.png"):
        assert os.path.getsize(tmp_path / "tpustomp_viz" / name) > 0

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(viz, "plot_ee_path_3d", broken)
    again = _solution(planar_2r(), _SPHERE,
                      cfg.replace(animate_path=False,
                                  animate_endeffector=True))
    assert "viz dump failed: disk full" in capsys.readouterr().out
    assert again.trajectory.shape == (12, 2)
    assert sol.trajectory.shape == (12, 7)

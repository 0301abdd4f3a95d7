"""Guards of the PyTorch port: it never imports JAX, never picks a device
or falls back to the plain evaluator on its own, and rejects what it does
not implement."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpustomp_torch import PlannerConfig, ProblemSpec, plan, plan_batch
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.model import planar_2r
from tpustomp_torch.world.sdf import AnalyticWorld

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL = PlannerConfig(num_timesteps=6, num_rollouts=3, max_iterations=2)
_WORLD = AnalyticWorld.make(spheres=[((1.5, 0.5, 0.0), 0.2)])


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_port_imports_no_jax():
    """A fresh interpreter (this one already imported jax via conftest)."""
    code = ("import tpustomp_torch, tpustomp_torch.convert, "
            "tpustomp_torch.engine.solver, tpustomp_torch.kernels.rollout, "
            "tpustomp_torch.world.edt, tpustomp_torch.world.decompose, "
            "sys; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'tpustomp')); assert not bad, bad")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing and needs no compiler."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)                 # no nvcc on PATH
    res = _run("import tpustomp_torch.kernels.rollout as r; "
               "assert r._libs == {} and set(r.LAUNCHES.values()) == {0}",
               env=env)
    assert res.returncode == 0, res.stderr


def test_plan_batch_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; nothing to refuse")
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_batch(planar_2r(), _WORLD, prob, _SMALL, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan(planar_2r(), _WORLD, ProblemSpec(q0=[0.0, 0.0], qN=[1.0, 1.0]),
             _SMALL, device="cuda")


def test_device_is_required():
    prob = ProblemSpec(q0=np.zeros((1, 2), np.float32),
                       qN=np.ones((1, 2), np.float32))
    with pytest.raises(TypeError):
        plan_batch(planar_2r(), _WORLD, prob, _SMALL)


def test_wrapper_never_falls_back_off_cpu():
    """For non-CPU tensors the wrapper launches the kernel or raises; the
    "xla" backend (the plain path) is refused off the CPU."""
    robot = planar_2r()
    meta = torch.empty((4, 5, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.obstacle_cost_batch(robot, _WORLD, meta, 0.1, 0.05)
    with pytest.raises(ValueError, match="xla"):
        tsolver._obstacle_rows(robot, _WORLD,
                               PlannerConfig(obstacle_backend="xla"), meta)


def test_goal_tolerance_and_other_worlds_raise():
    prob = ProblemSpec(q0=np.zeros((1, 2), np.float32),
                       qN=np.ones((1, 2), np.float32),
                       goal_tolerance_below=np.full(2, 0.1, np.float32))
    with pytest.raises(NotImplementedError, match="goal tolerance"):
        plan_batch(planar_2r(), _WORLD, prob, _SMALL, device="cpu")
    prob = ProblemSpec(q0=np.zeros((1, 2), np.float32),
                       qN=np.ones((1, 2), np.float32))
    with pytest.raises(NotImplementedError, match="AnalyticWorld"):
        plan_batch(planar_2r(), object(), prob, _SMALL, device="cpu")


def test_noise_fn_shape_checked():
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    with pytest.raises(ValueError, match="noise_fn returned"):
        plan_batch(planar_2r(), _WORLD, prob, _SMALL, device="cpu",
                   noise_fn=lambda it, active: torch.zeros(2, 2, 3, 5))


def test_xla_backend_runs_plain_on_cpu():
    prob = ProblemSpec(q0=np.zeros((2, 2), np.float32),
                       qN=np.ones((2, 2), np.float32))
    a = plan_batch(planar_2r(), _WORLD, prob, _SMALL, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    b = plan_batch(planar_2r(), _WORLD, prob,
                   _SMALL.replace(obstacle_backend="xla"), device="cpu",
                   generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.trajectory, b.trajectory, rtol=0, atol=0)

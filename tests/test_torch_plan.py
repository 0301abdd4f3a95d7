"""The port's public API (``plan_batch``, ``plan``) against the JAX package
on the whole slice, over analytic and voxel worlds, under the same noise
(the replayed JAX key chain of tests/test_torch_solver.py).

The JAX side runs its production path with the Pallas evaluator in
interpret mode (obstacle_backend="pallas", pallas_interpret=True); the port
runs on the CPU, where its evaluator is the plain PyTorch version.
"""

import dataclasses

import jax
import numpy as np
import pytest

from tests.test_torch_solver import (_Q0, _QN, _ReplayJaxNoise, _configs,
                                     _fields, _jitter, _scene)
from tpustomp.api.plan import plan as j_plan
from tpustomp.api.plan import plan_batch as j_plan_batch
from tpustomp.api.problem import ProblemSpec as JProblem
from tpustomp.world import edt as jedt
from tpustomp.world.sdf import CompositeWorld as JComposite
from tpustomp_torch import ProblemSpec, convert, plan, plan_batch


def _assert_solutions(got, ref, traj_atol=1e-4, cost_rtol=1e-4):
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.trajectory.numpy(),
                               np.asarray(ref.trajectory), atol=traj_atol)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=cost_rtol)
    np.testing.assert_allclose(got.times.numpy(), np.asarray(ref.times),
                               rtol=1e-6)


def test_plan_batch_matches_jax():
    """The whole slice: plan_batch on arm_7dof, N=20, K=8, Kr=2, B=3,
    max_iterations=8, tabletop world."""
    cj, ct = _configs()
    jr, jw, robot, world = _scene()
    B = 3
    q0, qN = _jitter(B, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0, qN=qN), cj, keys=keys)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                     device="cpu",
                     noise_fn=_ReplayJaxNoise(keys, 7, ct.num_rollouts,
                                              ct.num_timesteps))
    _assert_solutions(got, ref)
    assert got.trajectory.shape == (B, 22, 7)
    np.testing.assert_allclose(got.metrics.total_cost.numpy(),
                               np.asarray(ref.metrics.total_cost),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("restarts", [1, 2])
def test_plan_matches_jax(restarts):
    """plan at B=1 (restarts fold into the scenario axis; select_best keeps
    the best) against the JAX single-query path."""
    cj, ct = _configs(num_restarts=restarts)
    jr, jw, robot, world = _scene()
    key = jax.random.PRNGKey(7)
    ref = j_plan(jr, jw, JProblem(q0=_Q0, qN=_QN), cj, key=key)
    keys = (key[None] if restarts == 1
            else jax.random.split(key, restarts))
    got = plan(robot, world, ProblemSpec(q0=_Q0, qN=_QN), ct, device="cpu",
               noise_fn=_ReplayJaxNoise(keys, 7, ct.num_rollouts,
                                        ct.num_timesteps))
    assert got.trajectory.shape == (22, 7) and got.success.shape == ()
    _assert_solutions(got, ref)


def _grid_scene(kind):
    """The tabletop voxelized coarsely (32x40x24 at 5 cm, the config-2 grid's
    origin) through the signed EDT, on both sides; "composite" adds the
    overlay sphere of bench/kernel_parity.py."""
    jr, jw, robot, _ = _scene()
    origin, shape, res = (-0.2, -1.0, 0.0), (32, 40, 24), 0.05
    jg = jedt.signed_edt(jedt.occupancy_from_analytic(jw, origin, shape, res),
                         res, origin)
    if kind == "grid":
        return jr, jg, robot, convert.grid_from_numpy(_fields(jg))
    jc = JComposite.make(jg, spheres=[((0.35, 0.3, 0.55), 0.12)])
    return jr, jc, robot, convert.composite_from_numpy(_fields(jc.grid),
                                                       _fields(jc.overlay))


@pytest.mark.parametrize("kind", ["grid", "composite"])
def test_plan_batch_grid_matches_jax(kind):
    """The slice over a voxel world: JAX runs grid worlds through its
    scenario-major batched step (K5 + _grid_finish in interpret mode), the
    port through the same time-major step as analytic worlds."""
    cj, ct = _configs()
    jr, jw, robot, world = _grid_scene(kind)
    B = 3
    q0, qN = _jitter(B, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0, qN=qN), cj, keys=keys)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                     device="cpu",
                     noise_fn=_ReplayJaxNoise(keys, 7, ct.num_rollouts,
                                              ct.num_timesteps))
    _assert_solutions(got, ref)


def test_plan_grid_matches_jax():
    cj, ct = _configs()
    jr, jw, robot, world = _grid_scene("grid")
    key = jax.random.PRNGKey(7)
    ref = j_plan(jr, jw, JProblem(q0=_Q0, qN=_QN), cj, key=key)
    got = plan(robot, world, ProblemSpec(q0=_Q0, qN=_QN), ct, device="cpu",
               noise_fn=_ReplayJaxNoise(key[None], 7, ct.num_rollouts,
                                        ct.num_timesteps))
    assert bool(got.success)
    _assert_solutions(got, ref)


def test_plan_refuses_per_candidate_overlay():
    """A composite whose overlay has a row axis is a per-scenario world
    (solve_batch with world_batched=True, as MPC runs it; held to JAX in
    tests/test_torch_mpc.py). `plan` takes one world shared by every
    candidate, and both packages refuse the row form there: the JAX
    package on the row/candidate mismatch, the port up front."""
    cj, ct = _configs()
    jr, jw, robot, world = _grid_scene("composite")
    with pytest.raises(ValueError, match="inconsistent sizes"):
        j_plan(jr, JComposite(grid=jw.grid, overlay=jax.tree.map(
            lambda x: x[None], jw.overlay)), JProblem(q0=_Q0, qN=_QN), cj,
               key=jax.random.PRNGKey(0))
    over = dataclasses.replace(world.overlay, **{
        f.name: getattr(world.overlay, f.name)[None]
        for f in dataclasses.fields(world.overlay)})
    with pytest.raises(ValueError, match="world_batched"):
        plan(robot, dataclasses.replace(world, overlay=over),
             ProblemSpec(q0=_Q0, qN=_QN), ct, device="cpu")

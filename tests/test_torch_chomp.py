"""CHOMP and CHOMP-HMC (BASELINE config 3) against the JAX package.

Module by module: potential_deriv (exact), sdf_grad over spheres, boxes
(outside and inside, ties included), grids and composites (distance and
gradient atol 1e-5), point Jacobians (atol 1e-5), the closed-form 3×3 solve,
smoothness cost and gradient, the functional gradient with curvature and
pseudo-inverse each on and off, the exact (autodiff) gradients and the
full CHOMP gradient with constraint and torque terms (rtol 1e-4 of the
gradient's scale: float32 sums over bodies and waypoints in another order).

The whole slice: plan_batch in CHOMP mode against the JAX package's
vmap(solve_best_of), HMC in both Metropolis modes with the momentum and
accept draws replayed from the JAX key chain (split(key, 3) per iteration),
and plan: success and iterations equal, trajectory atol 1e-4, cost rtol
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_constraints import _constraints
from tests.test_torch_plan import _assert_solutions, _grid_scene
from tests.test_torch_solver import (_Q0, _QN, _configs, _fields, _jitter,
                                     _scene)
from tests.test_torch_torque import _robots
from tpustomp.api.config import CostWeights as JWeights
from tpustomp.api.config import NoiseConfig as JNoise
from tpustomp.api.plan import plan as j_plan
from tpustomp.api.plan import plan_batch as j_plan_batch
from tpustomp.api.problem import ProblemSpec as JProblem
from tpustomp.costs import obstacle as jobs
from tpustomp.costs import smoothness as jsm
from tpustomp.dynamics.device import device_ops as j_device_ops
from tpustomp.engine import chomp as jchomp
from tpustomp.robot import fk as jfk
from tpustomp.world import sdf as jsdf
from tpustomp_torch import ProblemSpec, convert, plan, plan_batch
from tpustomp_torch.costs import obstacle as tobs
from tpustomp_torch.costs import smoothness as tsm
from tpustomp_torch.engine import chomp as tchomp
from tpustomp_torch.robot import fk as tfk
from tpustomp_torch.world import sdf as tsdf

_N = 20
_DT = 5.0 / (_N + 1)


def test_potential_deriv_matches_jax():
    eps = 0.05
    d = np.concatenate([np.linspace(-0.2, 0.2, 81),
                        [0.0, eps, -0.0, eps * 0.5]]).astype(np.float32)
    got = tobs.potential_deriv(torch.from_numpy(d), eps)
    ref = jobs.potential_deriv(jnp.asarray(d), eps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _points(kind):
    rng = np.random.default_rng(0)
    if kind == "box_inside":
        # inside the table box, with the exact centre and a point equidistant
        # from two faces (the face rule's ties)
        p = rng.uniform([0.2, -0.5, 0.0], [1.0, 0.5, 0.4], (60, 3))
        p = np.concatenate([p, [[0.6, 0.0, 0.2], [0.6, 0.55, 0.4]]])
    else:
        p = rng.uniform([-0.2, -1.0, 0.0], [1.3, 0.9, 1.1], (200, 3))
    return p.astype(np.float32).reshape(2, -1, 3)


@pytest.mark.parametrize("kind", ["sphere", "box_outside", "box_inside",
                                  "mixed", "grid", "composite"])
def test_sdf_grad_matches_jax(kind):
    if kind in ("grid", "composite"):
        _, jw, _, world = _grid_scene(kind)
    else:
        spheres = [((0.3, 0.3, 0.9), 0.1), ((1.0, -0.4, 0.5), 0.3)]
        boxes = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))]
        jw = jsdf.AnalyticWorld.make(
            spheres=spheres if kind in ("sphere", "mixed") else (),
            boxes=boxes if kind != "sphere" else ())
        world = convert.world_from_numpy(_fields(jw))
    p = _points(kind)
    d_r, g_r = jsdf.sdf_grad(jw, jnp.asarray(p))
    d, g = tsdf.sdf_grad(world, torch.from_numpy(p))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), atol=1e-5)
    if kind == "box_inside":
        assert float(d.max()) < 0.0
        np.testing.assert_allclose(g[1, -2].numpy(), [0.0, 0.0, 0.0])
    np.testing.assert_allclose(
        d.numpy(), tsdf.sdf(world, torch.from_numpy(p)).numpy(), atol=1e-6)


def test_sdf_grad_refuses_row_worlds():
    world = tsdf.AnalyticWorld(
        sphere_center=torch.zeros(3, 1, 3), sphere_radius=torch.ones(3, 1),
        box_center=torch.zeros(3, 0, 3), box_half=torch.zeros(3, 0, 3))
    with pytest.raises(NotImplementedError, match="row axis"):
        tsdf.sdf_grad(world, torch.zeros(3, 4, 3))
    empty = tsdf.AnalyticWorld.make()
    d, g = tsdf.sdf_grad(empty, torch.ones(5, 3))
    assert bool((d == 1e6).all()) and bool((g == 0).all())


@pytest.mark.parametrize("kind", ["arm_7dof", "prismatic_chain"])
def test_jacobians_match_jax(kind):
    jr, robot = _robots(kind)
    rng = np.random.default_rng(3)
    traj = rng.uniform(-1.0, 1.0, (3, 9, robot.num_joints)).astype(
        np.float32)
    x_r, J_r = jax.vmap(lambda t: jfk.body_pos_jac_traj(jr, t))(
        jnp.asarray(traj))
    x, J = tfk.body_pos_jac_traj(robot, torch.from_numpy(traj))
    assert J.shape == (3, 9, robot.num_bodies, 3, robot.num_joints)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_r), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_r), atol=1e-5)


def test_dls_solve3_and_smoothness_match_jax():
    rng = np.random.default_rng(4)
    J = rng.normal(size=(6, 4, 3, 7)).astype(np.float32)
    b = rng.normal(size=(6, 4, 3)).astype(np.float32)
    ref = jchomp._dls_solve3(jnp.asarray(J), jnp.asarray(b), 1e-4)
    got = tchomp._dls_solve3(torch.from_numpy(J), torch.from_numpy(b), 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    cfg = _configs()[0]
    ops_j = j_device_ops(_N, cfg.dt, cfg.smoothness)
    ops = convert.ops_from_numpy(_fields(ops_j))
    q0, qN = _jitter(3, 1)
    theta = rng.normal(0, 0.3, (3, _N, 7)).astype(np.float32)
    g_r = jax.vmap(lambda t, a, c: jsm.smoothness_gradient(ops_j, t, a, c))(
        jnp.asarray(theta), jnp.asarray(q0), jnp.asarray(qN))
    c_r = jax.vmap(lambda t, a, c: jsm.smoothness_cost(ops_j, t, a, c))(
        jnp.asarray(theta), jnp.asarray(q0), jnp.asarray(qN))
    args = map(torch.from_numpy, (theta, q0, qN))
    th, a, c = args
    np.testing.assert_allclose(tsm.smoothness_gradient(ops, th, a, c).numpy(),
                               np.asarray(g_r), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(tsm.smoothness_cost(ops, th, a, c).numpy(),
                               np.asarray(c_r), rtol=1e-5)


def _near_table(B, seed):
    """B trajectories [B, N+2, 7] that graze the tabletop: the config-2
    endpoints joined by a min-jerk path, lowered and perturbed."""
    q0, qN = _jitter(B, seed)
    u = np.linspace(0, 1, _N + 2)[:, None]
    s = 10 * u ** 3 - 15 * u ** 4 + 6 * u ** 5
    full = q0[:, None] + s * (qN - q0)[:, None]
    rng = np.random.default_rng(seed)
    full[:, 1:-1] += rng.normal(0, 0.15, (B, _N, 7))
    full[:, 1:-1, 1] += 0.35 * np.sin(np.pi * u[1:-1, 0])
    return full.astype(np.float32)


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("curvature", [True, False])
@pytest.mark.parametrize("pinv", [False, True])
def test_functional_gradient_matches_jax(curvature, pinv):
    jr, jw, robot, world = _scene()
    full = _near_table(3, 2)
    ref = jax.vmap(lambda f: jchomp.obstacle_functional_gradient(
        jr, jw, f, _DT, 0.05, curvature, pinv, 1e-4))(jnp.asarray(full))
    got = tchomp.obstacle_functional_gradient(
        robot, world, torch.from_numpy(full), _DT, 0.05, curvature, pinv,
        1e-4)
    assert got.shape == (3, _N, 7) and float(np.abs(ref).max()) > 0.0
    _close(got, ref)


def test_exact_and_chomp_gradients_match_jax():
    """The exact obstacle gradient, the exact constraint + torque gradient,
    and chomp_gradient / chomp_delta with every term on."""
    jr, jw, robot, world = _scene()
    jc, tc = _constraints("both")
    cfg = _configs()[0]
    ops_j = j_device_ops(_N, cfg.dt, cfg.smoothness)
    ops = convert.ops_from_numpy(_fields(ops_j))
    full = _near_table(2, 5)
    th_np = full[:, 1:-1]
    q0, qN = full[:, 0], full[:, -1]
    th, a, c = map(torch.from_numpy, (th_np, q0, qN))
    J = lambda f: jax.jit(jax.vmap(f))(jnp.asarray(th_np),  # noqa: E731
                                       jnp.asarray(q0), jnp.asarray(qN))
    ref = J(lambda t, x, y: jchomp.exact_obstacle_gradient(
        jr, jw, t, x, y, _DT, 0.05))
    _close(tchomp.exact_obstacle_gradient(robot, world, th, a, c, _DT, 0.05),
            ref)
    ref = J(lambda t, x, y: jchomp.exact_extra_gradient(
        jr, t, x, y, _DT, jc, 0.7, 0.005))
    got = tchomp.exact_extra_gradient(robot, th, a, c, _DT, tc, 0.7, 0.005)
    assert float(np.abs(ref).max()) > 0.0
    _close(got, ref)
    for mode in ("functional", "exact"):
        kw = dict(use_pseudo_inverse=True, pinv_ridge=1e-4,
                  gradient_mode=mode, w_constraint=0.7, w_torque=0.005)
        ref = J(lambda t, x, y: jchomp.chomp_delta(
            ops_j, jr, jw, t, x, y, jnp.concatenate([x[None], t, y[None]]),
            _DT, 0.05, 20.0, 0.1, 0.6, constraints=jc, **kw))
        got = tchomp.chomp_delta(ops, robot, world, th, a, c, _DT, 0.05,
                                 20.0, 0.1, 0.6, constraints=tc, **kw)
        _close(got, ref)


def _chomp_configs(**kw):
    """Config 3's CHOMP settings at a small size (N=20)."""
    base = dict(mode="chomp", learning_rate=0.6, chomp_joint_update_limit=0.1,
                use_pseudo_inverse=True, max_iterations=25,
                weights=JWeights(obstacle=20.0, smoothness=0.1))
    base.update(kw)
    return _configs(**base)


@pytest.mark.parametrize("variant", ["pinv", "plain_jt", "constrained",
                                     "exact", "torque"])
def test_chomp_plan_batch_matches_jax(variant):
    """plan_batch in CHOMP mode against the JAX package's vmap(solve_best_of)
    (its batched CHOMP), B=3; the constrained variant evaluates through the
    evaluator's frame output. The exact-gradient variant runs 6 iterations:
    in contact its gradient has kinks (the box SDF's face switches, the
    potential's branches) that amplify float32 rounding about tenfold every
    three iterations, so after ~10 the two packages' trajectories part at
    equal costs."""
    kw, cons = {}, "none"
    if variant == "plain_jt":
        kw = dict(use_pseudo_inverse=False)
    elif variant == "constrained":
        cons = "orientation"
    elif variant == "exact":
        kw, cons = dict(chomp_gradient_mode="exact", max_iterations=6), "both"
    elif variant == "torque":
        kw = dict(weights=JWeights(obstacle=20.0, smoothness=0.1,
                                   torque=0.005))
    cj, ct = _chomp_configs(**kw)
    jr, jw, robot, world = _scene()
    jc, tc = _constraints(cons) if cons != "none" else (None, None)
    q0, qN = _jitter(3, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0, qN=qN), cj, keys=keys,
                       constraints=jc)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                     device="cpu", constraints=tc)
    _assert_solutions(got, ref)
    np.testing.assert_allclose(got.metrics.total_cost.numpy(),
                               np.asarray(ref.metrics.total_cost),
                               rtol=1e-4, atol=1e-5)


class _ReplayJaxHMC:
    """HMC noise_fn replaying the JAX key chain: per active scenario, one
    split(key, 3) per iteration -> (key, momentum key, accept key)."""

    def __init__(self, keys, d, N):
        self.keys, self.shape = keys, (d, 1, N)

    def __call__(self, iteration, active):
        s = jax.vmap(lambda k: jax.random.split(k, 3))(self.keys)
        z = jax.vmap(lambda k: jax.random.normal(k, self.shape),
                     out_axes=1)(s[:, 1])                     # [d, B, 1, N]
        u = jax.vmap(jax.random.uniform)(s[:, 2])
        act = jnp.asarray(active.numpy())[:, None]
        self.keys = jnp.where(act, s[:, 0], self.keys)
        return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


@pytest.mark.parametrize("metropolis", [False, True])
def test_hmc_plan_batch_matches_jax(metropolis):
    """CHOMP-HMC with the experiment suite's settings (step 0.3, 3 leapfrog
    steps, temperature 0.05, decay 0.95), the draws replayed."""
    cj, ct = _chomp_configs(
        use_pseudo_inverse=False, use_hamiltonian_monte_carlo=True,
        hmc_step_size=0.3, hmc_leapfrog_steps=3, hmc_temperature=0.05,
        hmc_metropolis=metropolis, max_iterations=15,
        noise=JNoise(stddev=0.08, decay=0.95, num_rollouts_reused=5))
    jr, jw, robot, world = _scene()
    q0, qN = _jitter(3, 1)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0, qN=qN), cj, keys=keys)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                     device="cpu", noise_fn=_ReplayJaxHMC(keys, 7, _N))
    _assert_solutions(got, ref)


@pytest.mark.parametrize("restarts", [1, 2])
def test_chomp_plan_matches_jax(restarts):
    """plan in CHOMP mode, one query; two restarts of plain CHOMP are the
    same deterministic solve, and select_best keeps the first."""
    cj, ct = _chomp_configs(num_restarts=restarts)
    jr, jw, robot, world = _scene()
    ref = j_plan(jr, jw, JProblem(q0=_Q0, qN=_QN), cj,
                 key=jax.random.PRNGKey(7))
    got = plan(robot, world, ProblemSpec(q0=_Q0, qN=_QN), ct, device="cpu")
    assert got.trajectory.shape == (_N + 2, 7)
    _assert_solutions(got, ref)


def compare_hmc_on_config4(n: int = 16):
    """chip_smoke's HMC row (bench/experiment_suite.py:198-211's settings,
    N=100, 150 iterations) on the first n of its config-4 problems, the
    JAX package against the port on the CPU under the same draws:

        JAX_PLATFORMS=cpu python -m tests.test_torch_chomp [n]
    """
    import os

    import yaml

    import tpustomp.api.config as jcfg
    import tpustomp_torch.api.config as tcfg
    from tpustomp.robot import model as jmodel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "config2_tabletop.yaml")) as f:
        scene = yaml.safe_load(f)["scene"]
    rng = np.random.default_rng(0)          # chip_smoke's problems
    B = 1024
    q0 = np.tile(np.float32(scene["q0"]), (B, 1))
    qN = np.tile(np.float32(scene["qN"]), (B, 1))
    q0b = (q0 + rng.uniform(-.03, .03, (B, 7))).astype(np.float32)[:n]
    qNb = (qN + rng.uniform(-.03, .03, (B, 7))).astype(np.float32)[:n]
    cj = jcfg.PlannerConfig(
        num_timesteps=100, duration=5.0, collision_clearance=0.05,
        noise=jcfg.NoiseConfig(stddev=0.08, decay=0.95,
                               num_rollouts_reused=5),
        weights=jcfg.CostWeights(obstacle=20.0, smoothness=0.1),
        max_iterations=150, record_metrics=False, mode="chomp",
        learning_rate=0.6, use_hamiltonian_monte_carlo=True,
        hmc_step_size=0.3, hmc_leapfrog_steps=3, hmc_temperature=0.05)
    ct = tcfg.from_dict(jcfg.to_dict(cj))
    jr = jmodel.arm_7dof()
    jw = jsdf.AnalyticWorld.make(boxes=[(tuple(b["center"]), tuple(b["half"]))
                                        for b in scene["boxes"]])
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0b, qN=qNb), cj, keys=keys)
    got = plan_batch(convert.robot_from_numpy(_fields(jr)),
                     convert.world_from_numpy(_fields(jw)),
                     ProblemSpec(q0=q0b, qN=qNb), ct, device="cpu",
                     noise_fn=_ReplayJaxHMC(keys, 7, 100))
    its_ref = np.asarray(ref.iterations)
    print(f"jax success {float(np.asarray(ref.success).mean())}, "
          f"iterations {its_ref.tolist()}")
    print(f"port success {float(got.success.float().mean())}, "
          f"iterations {got.iterations.tolist()}")
    print(f"rows with equal iterations: "
          f"{int((got.iterations.numpy() == its_ref).sum())} of {n}")


if __name__ == "__main__":
    import sys

    compare_hmc_on_config4(*map(int, sys.argv[1:]))

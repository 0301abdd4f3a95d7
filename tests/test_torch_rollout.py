"""The port's evaluator (kernels/rollout.py) against the JAX package.

On the CPU the wrapper runs the plain PyTorch version, held here to the
JAX XLA cost path (costs/obstacle.obstacle_cost) and to the Pallas kernel
in interpret mode. Tolerances: q_obs atol 1e-5 / rtol 1e-5, margin atol
1e-6 (float32 rounding of the FK chain; measured max |Δ| 6.0e-7 for q_obs,
at |q_obs| up to 2.9, and 8.9e-8 for margin over the C=24, T=34 cases).

The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpustomp.costs.obstacle as jobst
import tpustomp.kernels.rollout_pallas as rp
from tpustomp.robot import model as jmodel
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp_torch import convert
from tpustomp_torch.costs import obstacle as tobst
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.sdf import AnalyticWorld as TWorld

Q_TOL = dict(atol=1e-5, rtol=1e-5)
M_ATOL = 1e-6

_WORLDS = {
    "spheres_boxes": dict(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))],
                          spheres=[((0.3, 0.3, 0.9), 0.1),
                                   ((1.2, -0.4, 0.0), 0.3)]),
    "boxes": dict(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
                         ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]),
    "empty": dict(),
}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _pair(robot_name, world_name):
    jr = getattr(jmodel, robot_name)()
    jw = JWorld.make(**_WORLDS[world_name])
    return (jr, jw, convert.robot_from_numpy(_fields(jr)),
            convert.world_from_numpy(_fields(jw)))


def _cands(C, T, d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, (C, T, d)).astype(np.float32)


@pytest.mark.parametrize("world_name", sorted(_WORLDS))
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_plain_matches_jax(robot_name, world_name):
    """C=24 (not a multiple of any tile), T=34: the plain evaluator against
    the JAX XLA path per candidate and the Pallas kernel in interpret mode."""
    jr, jw, robot, world = _pair(robot_name, world_name)
    T, C, dt, clearance = 34, 24, 0.05, 0.08
    cand = _cands(C, T, robot.num_joints, 0)
    q_obs, margin = tr.obstacle_cost_batch(robot, world,
                                           torch.from_numpy(cand), dt,
                                           clearance)
    assert q_obs.shape == (C, T) and margin.shape == (C,)
    q_k, m_k = rp.obstacle_cost_batch_pallas(jr, jw, jnp.asarray(cand), dt,
                                             clearance, interpret=True)
    np.testing.assert_allclose(q_obs.numpy(), np.asarray(q_k), **Q_TOL)
    np.testing.assert_allclose(margin.numpy(), np.asarray(m_k), atol=M_ATOL)
    q_ref, m_ref = jax.jit(jax.vmap(lambda x: jobst.obstacle_cost(
        jr, jw, x, dt, clearance)))(jnp.asarray(cand))
    np.testing.assert_allclose(q_obs.numpy(), np.asarray(q_ref), **Q_TOL)
    np.testing.assert_allclose(margin.numpy(), np.asarray(m_ref),
                               atol=M_ATOL)


def test_time_major_and_row_active_match_jax():
    """The time-major [d, T, C] input and a row_active mask: active rows
    equal the JAX kernel's (with its done-tile skip) on the same mask."""
    jr, jw, robot, world = _pair("arm_7dof", "boxes")
    T, C, dt, clearance = 20, 40, 5.0 / 19, 0.05
    cand = _cands(C, T, 7, 1)
    active = np.zeros(C, bool)
    active[3:17] = True
    active[29] = True
    q_t, m_t = tr.obstacle_cost_batch(
        robot, world, torch.from_numpy(cand).permute(2, 1, 0), dt, clearance,
        row_active=torch.from_numpy(active), time_major=True)
    q_k, m_k = rp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), dt, clearance, interpret=True,
        row_active=jnp.asarray(active))
    np.testing.assert_allclose(q_t.numpy()[active], np.asarray(q_k)[active],
                               **Q_TOL)
    np.testing.assert_allclose(m_t.numpy()[active], np.asarray(m_k)[active],
                               atol=M_ATOL)


def test_obstacle_cost_leading_axes():
    """costs/obstacle.obstacle_cost takes any leading batch axes."""
    robot = tmodel.arm_7dof()
    world = TWorld.make(**_WORLDS["boxes"])
    cand = torch.from_numpy(_cands(6, 12, 7, 2))
    q, m = tobst.obstacle_cost(robot, world, cand.reshape(2, 3, 12, 7),
                               0.05, 0.05)
    q1, m1 = tobst.obstacle_cost(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q.reshape(6, 12), q1, rtol=0, atol=0)
    torch.testing.assert_close(m.reshape(6), m1, rtol=0, atol=0)


def test_potential_and_velocity_match_jax():
    d = np.linspace(-0.2, 0.2, 41).astype(np.float32)
    np.testing.assert_allclose(
        tobst.potential(torch.from_numpy(d), 0.05).numpy(),
        np.asarray(jobst.potential(jnp.asarray(d), 0.05)), atol=1e-7)
    pos = np.random.default_rng(3).normal(size=(9, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tobst.workspace_velocity(torch.from_numpy(pos), 0.1).numpy(),
        np.asarray(jobst.workspace_velocity(jnp.asarray(pos), 0.1)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world_name", sorted(_WORLDS))
def test_pack_params_layout(world_name):
    """The packed parameter vector follows the layout documented in
    csrc/rollout_analytic.cu (the kernel reads it by offset)."""
    robot = tmodel.arm_7dof()
    world = TWorld.make(**_WORLDS[world_name])
    P = tr.pack_params(robot, world)
    d, nb = 7, robot.num_bodies
    ns, nx = world.sphere_radius.shape[0], world.box_half.shape[0]
    assert P.dtype == torch.float32
    assert P.numel() == 12 + 17 * d + 1 + 4 * nb + 4 * ns + 6 * nx
    torch.testing.assert_close(P[:9], robot.base_rot.reshape(9))
    j3 = P[12 + 16 * 3: 12 + 16 * 4]
    assert j3[0] == 0.0
    torch.testing.assert_close(j3[1:4], robot.joint_axis[3])
    torch.testing.assert_close(j3[4:7], robot.joint_offset[3])
    start = P[12 + 16 * d: 12 + 17 * d + 1].tolist()
    assert start == [0, 0, 0, 4, 4, 8, 8, 12]
    body = P[12 + 17 * d + 1:][:4 * nb].reshape(nb, 4)
    torch.testing.assert_close(body[:, 3], robot.body_radius)
    prims = P[12 + 17 * d + 1 + 4 * nb:]
    if nx:
        torch.testing.assert_close(prims[4 * ns:].reshape(nx, 6)[:, 3:],
                                   world.box_half)


def test_t_chunk_covers_trajectory():
    """The lane plan that replaced the per-thread waypoint chunks covers
    the trajectory, whatever the batch: n_slab slabs of ceil(T / n_slab)
    owned waypoints, none empty, the last reaching T; 1 to 16 candidates a
    block; the block's shared memory within budget for trajectories of a
    few hundred waypoints."""
    for C in (1, 56, 1000, 57344):
        for T in (2, 17, 102):
            for ee in (False, True):
                cpb, n = tr._plan(C, T, 7, ee)
                assert 1 <= cpb <= tr._MAX_CANDS
                slabs = [tr._slab(T, n, s) for s in range(n)]
                assert slabs[0][0] == 0 and slabs[-1][1] == T
                assert all(lo < hi for lo, hi, _, _ in slabs)
                assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
                assert (tr._smem_floats(0, 7, cpb, T, n, ee)
                        <= (tr._SMEM_BUDGET_EE if ee else tr._SMEM_BUDGET))

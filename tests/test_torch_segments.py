"""The evaluator kernels' segment plan (kernels/rollout.py ``_segments``).

On the card one warp walks one candidate over one segment of the waypoint
axis (csrc/rollout_common.cuh): lane l takes waypoint t0 - 1 + l, clamped
to the trajectory when its joint values are loaded; lanes 1..n_own own
their waypoint, lanes 0 and n_own + 1 are the halo whose body positions
the owners' central differences read through warp shuffles, and lanes past
the halo repeat its last row. Each segment writes its own row of
margin_part [n_seg, C], which the wrapper min-reduces.

A CUDA kernel cannot run here, so these tests replay that plan lane by
lane in plain PyTorch, on the wrapper's warp width and segment limit
(checked against the kernel source's), and hold it to the plain evaluator
and to the JAX package's obstacle cost. The lane mapping itself lives in
the CUDA code: the card tests at the segment edges
(tests/test_torch_cuda.py) hold the kernel to it. Tolerances as
tests/test_torch_rollout.py: q_obs atol 1e-5 / rtol 1e-5, margin atol
1e-6.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpustomp.costs.obstacle as jobst
from tpustomp.robot import model as jmodel
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp_torch import convert
from tpustomp_torch.costs.obstacle import potential
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.fk import body_positions_traj
from tpustomp_torch.world.sdf import sdf

WARP = tr._WARP
_TS = [2, 3, 17, 30, 31, 32, 33, 52, 60, 61, 102, 240]


def test_plan_constants_match_the_kernel():
    """The wrapper's warp width and segment limit are the kernel's
    (csrc/rollout_common.cuh kWarp, kSegMax: a halo lane on either side)."""
    src = (tr._CSRC / "rollout_common.cuh").read_text()
    assert int(re.search(r"constexpr int kWarp = (\d+);", src)[1]) == WARP
    assert re.search(r"constexpr int kSegMax = kWarp - 2;", src)
    assert tr._SEG_MAX == WARP - 2


def _lanes(T, seg_len, s):
    """Segment s as the kernel lays it on a warp: per lane the waypoint it
    stands for, the waypoint whose joint values it loads, and whether it
    owns its waypoint."""
    t0 = s * seg_len
    n_own = min(seg_len, T - t0)
    lane = np.arange(WARP)
    row = np.minimum(lane, n_own + 1)
    return (t0 - 1 + lane, np.clip(t0 - 1 + row, 0, T - 1),
            (lane >= 1) & (lane <= n_own))


@pytest.mark.parametrize("T", _TS)
def test_every_waypoint_owned_once(T):
    seg_len, n_seg = tr._segments(T)
    assert seg_len + 2 <= WARP and n_seg == -(-T // tr._SEG_MAX)
    owners = np.zeros(T, np.int64)
    for s in range(n_seg):
        t, loaded, own = _lanes(T, seg_len, s)
        assert np.array_equal(t[own], loaded[own])
        owners[t[own]] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize("T", _TS)
def test_halos_at_both_ends(T):
    """An owner's neighbour lanes load t - 1 and t + 1 wherever its speed
    reads them: both inside the trajectory, only t + 1 at t = 0 and only
    t - 1 at t = T - 1 (one-sided differences)."""
    seg_len, n_seg = tr._segments(T)
    for s in range(n_seg):
        t, loaded, own = _lanes(T, seg_len, s)
        for l in np.flatnonzero(own):
            if t[l] > 0:
                assert loaded[l - 1] == t[l] - 1
            if t[l] < T - 1:
                assert loaded[l + 1] == t[l] + 1
        first_t0 = s * seg_len
        assert t[0] == first_t0 - 1 and not own[0]
        assert not own[min(seg_len, T - first_t0) + 1]
    # the halo lanes outside the trajectory load its end waypoints
    t, loaded, _ = _lanes(T, seg_len, 0)
    assert t[0] == -1 and loaded[0] == 0
    t, loaded, own = _lanes(T, seg_len, n_seg - 1)
    last = np.flatnonzero(own)[-1]
    assert t[last] == T - 1 and t[last + 1] == T and loaded[last + 1] == T - 1


def _replay(robot, world, cand, dt, clearance):
    """The kernels' arithmetic on the segment plan: cand [C, T, d] ->
    (q_obs [C, T], margin_part [n_seg, C])."""
    C, T, _ = cand.shape
    seg_len, n_seg = tr._segments(T)
    radius = robot.body_radius
    q = torch.full((C, T), float("nan"))
    part = torch.empty(n_seg, C)
    for s in range(n_seg):
        t, loaded, own = _lanes(T, seg_len, s)
        x = body_positions_traj(robot, cand[:, loaded])      # [C, 32, B, 3]
        up = torch.cat([x[:, :1], x[:, :-1]], dim=1)         # lane l - 1
        down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)       # lane l + 1
        tt = torch.as_tensor(t)[None, :, None, None]
        v = torch.where(tt == 0, (down - x) * (1.0 / dt),
                        torch.where(tt == T - 1, (x - up) * (1.0 / dt),
                                    (down - up) * (1.0 / (2.0 * dt))))
        speed = torch.sqrt((v * v).sum(-1))
        dist = sdf(world, x)
        pot = potential(dist - radius - clearance, clearance) * speed
        acc = torch.zeros(C, WARP)
        for b in range(robot.num_bodies):                    # b = 0..nb-1
            acc = acc + pot[..., b]
        mask = torch.as_tensor(own)
        q[:, t[own]] = (acc * dt)[:, mask]
        part[s] = (dist - radius)[:, mask].amin(dim=(1, 2))
    return q, part


@pytest.mark.parametrize("T", [2, 17, 33, 52, 102])
def test_margin_parts_reduce_per_candidate(T):
    """Replaying the plan gives one cost per (candidate, waypoint) and one
    margin per candidate after the wrapper's min over segments, equal to
    the plain evaluator's and to the JAX package's obstacle cost."""
    jr = jmodel.arm_7dof()
    jw = JWorld.make(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
                            ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))],
                     spheres=[((0.3, 0.3, 0.9), 0.1)])
    robot = convert.robot_from_numpy(
        {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)})
    world = convert.world_from_numpy(
        {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)})
    C = 6
    cand = np.random.default_rng(T).uniform(-1.2, 1.2, (C, T, 7)).astype(
        np.float32)
    dt, clearance = 5.0 / (T - 1), 0.05
    q, part = _replay(robot, world, torch.from_numpy(cand), dt, clearance)
    assert part.shape == (tr._segments(T)[1], C)
    margin = part.amin(dim=0)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world,
                                            torch.from_numpy(cand), dt,
                                            clearance)
    torch.testing.assert_close(q, q_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(margin, m_p, atol=1e-6, rtol=0)
    q_j, m_j = jax.vmap(lambda x: jobst.obstacle_cost(
        jr, jw, x, dt, clearance))(jnp.asarray(cand))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(margin.numpy(), np.asarray(m_j), atol=1e-6)

"""The evaluator kernels' lane plan (kernels/rollout.py ``_plan``).

On the card (csrc/rollout_common.cuh) a block holds `cpb` consecutive
candidates and one slab of the waypoint axis. Its active candidates'
waypoints, with the slab's halo waypoints t_lo - 1 and t_hi where they
exist, are laid end to end, candidate-major: n_seq rows a candidate.
Warps take windows of that flat sequence: window k puts flat position
30k - 1 + l on lane l (clamped to the sequence), lanes 1..30 are its core,
and a core lane owns its waypoint when it lies in [t_lo, t_hi). The speed's
neighbours t - 1 and t + 1 are the adjacent lanes; t = 0 and t = T - 1
take one-sided differences toward their own candidate, so a candidate
boundary inside a window needs no halo. Each slab writes its own row of
margin_part [n_slab, C]; inactive candidates are zeros.

A CUDA kernel cannot run here, so these tests replay that plan lane by
lane in plain PyTorch, on the wrapper's constants (checked against the
kernel source's), and hold it to the plain evaluator and to the JAX
package's obstacle cost. The lane mapping itself lives in the CUDA code:
the card tests at the plan's edges (tests/test_torch_cuda.py) hold the
kernel to it. Tolerances as tests/test_torch_rollout.py: q_obs atol 1e-5 /
rtol 1e-5, margin atol 1e-6.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpustomp.costs.obstacle as jobst
from chip_compare import lane_fks
from tpustomp.robot import model as jmodel
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp_torch import convert
from tpustomp_torch.costs.obstacle import potential
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.fk import body_positions_traj
from tpustomp_torch.world.sdf import sdf

WARP, CORE = tr._WARP, tr._CORE
_TS = [2, 3, 17, 30, 31, 32, 33, 52, 60, 61, 102, 240]


def test_plan_constants_match_the_kernel():
    """The wrapper's warp width, warps a block, window core, candidates a
    block, staged row and parameter block are the kernel's
    (csrc/rollout_common.cuh)."""
    src = (tr._CSRC / "rollout_common.cuh").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src)[1]

    assert int(const("kWarp")) == WARP == 32
    assert int(const("kWarps")) == tr._WARPS
    assert const("kCore") == "kWarp - 2" and CORE == WARP - 2
    assert int(const("kMaxCands")) == tr._MAX_CANDS
    assert int(const("kRowFloats")) == tr._ROW_FLOATS
    assert int(const("kParamFloats")) == tr._PARAM_FLOATS


def _active(C, seed):
    """About a third of the candidates inactive, single ones and runs."""
    act = np.random.default_rng(seed).random(C) > 0.33
    act[:3] = [False, True, True]
    return act


def _plans(C, T):
    """The wrapper's plan, with and without ee, and plans it takes for
    other batches: 1, 7, 8 and 16 candidates a block, and slabs of the
    waypoint axis (consistent: n_slab slabs of ceil(T / n_slab), none
    empty)."""
    out = {tr._plan(C, T, 7), tr._plan(C, T, 7, ee=True), (8, 1), (1, 1),
           (7, 1), (tr._MAX_CANDS, 1)}
    for n in (2, 3):
        if n <= T:
            L = -(-T // n)
            out.add((4, -(-T // L)))
    return sorted(out)


def _windows(C, T, active, cpb, n_slab):
    """The lanes of every window of the plan, as the kernel lays them:
    (slab, candidate, waypoint, owns) arrays of [n_windows, 32]."""
    lane = np.arange(WARP)
    out = []
    for b in range(-(-C // cpb)):
        c0 = b * cpb
        slots = [cc for cc in range(min(cpb, C - c0)) if active[c0 + cc]]
        for s in range(n_slab):
            t_lo, t_hi, a, n_seq = tr._slab(T, n_slab, s)
            n_pairs = len(slots) * n_seq
            for w in range(-(-n_pairs // CORE)):
                f = w * CORE - 1 + lane
                fc = np.clip(f, 0, n_pairs - 1)
                i, r = fc // n_seq, fc % n_seq
                t = a + r
                own = ((lane >= 1) & (lane <= CORE) & (f < n_pairs)
                       & (t >= t_lo) & (t < t_hi))
                out.append((np.full(WARP, s), c0 + np.asarray(slots)[i], t,
                            own))
    return [np.stack(x) for x in zip(*out)] if out else [np.zeros((0, WARP),
                                                                  int)] * 4


@pytest.mark.parametrize("T", _TS)
def test_every_waypoint_owned_once(T):
    """Every (active candidate, waypoint) has exactly one owning lane, every
    inactive candidate none, in every plan; the lanes are chip_compare.py
    lane_fks's count (its issue-rate figure's)."""
    C = 21
    active = _active(C, T)
    for cpb, n_slab in _plans(C, T):
        assert 1 <= cpb <= tr._MAX_CANDS
        slab, cand, t, own = _windows(C, T, active, cpb, n_slab)
        owners = np.zeros((C, T), np.int64)
        np.add.at(owners, (cand[own], t[own]), 1)
        assert (owners[active] == 1).all() and (owners[~active] == 0).all()
        # an owner's waypoint lies in its slab
        lo = np.array([tr._slab(T, n_slab, s)[0] for s in range(n_slab)])
        hi = np.array([tr._slab(T, n_slab, s)[1] for s in range(n_slab)])
        assert ((t[own] >= lo[slab[own]]) & (t[own] < hi[slab[own]])).all()
        if (cpb, n_slab) == tr._plan(C, T, 7):
            assert lane_fks(tr, C, T, active=active) == cand.size


@pytest.mark.parametrize("T", _TS)
def test_halos_at_both_ends(T):
    """An owner's neighbour lanes hold t - 1 and t + 1 of its own candidate
    wherever its speed reads them: both inside the trajectory, only t + 1
    at t = 0 and only t - 1 at t = T - 1 (one-sided differences), across
    candidate boundaries inside a window and at slab edges."""
    C = 21
    active = _active(C, T + 1)
    for cpb, n_slab in _plans(C, T):
        _, cand, t, own = _windows(C, T, active, cpb, n_slab)
        w, l = np.nonzero(own)
        assert ((l >= 1) & (l <= CORE)).all()
        inner = t[w, l] > 0
        assert (cand[w, l - 1][inner] == cand[w, l][inner]).all()
        assert (t[w, l - 1][inner] == t[w, l][inner] - 1).all()
        inner = t[w, l] < T - 1
        assert (cand[w, l + 1][inner] == cand[w, l][inner]).all()
        assert (t[w, l + 1][inner] == t[w, l][inner] + 1).all()
        # both ends occur and are owned
        assert (t[own] == 0).any() and (t[own] == T - 1).any()


def _replay(robot, world, cand, active, dt, clearance, cpb, n_slab):
    """The kernels' arithmetic on the lane plan: cand [C, T, d] ->
    (q_obs [C, T], margin_part [n_slab, C]); inactive candidates zeros."""
    C, T, _ = cand.shape
    radius = robot.body_radius
    q = torch.zeros(C, T)
    part = torch.zeros(n_slab, C)
    slab, cc, t, own = _windows(C, T, active, cpb, n_slab)
    x = body_positions_traj(robot, cand[cc, t])              # [W, 32, B, 3]
    up = torch.cat([x[:, :1], x[:, :-1]], dim=1)             # lane l - 1
    down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)           # lane l + 1
    tt = torch.as_tensor(t)[..., None, None]
    v = torch.where(tt == 0, (down - x) * (1.0 / dt),
                    torch.where(tt == T - 1, (x - up) * (1.0 / dt),
                                (down - up) * (1.0 / (2.0 * dt))))
    speed = torch.sqrt((v * v).sum(-1))
    dist = sdf(world, x)
    pot = potential(dist - radius - clearance, clearance) * speed
    acc = torch.zeros(x.shape[:2])
    for b in range(robot.num_bodies):                        # b = 0..nb-1
        acc = acc + pot[..., b]
    mask = torch.as_tensor(own)
    q[cc[own], t[own]] = (acc * dt)[mask]
    lane_margin = (dist - radius).amin(dim=-1)[mask]
    part.fill_(float("inf"))
    part.view(-1).scatter_reduce_(
        0, torch.as_tensor(slab[own] * C + cc[own]), lane_margin, "amin")
    part[:, ~torch.as_tensor(active)] = 0.0
    return q, part


def _arm_and_world():
    jr = jmodel.arm_7dof()
    jw = JWorld.make(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
                            ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))],
                     spheres=[((0.3, 0.3, 0.9), 0.1)])
    robot = convert.robot_from_numpy(
        {f.name: getattr(jr, f.name) for f in dataclasses.fields(jr)})
    world = convert.world_from_numpy(
        {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)})
    return jr, jw, robot, world


@pytest.mark.parametrize("T", [2, 17, 33, 52, 102])
def test_margin_parts_reduce_per_candidate(T):
    """Replaying the plan (the wrapper's, and one with slabs) gives one
    cost per (candidate, waypoint) and one margin per candidate after the
    wrapper's min over slabs, equal to the plain evaluator's and to the JAX
    package's obstacle cost on active candidates, and zeros on inactive
    ones."""
    jr, jw, robot, world = _arm_and_world()
    C = 6
    cand = np.random.default_rng(T).uniform(-1.2, 1.2, (C, T, 7)).astype(
        np.float32)
    active = np.array([True, False, True, True, False, True])
    dt, clearance = 5.0 / (T - 1), 0.05
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world,
                                            torch.from_numpy(cand), dt,
                                            clearance)
    q_j, m_j = jax.vmap(lambda x: jobst.obstacle_cost(
        jr, jw, x, dt, clearance))(jnp.asarray(cand))
    plans = {tr._plan(C, T, 7), (4, min(T, 2) if T > 2 else 1)}
    for cpb, n_slab in plans:
        q, part = _replay(robot, world, torch.from_numpy(cand), active, dt,
                          clearance, cpb, n_slab)
        assert part.shape == (n_slab, C)
        margin = part.amin(dim=0)
        act = torch.as_tensor(active)
        torch.testing.assert_close(q[act], q_p[act], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(margin[act], m_p[act], atol=1e-6, rtol=0)
        assert bool((q[~act] == 0).all()) and bool((margin[~act] == 0).all())
        np.testing.assert_allclose(q[act].numpy(), np.asarray(q_j)[active],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(margin[act].numpy(),
                                   np.asarray(m_j)[active], atol=1e-6)

"""The port's evaluator over worlds with a row axis (one set of spheres and
boxes per candidate or per scenario: batched MPC's per-scenario worlds)
against the JAX package.

On the CPU the wrapper runs the plain PyTorch version, held here to the JAX
Pallas kernels in interpret mode: K3 with ``per_cand_world=True`` for
analytic worlds, and K5 + ``_grid_finish``'s per_cand branch for a
CompositeWorld whose overlay has a candidate axis. Tolerances: q_obs atol
2e-6, margin atol 1e-6 (the same float32 arithmetic; the kernels in
interpret mode reassociate the FK products). The grouped form (world rows
plus cands_per_row) must equal the expanded per-candidate form bitwise.
The CUDA variants are held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpustomp.kernels.rollout_pallas as rp
from tpustomp.robot import model as jmodel
from tpustomp.world import edt as jedt
from tpustomp.world import sdf as jsdf
from tpustomp_torch import convert
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.world import sdf as tsdf

Q_ATOL, M_ATOL = 2e-6, 1e-6
_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _row_world(R, families, seed):
    """Numpy leaves of a world with R rows: random spheres and boxes (a
    family left out has zero members, [R, 0, ...])."""
    rng = np.random.default_rng(seed)
    ns = 2 if "spheres" in families else 0
    nx = 2 if "boxes" in families else 0
    return dict(
        sphere_center=rng.uniform(-0.8, 0.8, (R, ns, 3)).astype(np.float32),
        sphere_radius=rng.uniform(0.05, 0.3, (R, ns)).astype(np.float32),
        box_center=rng.uniform(-0.8, 0.8, (R, nx, 3)).astype(np.float32),
        box_half=rng.uniform(0.05, 0.4, (R, nx, 3)).astype(np.float32))


def _cands(C, T, d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, (C, T, d)).astype(np.float32)


def _robots(name):
    jr = getattr(jmodel, name)()
    return jr, convert.robot_from_numpy(_fields(jr))


def _grid():
    """(JAX GridSDF, port GridSDF): the tabletop voxelized coarsely."""
    origin, shape, res = (-0.2, -1.0, 0.0), (24, 30, 18), 0.0625
    occ = jedt.occupancy_from_analytic(jsdf.AnalyticWorld.make(boxes=_BOXES),
                                       origin, shape, res)
    jg = jedt.signed_edt(occ, res, origin)
    return jg, convert.grid_from_numpy(_fields(jg))


def _check(q, m, q_ref, m_ref, rows=slice(None)):
    np.testing.assert_allclose(q.numpy()[rows], np.asarray(q_ref)[rows],
                               atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy()[rows], np.asarray(m_ref)[rows],
                               atol=M_ATOL, rtol=0)


@pytest.mark.parametrize("families", [("spheres", "boxes"), ("spheres",),
                                      ("boxes",), ()])
def test_per_candidate_analytic_matches_jax(families):
    """Every candidate against its own primitives (arm_7dof, C=24, T=16),
    with an empty sphere or box family (the JAX wrapper's far-away
    sentinels; the port skips the empty loop: both start at 1e6)."""
    jr, robot = _robots("arm_7dof")
    C, T, dt, clearance = 24, 16, 0.05, 0.08
    leaves = _row_world(C, families, 3)
    cand = _cands(C, T, 7, 0)
    world = convert.world_from_numpy(leaves)
    assert tsdf.world_rows(world) == C
    q, m = tr.obstacle_cost_batch(robot, world, torch.from_numpy(cand), dt,
                                  clearance)
    ref = rp.obstacle_cost_batch_pallas(
        jr, jsdf.AnalyticWorld(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()}),
        jnp.asarray(cand), dt, clearance, interpret=True)
    _check(q, m, *ref)
    if not families:                           # nothing in the world
        np.testing.assert_array_equal(q.numpy(), 0.0)
        np.testing.assert_allclose(m.numpy(), 1e6 - 0.08, rtol=1e-6)


def test_per_candidate_row_active_time_major_matches_jax():
    """The time-major input with a row_active mask over a per-candidate
    world (the batched MPC step's call): active rows equal the JAX kernel's
    with the same mask (its per-128-tile skip computes them all)."""
    jr, robot = _robots("arm_7dof")
    C, T, dt, clearance = 40, 22, 0.05, 0.05
    leaves = _row_world(C, ("spheres", "boxes"), 5)
    cand = _cands(C, T, 7, 1)
    active = np.zeros(C, bool)
    active[3:17] = True
    active[29] = True
    q, m = tr.obstacle_cost_batch(
        robot, convert.world_from_numpy(leaves),
        torch.from_numpy(cand).permute(2, 1, 0), dt, clearance,
        row_active=torch.from_numpy(active), time_major=True)
    ref = rp.obstacle_cost_batch_pallas(
        jr, jsdf.AnalyticWorld(**{k: jnp.asarray(v)
                                  for k, v in leaves.items()}),
        jnp.asarray(cand), dt, clearance, interpret=True,
        row_active=jnp.asarray(active))
    _check(q, m, *ref, rows=active)


@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_per_candidate_overlay_matches_jax(robot_name):
    """A CompositeWorld whose overlay has a candidate axis: K5 +
    _grid_finish's per_cand branch in interpret mode (C=24 pads to the
    tile there; the port masks nothing and pads nothing)."""
    jr, robot = _robots(robot_name)
    jg, tg = _grid()
    C, T, dt, clearance = 24, 16, 0.05, 0.08
    leaves = _row_world(C, ("spheres",), 7)
    cand = _cands(C, T, robot.num_joints, 2)
    world = tsdf.CompositeWorld(grid=tg,
                                overlay=convert.world_from_numpy(leaves))
    q, m = tr.obstacle_cost_batch(robot, world, torch.from_numpy(cand), dt,
                                  clearance)
    jw = jsdf.CompositeWorld(
        grid=jg, overlay=jsdf.AnalyticWorld(**{k: jnp.asarray(v)
                                               for k, v in leaves.items()}))
    _check(q, m, *rp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), dt, clearance, interpret=True))
    assert float(q.abs().max()) > 0.1          # the world is in the way


@pytest.mark.parametrize("kind", ["analytic", "composite"])
def test_grouped_rows_equal_expanded_bitwise(kind):
    """World rows plus cands_per_row (the solver's form: candidate c reads
    row c // cands_per_row) equal the per-candidate form with every row
    repeated, bit for bit, in both layouts."""
    _, robot = _robots("arm_7dof")
    R, per, T = 4, 6, 18
    rows = convert.world_from_numpy(_row_world(R, ("spheres", "boxes"), 9))
    expanded = tsdf.AnalyticWorld(**{
        f: getattr(rows, f).repeat_interleave(per, dim=0)
        for f in tsdf.AnalyticWorld.__dataclass_fields__})
    if kind == "composite":
        _, tg = _grid()
        rows = tsdf.CompositeWorld(grid=tg, overlay=rows)
        expanded = tsdf.CompositeWorld(grid=tg, overlay=expanded)
    cand = torch.from_numpy(_cands(R * per, T, 7, 4))
    q_g, m_g = tr.obstacle_cost_batch(robot, rows, cand, 0.05, 0.05,
                                      cands_per_row=per)
    q_e, m_e = tr.obstacle_cost_batch(robot, expanded, cand, 0.05, 0.05)
    torch.testing.assert_close(q_g, q_e, rtol=0, atol=0)
    torch.testing.assert_close(m_g, m_e, rtol=0, atol=0)
    tm = cand.permute(2, 1, 0)
    q_t, m_t = tr.obstacle_cost_batch(robot, rows, tm, 0.05, 0.05,
                                      time_major=True, cands_per_row=per)
    torch.testing.assert_close(q_t, q_e, rtol=0, atol=0)
    torch.testing.assert_close(m_t, m_e, rtol=0, atol=0)


def test_row_worlds_pack_robot_only_and_refuse_mismatch():
    """A row world's primitives are not packed into the parameters (the
    kernels read them as [R, S, 4] / [R, X, 6] arrays); a composite keeps
    its grid's origin and resolution. Rows that do not tile the candidates,
    cands_per_row on a shared world, and leaves that disagree raise."""
    _, robot = _robots("arm_7dof")
    base = 12 + 17 * 7 + 1 + 4 * robot.num_bodies
    rows = convert.world_from_numpy(_row_world(3, ("spheres", "boxes"), 1))
    assert tr.pack_params(robot, rows).numel() == base
    _, tg = _grid()
    P = tr.pack_params(robot, tsdf.CompositeWorld(grid=tg, overlay=rows))
    assert P.numel() == base + 4
    torch.testing.assert_close(P[-4:-1], tg.origin)
    spheres, boxes = tr._prim_arrays(rows)
    assert spheres.shape == (3, 2, 4) and boxes.shape == (3, 2, 6)
    torch.testing.assert_close(spheres[..., 3], rows.sphere_radius)
    torch.testing.assert_close(boxes[..., 3:], rows.box_half)

    cand = torch.from_numpy(_cands(6, 5, 7, 0))
    with pytest.raises(ValueError, match="3 rows"):
        tr.obstacle_cost_batch(robot, rows, cand, 0.05, 0.05)
    with pytest.raises(ValueError, match="3 rows"):
        tr.obstacle_cost_batch(robot, rows, cand, 0.05, 0.05,
                               cands_per_row=3)
    shared = tsdf.AnalyticWorld.make(boxes=_BOXES)
    with pytest.raises(ValueError, match="shared"):
        tr.obstacle_cost_batch(robot, shared, cand, 0.05, 0.05,
                               cands_per_row=2)
    bad = dataclasses.replace(rows, box_half=rows.box_half[:2])
    with pytest.raises(ValueError, match="row axis"):
        tr.obstacle_cost_batch(robot, bad, cand, 0.05, 0.05,
                               cands_per_row=2)

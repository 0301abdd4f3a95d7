"""The port's evaluator over voxel worlds (GridSDF, CompositeWorld) and for
robots whose bodies are not link-sorted, against the JAX package.

On the CPU the wrapper runs the plain PyTorch version, held here to the JAX
Pallas kernels in interpret mode — K5 (``build_unrolled_kernel(mode="kin")``)
with its XLA tail ``_grid_finish``; K1/K2 (the rolled kernels) for robots
with ``body_counts=None`` — and to the XLA cost path. Tolerances as for
the analytic evaluator (tests/test_torch_rollout.py): q_obs atol 1e-5 /
rtol 1e-5, margin atol 1e-6.

The wrapper's own work for the CUDA kernels (the packed parameters with
their grid section, the body sort, refusals, the build hash) is checked
here too; the kernels themselves are held to the plain version on the card
by tests/test_torch_cuda.py.
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
from tpustomp.world import edt as jedt
from tpustomp.world import sdf as jsdf
from tpustomp_torch import convert
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world import sdf as tsdf

Q_TOL = dict(atol=1e-5, rtol=1e-5)
M_ATOL = 1e-6
_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]
_SPHERE = [((0.35, 0.3, 0.55), 0.12)]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _worlds(kind):
    """(JAX world, port world) over the voxelized tabletop."""
    origin, shape, res = (-0.2, -1.0, 0.0), (24, 30, 18), 0.0625
    occ = jedt.occupancy_from_analytic(jsdf.AnalyticWorld.make(boxes=_BOXES),
                                       origin, shape, res)
    jg = jedt.signed_edt(occ, res, origin)
    if kind == "grid":
        return jg, convert.grid_from_numpy(_fields(jg))
    if kind == "analytic":
        jw = jsdf.AnalyticWorld.make(spheres=_SPHERE, boxes=_BOXES)
        return jw, convert.world_from_numpy(_fields(jw))
    jw = jsdf.CompositeWorld.make(jg, spheres=_SPHERE)
    return jw, convert.composite_from_numpy(_fields(jw.grid),
                                            _fields(jw.overlay))


def _cands(C, T, d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, (C, T, d)).astype(np.float32)


def _shuffled(jr, seed):
    """The JAX robot with its bodies in a random order and no body_counts
    (the rolled kernels' case)."""
    perm = np.random.default_rng(seed).permutation(jr.body_link.shape[0])
    return jr.replace(body_link=jr.body_link[perm],
                      body_offset=jr.body_offset[perm],
                      body_radius=jr.body_radius[perm], body_counts=None)


def _check(q, m, q_ref, m_ref, rows=slice(None)):
    np.testing.assert_allclose(q.numpy()[rows], np.asarray(q_ref)[rows],
                               **Q_TOL)
    np.testing.assert_allclose(m.numpy()[rows], np.asarray(m_ref)[rows],
                               atol=M_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["grid", "composite"])
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r"])
def test_plain_matches_jax_grid(robot_name, kind):
    """C=24 (not a multiple of any tile), T=34: the plain evaluator against
    K5 + _grid_finish in interpret mode and the XLA path per candidate.
    planar_2r moves in the z=0 plane, the grid's lower face: every sample
    clamps there."""
    jr = getattr(jmodel, robot_name)()
    robot = convert.robot_from_numpy(_fields(jr))
    jw, world = _worlds(kind)
    T, C, dt, clearance = 34, 24, 0.05, 0.08
    cand = _cands(C, T, robot.num_joints, 0)
    q, m = tr.obstacle_cost_batch(robot, world, torch.from_numpy(cand), dt,
                                  clearance)
    assert q.shape == (C, T) and m.shape == (C,)
    assert float(q.abs().max()) > 0.1          # the world is in the way
    _check(q, m, *rp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), dt, clearance, interpret=True))
    _check(q, m, *jax.jit(jax.vmap(lambda x: jobst.obstacle_cost(
        jr, jw, x, dt, clearance)))(jnp.asarray(cand)))


@pytest.mark.parametrize("kind", ["grid", "composite"])
def test_time_major_and_row_active_match_jax_grid(kind):
    """The time-major [d, T, C] input with a row_active mask: active rows
    equal the JAX kernel's on the same mask (its grid path ignores it)."""
    jr = jmodel.arm_7dof()
    robot = convert.robot_from_numpy(_fields(jr))
    jw, world = _worlds(kind)
    T, C, dt, clearance = 20, 40, 5.0 / 19, 0.05
    cand = _cands(C, T, 7, 1)
    active = np.zeros(C, bool)
    active[3:17] = True
    active[29] = True
    q, m = tr.obstacle_cost_batch(
        robot, world, torch.from_numpy(cand).permute(2, 1, 0), dt, clearance,
        row_active=torch.from_numpy(active), time_major=True)
    _check(q, m, *rp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), dt, clearance, interpret=True,
        row_active=jnp.asarray(active)), rows=active)


@pytest.mark.parametrize("kind", ["analytic", "grid"])
def test_unsorted_bodies_match_jax_rolled(kind):
    """A robot with body_counts=None and shuffled bodies against the JAX
    rolled kernels in interpret mode: K1 (analytic) and K2 (grid)."""
    jr = _shuffled(jmodel.arm_7dof(), 4)
    robot = convert.robot_from_numpy(_fields(jr))
    assert robot.body_counts is None
    assert not bool((robot.body_link[1:] >= robot.body_link[:-1]).all())
    jw, world = _worlds(kind)
    T, C, dt, clearance = 26, 24, 0.05, 0.08
    cand = _cands(C, T, 7, 5)
    q, m = tr.obstacle_cost_batch(robot, world, torch.from_numpy(cand), dt,
                                  clearance)
    _check(q, m, *rp.obstacle_cost_batch_pallas(
        jr, jw, jnp.asarray(cand), dt, clearance, interpret=True))


def test_pack_params_sorts_unsorted_bodies():
    """The kernels read link-sorted bodies: a shuffled robot packs to the
    same vector as the same robot stable-sorted by link on the host."""
    jr = _shuffled(jmodel.arm_7dof(), 0)
    shuffled = convert.robot_from_numpy(_fields(jr))
    link = np.asarray(jr.body_link)
    order = torch.from_numpy(np.argsort(link, kind="stable"))
    resorted = dataclasses.replace(
        shuffled, body_link=shuffled.body_link[order],
        body_offset=shuffled.body_offset[order],
        body_radius=shuffled.body_radius[order],
        body_counts=tuple(np.bincount(link, minlength=7).tolist()))
    for kind in ("analytic", "grid"):
        _, world = _worlds(kind)
        torch.testing.assert_close(tr.pack_params(shuffled, world),
                                   tr.pack_params(resorted, world),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["grid", "composite"])
def test_pack_params_grid_layout(kind):
    """Grid worlds: the overlay's primitives (none for a GridSDF), then the
    grid origin and resolution (csrc/rollout_common.cuh)."""
    robot = tmodel.arm_7dof()
    _, world = _worlds(kind)
    P = tr.pack_params(robot, world)
    ns = 1 if kind == "composite" else 0
    base = 12 + 17 * 7 + 1 + 4 * robot.num_bodies
    assert P.numel() == base + 4 * ns + 4
    grid = world.grid if kind == "composite" else world
    torch.testing.assert_close(P[-4:-1], grid.origin)
    assert float(P[-1]) == float(grid.resolution)
    if ns:
        torch.testing.assert_close(P[base:base + 4],
                                   torch.tensor([0.35, 0.3, 0.55, 0.12]))


def test_wrapper_refuses_unsupported_grids():
    robot = tmodel.arm_7dof()
    cand = torch.from_numpy(_cands(4, 6, 7, 0))
    flat = tsdf.GridSDF.make(np.zeros((5, 1, 4)), (0, 0, 0), 0.1)
    with pytest.raises(ValueError, match=">= 2"):
        tr.obstacle_cost_batch(robot, flat, cand, 0.05, 0.05)
    _, grid = _worlds("grid")
    over = tsdf.AnalyticWorld(
        sphere_center=torch.zeros(3, 1, 3), sphere_radius=torch.ones(3, 1),
        box_center=torch.zeros(3, 0, 3), box_half=torch.zeros(3, 0, 3))
    with pytest.raises(ValueError, match="3 rows"):    # 3 rows, 4 candidates
        tr.obstacle_cost_batch(robot, tsdf.CompositeWorld(grid, over), cand,
                               0.05, 0.05)
    with pytest.raises(ValueError, match="grid tensors are on meta"):
        tr.obstacle_cost_batch(robot, grid.to("meta"), cand, 0.05, 0.05)
    with pytest.raises(NotImplementedError, match="GridSDF"):
        tr.obstacle_cost_batch(robot, object(), cand, 0.05, 0.05)


def test_packed_table_as_the_grid_kernel_reads_it():
    """The packed corner table the grid kernel reads as two float4 per
    sample: row base holds c000 c001 c010 c011 | c100 c101 c110 c111 of the
    dense grid (dz fastest), equal to the JAX package's table; 32-byte
    aligned rows (a misaligned view is copied); None for pack=False (the
    kernel then reads the dense grid); a misshapen table is refused."""
    g = np.random.default_rng(4).normal(size=(5, 6, 4)).astype(np.float32)
    grid = tsdf.GridSDF.make(g, (0.1, -0.2, 0.0), 0.05)
    dense = grid.grid.contiguous()
    table = tr._packed_table(grid, dense)
    assert table.dtype == torch.float32 and table.shape == (120, 8)
    assert table.is_contiguous() and table.data_ptr() % 32 == 0
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jsdf.GridSDF.make(
            jnp.asarray(g), jnp.zeros(3), 0.05).packed))
    x, y, z = 2, 3, 1
    corners = [g[x + dx, y + dy, z + dz]
               for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    np.testing.assert_array_equal(table[(x * 6 + y) * 4 + z].numpy(),
                                  corners)
    flat = torch.empty(120 * 8 + 1)[1:].view(120, 8)
    flat.copy_(grid.packed)
    moved = tr._packed_table(dataclasses.replace(grid, packed=flat), dense)
    assert moved.data_ptr() % 32 == 0 and torch.equal(moved, grid.packed)
    assert tr._packed_table(dataclasses.replace(grid, packed=None),
                            dense) is None
    with pytest.raises(ValueError, match=r"\[120, 8\]"):
        tr._packed_table(dataclasses.replace(grid, packed=grid.packed[:-1]),
                         dense)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Each kernel library's name hashes its .cu and every csrc header it
    includes: an edited header gets a new build."""
    for name in tr._SOURCES:
        srcs = {p.name for p in tr._sources(name)}
        assert srcs == {f"{name}.cu", "rollout_common.cuh"}, srcs
    for src in tr._CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(tr, "_CSRC", tmp_path)
    before = {n: tr._lib_path(n) for n in tr._SOURCES}
    header = tmp_path / "rollout_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for n in tr._SOURCES:
        assert tr._lib_path(n) != before[n]
    assert tr._lib_path("rollout_grid") != tr._lib_path("rollout_analytic")


def test_reset_launches():
    tr.LAUNCHES["rollout_grid"] += 2
    tr.LAUNCHES["rollout_analytic:per_cand_world"] += 1
    tr.LAUNCHES["rollout_grid:ee"] += 1
    tr.LAUNCHES["rollout_analytic:runtime"] += 1
    tr.LAUNCHES["rollout_grid:per_cand_overlay:runtime:ee"] += 1
    tr.LAUNCHES["rollout_analytic:con"] += 1
    tr.LAUNCHES["rollout_grid:per_cand_overlay:runtime:con"] += 1
    tr.LAYOUTS["candidate_major"] += 1
    tr.reset_launches()
    assert tr.LAYOUTS == {"time_major": 0, "candidate_major": 0}
    # each variant counts its launches on the static and on the runtime
    # chain, without an extra output, with the ee output and on the
    # constraint route, apart
    variants = ("rollout_analytic", "rollout_grid",
                "rollout_analytic:per_cand_world",
                "rollout_grid:per_cand_overlay")
    assert tr.LAUNCHES == {v + chain + form: 0 for v in variants
                           for chain in ("", ":runtime")
                           for form in ("", ":ee", ":con")}
    # every variant is an entry point of one of the two sources
    assert {src for src, _, _ in tr._ENTRIES.values()} == set(tr._SOURCES)

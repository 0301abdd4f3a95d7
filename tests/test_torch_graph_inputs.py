"""The world, the constraints and the goal band as inputs of the port's
compiled solve (tpustomp_torch/engine/graph.py), on the CPU.

JAX compiles a solve once per shape: the world's and the constraints'
values are operands of the jitted program, so new values of the same
shapes run it again. The port keys a graph the same way (the robot by
identity, the world and the constraints by type and shapes) and loads
their values into the graph's copies at each call. Each case runs on one
cache entry, captures nothing after its first call, and gives bitwise the
eager loop's result on the same inputs and generator; every edit lies where
the trajectories pass, so a graph still reading the old values fails.
The edited-grid solve stays within test_torch_plan's tolerance of the JAX
package's plan_batch on JAX's IncrementalSDF with the same edits.

Graphs are emulated as tests/test_torch_graph.py says (`emulated`): a
replay runs the region's host code again over the graph's copies. The
rewrite of a captured node's parameter block is the card's
(tests/test_torch_cuda.py, chip_smoke.py's [graph_inputs:*] lines).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tpustomp.api import plan as jplan
from tpustomp.api.problem import ProblemSpec as JProblem
from tpustomp.world import edt as jedt
from tests.test_torch_graph import _assert_same, _emulate, _gen
from tests.test_torch_plan import _assert_solutions
from tests.test_torch_solver import (_BOXES, _ReplayJaxNoise, _configs,
                                     _jitter, _scene)
import tpustomp_torch.api.plan as tplan
from tpustomp_torch import (OrientationConstraint, PlannerConfig,
                            ProblemSpec, plan_batch, plan_timed)
from tpustomp_torch._tensors import clone_with_mirrors
from tpustomp_torch.api.config import NoiseConfig
from tpustomp_torch.engine import graph, mpc
from tpustomp_torch.kernels import graph_node
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.fk import body_positions
from tpustomp_torch.robot.model import arm_7dof, planar_2r
from tpustomp_torch.world.edt import IncrementalSDF, occupancy_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld

ORIGIN, SHAPE, RES = (-0.2, -0.9, -0.1), (24, 28, 20), 0.06
CFG = PlannerConfig(num_timesteps=16, num_rollouts=6, max_iterations=6,
                    noise=NoiseConfig(stddev=0.2, decay=0.95,
                                      num_rollouts_reused=2))


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def emulated(monkeypatch):
    _emulate(monkeypatch)
    graph.clear()
    graph.reset_counts()
    yield
    graph.clear()


def _occupancy():
    return occupancy_from_analytic(AnalyticWorld.make(boxes=_BOXES), ORIGIN,
                                   SHAPE, RES)


def _problem(B=3, seed=0):
    return ProblemSpec(*_jitter(B, seed))


# arm_7dof's body on the forearm the edits are put on (inside the grid
# along the scene's trajectories)
BODY = 6
# where it passes at mid-trajectory on the first plan of _problem()
MID = (0.64, 0.04, 0.94)


def _voxel(robot, sol, t, row=0):
    """The voxel of BODY of row `row` at waypoint t."""
    p = body_positions(robot, sol.trajectory[row, t])[BODY].numpy()
    return np.floor((p - np.asarray(ORIGIN)) / RES + 0.5).astype(np.int64)


def _points(robot, sol, t, row=1):
    """A point cloud around BODY of row `row` at waypoint t."""
    p = body_positions(robot, sol.trajectory[row, t])[BODY].numpy()
    return p + np.random.default_rng(3).uniform(
        -0.05, 0.05, (40, 3)).astype(np.float32)


def _edits(robot, inc, sol):
    """Two edits on the first solution's path: a box around BODY at
    mid-trajectory (set_box), and a point cloud at a third of it
    (add_points)."""
    mid = _voxel(robot, sol, CFG.num_timesteps // 2)
    pts = _points(robot, sol, CFG.num_timesteps // 3)
    return (lambda: inc.set_box(mid - 1, mid + 2, True),
            lambda: inc.add_points(pts))


def _plan(robot, world, prob, **kw):
    return plan_batch(robot, world, prob, CFG, device="cpu",
                      generator=_gen(), **kw)


def _eager(fn):
    with graph.eager():
        return fn()


def _same_entry(first_captured):
    assert graph.GRAPHS["captured"] == first_captured
    assert graph.GRAPHS["invalidated"] == 0
    assert len(graph.cached()) == 1


def test_edited_incremental_sdf_replays_one_entry(emulated):
    """plan, set_box, plan, add_points, plan on one IncrementalSDF: one
    entry, no capture after the first call, each result bitwise the eager
    loop's on that world; the edits move the result."""
    robot, prob = arm_7dof(), _problem()
    inc = IncrementalSDF(_occupancy(), ORIGIN, RES, max_distance=0.3,
                         device="cpu")
    first = _plan(robot, inc.as_world(), prob)
    captured = graph.GRAPHS["captured"]
    assert captured == 3
    sols = [first]
    for edit in _edits(robot, inc, first):
        edit()
        world = inc.as_world()
        loaded = graph.GRAPHS["inputs_loaded"]
        got = _plan(robot, world, prob)
        _same_entry(captured)
        assert graph.GRAPHS["inputs_loaded"] - loaded == 2   # grid, table
        _assert_same(got, _eager(lambda w=world: _plan(robot, w, prob)))
        sols.append(got)
    for a, b in zip(sols, sols[1:]):
        assert not torch.equal(a.cost, b.cost)
    # the world of the last call again: nothing to load
    loaded = graph.GRAPHS["inputs_loaded"]
    _assert_same(_plan(robot, inc.as_world(), prob), sols[-1])
    assert graph.GRAPHS["inputs_loaded"] == loaded


def test_earlier_world_after_a_later_edit_gives_its_own_result(emulated):
    """A world taken from as_world() before an edit, solved after a solve
    of the edited world, is loaded again: its own result."""
    robot, prob = arm_7dof(), _problem()
    inc = IncrementalSDF(_occupancy(), ORIGIN, RES, max_distance=0.3,
                         device="cpu")
    before = inc.as_world()
    ref = _plan(robot, before, prob)
    _edits(robot, inc, ref)[0]()
    after = _plan(robot, inc.as_world(), prob)
    assert not torch.equal(after.cost, ref.cost)
    _assert_same(_plan(robot, before, prob), ref)
    _same_entry(3)


def test_edited_grid_matches_jax_incremental_sdf(emulated):
    """The same edits on JAX's IncrementalSDF through JAX's plan_batch
    (Pallas in interpret mode) and the replayed key chain: the port's
    graphed solves stay within test_torch_plan's tolerance."""
    cj, ct = _configs()
    jr, _, robot, _ = _scene()
    occ = _occupancy()
    jinc = jedt.IncrementalSDF(occ, origin=ORIGIN, resolution=RES,
                               max_distance=0.3)
    inc = IncrementalSDF(occ, ORIGIN, RES, max_distance=0.3, device="cpu")
    B = 3
    q0, qN = _jitter(B, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    def both():
        ref = jplan.plan_batch(jr, jinc.as_world(), JProblem(q0=q0, qN=qN),
                               cj, keys=keys)
        got = plan_batch(robot, inc.as_world(), ProblemSpec(q0=q0, qN=qN),
                         ct, device="cpu",
                         noise_fn=_ReplayJaxNoise(keys, 7, ct.num_rollouts,
                                                  ct.num_timesteps))
        _assert_solutions(got, ref)
        return got

    first = both()
    captured = graph.GRAPHS["captured"]
    mid = _voxel(robot, first, ct.num_timesteps // 2)
    pts = _points(robot, first, ct.num_timesteps // 3)
    for j_edit, t_edit in [
            (lambda: jinc.set_box(mid - 1, mid + 2, True),
             lambda: inc.set_box(mid - 1, mid + 2, True)),
            (lambda: jinc.add_points(pts), lambda: inc.add_points(pts))]:
        j_edit()
        t_edit()
        both()
        _same_entry(captured)


@pytest.mark.parametrize("case", ["moved_box", "cone_target"])
def test_new_values_of_the_same_shapes_replay(emulated, case):
    """A box moved in a new CPU AnalyticWorld each call, or a cone whose
    target moves: one entry, no capture after the first call, each result
    bitwise the eager loop's; the values move the result."""
    robot, prob = arm_7dof(), _problem()
    shifts = (0.0, 0.06, -0.08)

    def call(s):
        if case == "moved_box":
            box = ((MID[0], MID[1] + s, MID[2]), (0.05, 0.05, 0.05))
            return dict(world=AnalyticWorld.make(boxes=[*_BOXES, box]))
        cone = OrientationConstraint.make(axis_local=(0, 0, 1),
                                          target_world=(s, 0.3 * s, 1.0),
                                          tolerance=0.25, weight=0.3)
        return dict(world=AnalyticWorld.make(boxes=_BOXES),
                    constraints=cone)

    sols = []
    for s in shifts:
        kw = call(s)
        got = _plan(robot, kw.pop("world"), prob, **kw)
        if not sols:
            captured = graph.GRAPHS["captured"]
        _same_entry(captured)
        kw = call(s)
        _assert_same(got, _eager(lambda: _plan(robot, kw.pop("world"), prob,
                                               **kw)))
        sols.append(got)
    for a, b in zip(sols, sols[1:]):
        assert not torch.equal(a.cost, b.cost)


def test_mpc_episode_over_an_edited_grid_replays_one_tick(emulated):
    """An MPC episode in chunks whose composite grid (an IncrementalSDF)
    is edited between them: one tick entry, captured in the first chunk,
    and the episode bitwise the eager one on the same worlds."""
    robot = planar_2r(body_radius=0.05)
    cfg = PlannerConfig(num_timesteps=20, duration=2.1, num_rollouts=10,
                        noise=NoiseConfig(stddev=0.25, decay=1.0,
                                          num_rollouts_reused=2),
                        collision_clearance=0.1, max_iterations=12,
                        max_iterations_after_collision_free=2,
                        record_metrics=False)
    inc = IncrementalSDF(np.zeros((50, 50, 12), bool),
                         origin=(-2.5, -2.5, -0.5), resolution=0.1,
                         max_distance=0.5, device="cpu")
    q0 = np.array([[-0.56, 1.65], [-0.5, 1.6]], np.float32)
    qN = np.array([[1.16, -1.46], [1.1, -1.4]], np.float32)
    state0 = mpc.init_mpc(robot, cfg, q0, qN,
                          np.array([[[2.4, -0.6, 0.0]], [[2.3, 0.6, 0.0]]],
                                   np.float32),
                          np.array([[[-0.15, 0.25, 0.0]],
                                    [[-0.1, -0.2, 0.0]]], np.float32))
    worlds, gen, state = [], _gen(0), state0
    for i in range(3):
        worlds.append(inc.as_world())
        state = mpc.run_mpc_batch(robot, cfg, state, [0.25], 3, 0.1,
                                  static_world=worlds[-1], device="cpu",
                                  generator=gen)
        # a sensor frame ahead of the arm, between chunks
        ahead = body_positions(robot, state.theta[0, 6])[-1].numpy()
        inc.add_points(ahead + np.random.default_rng(i).uniform(
            -0.1, 0.1, (200, 3)).astype(np.float32))
    ticks = [e for e in graph.cached() if e["kind"] == "mpc_tick"]
    assert len(ticks) == 1 and graph.GRAPHS["captured"] == 3
    assert graph.GRAPHS["inputs_loaded"] == 4       # two edits: grid, table

    def eager_episode():
        gen, s = _gen(0), state0
        for world in worlds:
            s = mpc.run_mpc_batch(robot, cfg, s, [0.25], 3, 0.1,
                                  static_world=world, device="cpu",
                                  generator=gen)
        return s

    _assert_same_state(state, _eager(eager_episode))


def _assert_same_state(a, b):
    for f in dataclasses.fields(b):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.fixture
def jax_goal_uniforms(monkeypatch):
    """The band scan draws JAX's threefry uniforms."""
    def u(d):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(jplan._GOAL_KEY_SEED),
            (jplan._GOAL_SAMPLES, d))))

    monkeypatch.setattr(tplan, "goal_uniforms", u)


@pytest.mark.parametrize("rows", ["d", "Bd"])
def test_goal_band_is_one_region(emulated, jax_goal_uniforms, rows):
    """The goal band (resolve_goal_tolerance) as a cached region: [d] and
    [B, d] bands, new goals and a moved obstacle replay it, each goal
    bitwise the eager band's with JAX's uniforms."""
    robot = planar_2r(body_radius=0.05)
    B = 4
    rng = np.random.default_rng(5)
    tol = (np.array([0.6, 0.6], np.float32) if rows == "d"
           else rng.uniform(0.2, 0.7, (B, 2)).astype(np.float32))

    def band(center, seed):
        world = AnalyticWorld.make(spheres=[(center, 0.25)])
        q0 = torch.as_tensor(np.tile([1.8, -0.6], (B, 1)), dtype=torch.float32)
        qN = torch.as_tensor(np.random.default_rng(seed).uniform(
            -0.1, 0.1, (B, 2)), dtype=torch.float32)
        t = torch.broadcast_to(torch.as_tensor(tol), qN.shape)
        return tplan.resolve_goal_tolerance(robot, world, CFG, q0, qN, t, t)

    goals = []
    for center, seed in [((2.0, 0.0, 0.0), 0), ((2.0, 0.0, 0.0), 1),
                         ((1.9, 0.2, 0.0), 1)]:
        got = band(center, seed)
        assert graph.GRAPHS["captured"] == 1
        (entry,) = graph.cached()
        assert entry["kind"] == "goal_band"
        assert torch.equal(got, _eager(lambda: band(center, seed)))
        goals.append(got)
    assert graph.cached()[0]["replays"] == 2
    assert not torch.equal(goals[0], goals[1])
    assert not torch.equal(goals[1], goals[2])


def test_plan_timed_replays_solve_in_and_out(emulated):
    """plan_timed on graph.solve: bitwise the eager plan_timed, and a
    second call replays solve-in, its chunks and solve-out."""
    robot, prob = arm_7dof(), ProblemSpec(*(x[0] for x in _jitter(1, 0)))
    world = AnalyticWorld.make(boxes=_BOXES)
    cfg = CFG.replace(planning_time_limit=60.0, max_iterations=10)

    def timed():
        return plan_timed(robot, world, prob, cfg, device="cpu",
                          generator=_gen(), chunk_iterations=4)

    first = timed()
    assert graph.GRAPHS["captured"] == 3
    _assert_same(timed(), first)
    assert graph.GRAPHS["captured"] == 3
    (entry,) = graph.cached()
    assert entry["regions"]["solve_in"]["replays"] == 1
    assert entry["regions"]["solve_out"]["replays"] == 1
    _assert_same(first, _eager(timed))
    untimed = tplan.plan(robot, world, prob, cfg, device="cpu",
                         generator=_gen())
    _assert_same(first, untimed)


def test_loads_rewrite_only_the_nodes_whose_block_moved(monkeypatch):
    """_load_inputs copies only the tensors that are not the ones the
    entry last took, and _rewrite gives a captured evaluator node its set's
    new block (kernels/rollout.py block_params) only where the block
    moved: new values rewrite it, equal values in new tensors load but
    rewrite nothing. The rewrite itself (graph_node.rewrite) is the
    card's: here it is recorded."""
    robot, world = arm_7dof(), AnalyticWorld.make(boxes=_BOXES)
    copy = clone_with_mirrors(world)
    rewrites = []

    def rewrite(exec_handle, node, params):
        rewrites.append((exec_handle, params.copy()))
        node.params = params.copy()

    monkeypatch.setattr(graph_node, "rewrite", rewrite)
    region = graph.Region(graph=SimpleNamespace(
        raw_cuda_graph_exec=lambda: 7))
    region.nodes.append(graph_node.Node(
        0, 1, tr._PARAM_FLOATS, tr.pack_params(robot, copy).numpy(),
        (robot, copy, True, ())))
    entry = SimpleNamespace(held=graph._held(graph._inputs(world)),
                            regions=lambda: (region,))
    graph.reset_counts()

    def load(w):
        graph._load_inputs(entry, graph._inputs(copy), graph._inputs(w))

    load(world)
    assert rewrites == [] and graph.GRAPHS["inputs_loaded"] == 0
    boxes = [((0.6, 0.1, 0.2), _BOXES[0][1]), _BOXES[1]]
    moved = AnalyticWorld.make(boxes=boxes)
    load(moved)
    assert graph.GRAPHS["inputs_loaded"] == 4
    assert torch.equal(copy.box_center, moved.box_center)
    ((handle, params),) = rewrites
    assert handle == 7
    np.testing.assert_array_equal(params,
                                  tr.pack_params(robot, moved).numpy())
    load(AnalyticWorld.make(boxes=boxes))       # equal values, new tensors
    assert graph.GRAPHS["inputs_loaded"] == 8 and len(rewrites) == 1

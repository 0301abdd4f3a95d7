"""The MPC tick's CUDA graphs (engine/mpc.py ``_Tick``) and per-scenario
worlds as graph inputs (engine/graph.py) on the CPU, at small shapes.

A graph is emulated as in tests/test_torch_graph.py (its `_emulate`: a
capture runs the region's host code once and puts every static buffer
back, a replay runs it again with the kernel counters left as they were);
everything else is the card's path: the cache and its keys, the static
buffers, the loads, the tick's regions and the copy out. Every graphed
episode is held bitwise to the eager one (engine/graph.eager()) under the
same generator or noise. The card's own checks are the `mpc_graph` tests
of tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_graph import _BOXES, _emulate, _gen, _rows_solve
from tpustomp_torch import ProblemSpec
from tpustomp_torch._tensors import fields
from tpustomp_torch.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp_torch.api.plan import resolve_backend
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import graph, mpc
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.engine.distributed import Mesh
from tpustomp_torch.engine.sampling import GeneratorNoise
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.model import arm_7dof
from tpustomp_torch.world.edt import grid_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

CFG = PlannerConfig(
    num_timesteps=12, duration=1.3, num_rollouts=6,
    noise=NoiseConfig(stddev=0.1, decay=0.98, num_rollouts_reused=2),
    weights=CostWeights(obstacle=1.0, smoothness=0.1),
    collision_clearance=0.05, max_iterations=4,
    max_iterations_after_collision_free=2, record_metrics=False)
B, TICKS, DT_WORLD = 4, 4, 0.1
RADIUS = [0.12]


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after)."""
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


def _static(kind):
    """None, the tabletop's boxes, or their voxel grid."""
    if kind == "none":
        return None
    world = AnalyticWorld.make(boxes=_BOXES)
    if kind == "analytic":
        return world
    return grid_from_analytic(world, origin=(-0.2, -0.9, -0.1),
                              shape=(24, 28, 20), resolution=0.06)


def _states(centers=None, vels=None, seed=0):
    """B scenarios from the tabletop's start to its goal, jittered, each
    with one sphere (by default near the arm's path, drifting)."""
    rng = np.random.default_rng(seed)
    q0 = (np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    qN = (np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (B, 7))).astype(np.float32)
    if centers is None:
        centers = np.stack([rng.uniform(0.4, 0.7, B),
                            rng.uniform(-0.3, 0.3, B),
                            rng.uniform(0.5, 0.8, B)], 1)[:, None]
    if vels is None:
        vels = rng.normal(0, 0.3, (B, 1, 3))
    return mpc.init_mpc(arm_7dof(), CFG, q0, qN, centers, vels)


def _episode(robot, state, static=None, ticks=TICKS, seed=3):
    return mpc.run_mpc_batch(robot, CFG, state, RADIUS, ticks, DT_WORLD,
                             static_world=static, device="cpu",
                             generator=_gen(seed))


def _eager(fn):
    with graph.eager():
        return fn()


def _assert_same(a, b):
    """Every MPCState field bitwise equal."""
    for f in dataclasses.fields(b):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _ticks():
    (entry,) = [g for g in graph.cached() if g["kind"] == "mpc_tick"]
    return entry


@pytest.mark.parametrize("kind", ["none", "analytic", "grid"])
def test_graphed_episode_is_bitwise_eager(emulated, monkeypatch, kind):
    """run_mpc_batch over no static world, the analytic tabletop and its
    voxel grid: the graphed episode (tick 0 captures, the others replay)
    equals the eager one in every MPCState field, and counts the kernel
    launches the eager episode counts (on the CPU the evaluator's plain
    version runs: each call counts here as the card's wrapper counts its
    launch)."""
    real_rows = tsolver._obstacle_rows

    def counted(robot, world, cfg, fulls, *a, **kw):
        composite = isinstance(world, CompositeWorld)
        tr.LAUNCHES["rollout_grid:per_cand_overlay" if composite
                    else "rollout_analytic:per_cand_world"] += 1
        tr.LAYOUTS["time_major" if kw.get("time_major") else
                   "candidate_major"] += 1
        return real_rows(robot, world, cfg, fulls, *a, **kw)

    monkeypatch.setattr(tsolver, "_obstacle_rows", counted)
    robot, state, static = arm_7dof(), _states(), _static(kind)
    tr.reset_launches()
    ref = _eager(lambda: _episode(robot, state, static))
    counts = [dict(c) for c in graph._COUNTERS]
    assert graph.GRAPHS["replayed"] == 0
    tr.reset_launches()
    got = _episode(robot, state, static)
    _assert_same(got, ref)
    assert [dict(c) for c in graph._COUNTERS] == counts
    variant = ("rollout_analytic:per_cand_world" if kind != "grid"
               else "rollout_grid:per_cand_overlay")
    assert counts[0][variant] > 0
    assert graph.GRAPHS["captured"] == 3 and graph.GRAPHS["replayed"] > 0


def test_episode_captures_its_regions_once(emulated):
    """An episode captures tick-in, the loop and tick-out in its first
    tick and replays tick-in and tick-out once on every later tick; a
    second episode of the same inputs captures nothing and replays every
    tick; the result never aliases the graph's buffers."""
    robot, state, static = arm_7dof(), _states(), _static("analytic")
    first = _episode(robot, state, static)
    entry = _ticks()
    assert graph.GRAPHS["captured"] == 3 and len(graph.cached()) == 1
    assert entry["regions"]["tick_in"]["replays"] == TICKS - 1
    assert entry["regions"]["tick_out"]["replays"] == TICKS - 1
    assert entry["regions"]["loop"]["replays"] > 0
    assert graph.GRAPHS["eager:first_iteration"] == 1
    kept = map(torch.clone, fields(first))
    again = _episode(robot, state, static)
    assert graph.GRAPHS["captured"] == 3
    assert _ticks()["regions"]["tick_in"]["replays"] == 2 * TICKS - 1
    assert graph.GRAPHS["eager:first_iteration"] == 1
    _assert_same(again, first)
    (tick,) = graph._CACHE.values()
    bufs = {v.untyped_storage().data_ptr() for v in tick.buffers()}
    assert not bufs & {v.untyped_storage().data_ptr()
                       for v in fields(again)}
    _episode(robot, _states(seed=1), static)      # the same graph, other values
    assert all(torch.equal(a, b)
               for a, b in zip(fields(first), kept))


def test_moving_obstacles_reach_the_graph(emulated):
    """Each tick's world is copied into the graph's static rows: spheres
    that sweep from beyond the arm's reach onto its path from tick 3 on
    give the eager episode, after a first episode captured the graph with
    the spheres held still far away. A world frozen at capture would miss
    them: held at their tick-0 place, the spheres leave the plans
    unchanged."""
    far = np.tile([[[1.9, 0.0, 0.65]]], (B, 1, 1))
    sweep = np.tile([[[-3.5, 0.0, 0.0]]], (B, 1, 1))
    robot, static = arm_7dof(), _static("analytic")
    _episode(robot, _states(far, np.zeros_like(far)), static, ticks=6)
    assert graph.GRAPHS["captured"] == 3
    moving = _states(far, sweep)
    ref = _eager(lambda: _episode(robot, moving, static, ticks=6))
    got = _episode(robot, moving, static, ticks=6)
    assert graph.GRAPHS["captured"] == 3
    _assert_same(got, ref)
    held = _eager(lambda: _episode(robot, _states(
        far + sweep * DT_WORLD, np.zeros_like(far)), static, ticks=6))
    assert not torch.equal(ref.theta, held.theta)


def test_new_static_world_or_robot_gets_a_new_graph(emulated):
    """The tick's key names the robot and DeviceOps by identity and
    version, the static world by type and shapes: a new robot, or a static
    world of other shapes, captures anew; a new static world of the same
    shapes, or one written in place by torch, replays the cached tick with
    its values loaded into the tick's copy, and the result is the eager
    episode on that world."""
    state = _states()
    static, robot = _static("analytic"), arm_7dof()
    _episode(robot, state, static)
    _episode(robot, state, static)
    assert graph.GRAPHS["captured"] == 3
    other = _static("analytic")
    _episode(robot, state, other)
    assert graph.GRAPHS["captured"] == 3            # same shapes: a hit
    other_robot = arm_7dof()
    _episode(other_robot, state, static)
    assert graph.GRAPHS["captured"] == 6
    static.box_half.mul_(1.3)                       # in place
    got = _episode(robot, state, static)
    assert graph.GRAPHS["invalidated"] == 0
    assert graph.GRAPHS["captured"] == 6
    _assert_same(got, _eager(lambda: _episode(robot, state, static)))
    more = AnalyticWorld.make(
        boxes=_BOXES + [((0.3, 0.4, 0.5), (0.05, 0.05, 0.05))])
    _episode(robot, state, more)
    assert graph.GRAPHS["captured"] == 9            # other shapes


def test_resilient_recovery_is_bitwise_under_graphs(emulated):
    """run_mpc_resilient's chunks and its full-batch replay of a corrupted
    chunk hit one cached tick: the recovered episode equals the clean
    eager one bit for bit."""
    robot, state, static = arm_7dof(), _states(), _static("analytic")

    def fault(chunk_idx, out):
        if chunk_idx == 0:
            out.theta[1] = float("nan")
            out.steps[2] = 0
        return out

    ref = _eager(lambda: _episode(robot, state, static))
    got = mpc.run_mpc_resilient(robot, CFG, state, RADIUS, TICKS,
                                DT_WORLD, chunk_ticks=2, static_world=static,
                                device="cpu", generator=_gen(3),
                                _fault_hook=fault)
    _assert_same(got, ref)
    assert graph.GRAPHS["captured"] == 3
    # three runs of a two-tick chunk (chunk 0, its replay, chunk 1): every
    # tick replays tick-in but the one that captured it
    assert _ticks()["regions"]["tick_in"]["replays"] == 3 * 2 - 1


def test_resumed_and_stepped_episodes_are_bitwise_eager(emulated):
    """An episode cut in two (the state and the generator carried over, as
    a checkpoint resumes it) and one run tick by tick through
    mpc_step_batch equal the whole eager episode. The episodes hit one
    tick, and the steps (a noise_fn of the caller's: the per-iteration
    route) another."""
    state, static = _states(), _static("grid")
    robot = arm_7dof()
    ref = _eager(lambda: _episode(robot, state, static))
    gen = _gen(3)
    half = mpc.run_mpc_batch(robot, CFG, state, RADIUS, 2, DT_WORLD,
                             static_world=static, device="cpu", generator=gen)
    got = mpc.run_mpc_batch(robot, CFG, half, RADIUS, TICKS - 2, DT_WORLD,
                            static_world=static, device="cpu", generator=gen)
    _assert_same(got, ref)
    # mpc_step_batch takes the config as run_mpc_batch resolves it
    cfg = resolve_backend(CFG, robot, mpc._probe_world(static))
    draws = mpc._TickDraws(_gen(3), cfg, 7, 0, B, B, "cpu")
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")
    radius = torch.tensor(RADIUS)
    step = state
    for t in range(TICKS):
        step = mpc.mpc_step_batch(
            robot, cfg, ops, step, radius, DT_WORLD,
            lambda it, active, t=t: draws(t, it, active), static)
    _assert_same(step, ref)
    assert graph.GRAPHS["captured"] == 6


def test_sharded_episodes_are_bitwise_eager(emulated):
    """run_mpc_sharded's shards of a global batch of 2·B (ranks 0 and 1 of
    a mesh, in one process; no collective runs) graphed against eager,
    under the global batch's noise: one tick graph serves both shards."""
    static = _static("analytic")
    robot = arm_7dof()
    for rank in (0, 1):
        state = _states(seed=rank)

        def run(rank=rank, state=state):
            return mpc.run_mpc_sharded(
                robot, CFG, state, RADIUS, TICKS, DT_WORLD,
                mesh=Mesh(rank, 2, torch.device("cpu")), static_world=static,
                generator=_gen(3))

        _assert_same(run(), _eager(run))
    assert graph.GRAPHS["captured"] == 3


def test_row_worlds_are_graph_inputs(emulated):
    """solve_batch with one world row per scenario replays one graph for
    rows of other values (loaded, not keyed), bitwise the eager loop; so
    does the compacted path, whose buckets gather the rows."""
    robot = arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    rng = np.random.default_rng(0)
    q0 = (np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (3, 7))).astype(np.float32)
    qN = (np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (3, 7))).astype(np.float32)
    prob = ProblemSpec(q0=q0, qN=qN)
    cfg = CFG.replace(max_iterations=6)
    for scale in (1.0, 0.8):
        shrunk = AnalyticWorld(world.sphere_center, world.sphere_radius,
                               world.box_center, world.box_half * scale)
        ref = _eager(lambda: _rows_solve(robot, shrunk, prob, cfg))
        got = _rows_solve(robot, shrunk, prob, cfg)
        for f in ("trajectory", "success", "cost", "iterations"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    # one entry: its loop, solve-in and solve-out
    assert graph.GRAPHS["captured"] == 3 and len(graph.cached()) == 1

    rows = AnalyticWorld(*(v[None].expand((3,) + v.shape).clone()
                           for v in fields(world)))
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")

    def compacted():
        noise = GeneratorNoise(_gen(), 7, 3, cfg.num_rollouts,
                               cfg.num_timesteps, "cpu")
        return tsolver.solve_batch_compacted(
            robot, rows, cfg, ops, torch.as_tensor(q0), torch.as_tensor(qN),
            noise, world_batched=True, chunk=2, min_bucket=1)

    ref = _eager(compacted)
    replayed = graph.GRAPHS["replayed"]
    got = compacted()
    assert graph.GRAPHS["replayed"] > replayed
    for f in ("trajectory", "success", "cost", "iterations"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f

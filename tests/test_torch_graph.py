"""The solver loop's CUDA graphs (tpustomp_torch/engine/graph.py) on the
CPU: the draw/advance split of the steps, the graph path's buffers, cache,
eager cases and counters, and the PI² knobs the captured step branches on
against the JAX package.

There is no card here, so a graph is emulated (the `emulated` fixture):
its "capture" runs the captured region's host code once and puts the
static state back, as a capture records kernels without running them, and
its "replay" runs the region with the kernel counters left as they were,
as a replay runs no host code. An IF node runs its body's host code at a
capture (a capture records every body) and, at a replay, only when its
condition holds. Everything else is the card's path: the cache, the
static buffers, the draws into them, the loads and the copy out. The card's own checks (graphed bitwise eager, no host sync in a
capture) are the `cuda` tests of tests/test_torch_cuda.py.
"""

import collections
import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpustomp.api.config as jcfg
from tpustomp.dynamics.device import device_ops as j_device_ops
from tpustomp.engine import solver as jsolver
from tests.test_torch_solver import (_ReplayJaxNoise, _configs, _fields,
                                     _jitter, _scene)
from tpustomp_torch import (OrientationConstraint, ProblemSpec, convert,
                            plan_batch, plan_batch_retry, plan_timed, tune)
from tpustomp_torch import _tensors
from tpustomp_torch.api.config import CostWeights, NoiseConfig, PlannerConfig
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import graph, mpc
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.engine.sampling import GeneratorNoise
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.fk import fk_frames
from tpustomp_torch.robot.model import arm_7dof, joint_types_on_host
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.edt import grid_from_analytic
from tpustomp_torch.world.sdf import AnalyticWorld

_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]
_BASE = dict(num_timesteps=16, num_rollouts=6, max_iterations=6,
             noise=NoiseConfig(stddev=0.2, decay=0.95, num_rollouts_reused=2))
# the steps' branches: STOMP's projections, reuse, PI² knobs, cost rows;
# CHOMP's gradient modes; HMC with and without the Metropolis test
_CASES = {
    "clip": {},
    "smooth": dict(rollout_limit_projection="smooth"),
    "no_reuse": dict(noise=NoiseConfig(stddev=0.2, decay=0.95,
                                       num_rollouts_reused=0)),
    "pi2_knobs": dict(pi2_cost_mode="local", pi2_include_control_cost=True,
                      joint_limit_method="sequential"),
    "torque": dict(weights=CostWeights(obstacle=1.0, smoothness=0.1,
                                       torque=0.005)),
    "no_metrics": dict(record_metrics=False),
    "chomp": dict(mode="chomp", learning_rate=0.3),
    "chomp_exact": dict(mode="chomp", learning_rate=0.3,
                        chomp_gradient_mode="exact"),
    "chomp_pinv_torque": dict(mode="chomp", learning_rate=0.3,
                              use_pseudo_inverse=True,
                              weights=CostWeights(obstacle=1.0,
                                                  smoothness=0.1,
                                                  torque=0.005)),
    "hmc": dict(mode="chomp", use_hamiltonian_monte_carlo=True,
                hmc_step_size=0.3, hmc_leapfrog_steps=2,
                hmc_temperature=0.05),
    "hmc_no_metropolis": dict(mode="chomp", use_hamiltonian_monte_carlo=True,
                              hmc_metropolis=False, hmc_step_size=0.3,
                              hmc_leapfrog_steps=2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _EmulatedGraph:
    """A replay runs the captured region again, with the kernel counters
    left as they were (a replay runs no host code)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        counts = [dict(c) for c in graph._COUNTERS]
        self.body()
        for c, saved in zip(graph._COUNTERS, counts):
            c.update(saved)

    def reset(self):
        self.body = None


_CAPTURING = []


def _emulated_capture(body, stream, generator=None):
    """A capture runs the region's host code (the counters move) and
    leaves the static buffers as they were (no kernel ran)."""
    bufs = body.__self__.buffers()
    saved = [v.clone() for v in bufs]
    _CAPTURING.append(True)
    try:
        body()
    finally:
        _CAPTURING.pop()
    for v, s in zip(bufs, saved):
        v.copy_(s)
    return _EmulatedGraph(body), 0.0, 0.0, 0


def _emulated_if_node(pred, fn):
    """An IF node: its body's host code runs at a capture, and at a
    replay when bool(pred) holds."""
    if _CAPTURING or bool(pred):
        fn()


def _emulate(monkeypatch):
    """The graph path on CPU tensors (see the module docstring)."""
    real = graph.eager_reason

    def reason(*a, **k):
        why = real(*a, **k)
        return None if why == "cpu" else why

    monkeypatch.setattr(graph, "eager_reason", reason)
    monkeypatch.setattr(graph, "_stream", lambda *a, **k: None)
    monkeypatch.setattr(graph, "_on", lambda stream, fn: fn())
    monkeypatch.setattr(graph, "_capture", _emulated_capture)
    monkeypatch.setattr(graph, "_if_node", _emulated_if_node)


@pytest.fixture
def emulated(monkeypatch):
    _emulate(monkeypatch)
    graph.clear()
    graph.reset_counts()
    yield
    graph.clear()


def _scene7():
    robot = arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    rng = np.random.default_rng(0)
    q0 = (np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (3, 7))).astype(np.float32)
    qN = (np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0])
          + rng.uniform(-0.03, 0.03, (3, 7))).astype(np.float32)
    return robot, world, ProblemSpec(q0=q0, qN=qN)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _assert_same(a, b):
    """Every field of two Solutions bitwise equal."""
    for f in ("trajectory", "times", "success", "cost", "iterations"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.metrics is None) == (b.metrics is None)
    if a.metrics is not None:
        for f in dataclasses.fields(a.metrics):
            assert torch.equal(getattr(a.metrics, f.name),
                               getattr(b.metrics, f.name)), f.name


def _first_state(robot, world, cfg, prob):
    """(step, state after one iteration) of a CPU solve of `prob`."""
    q0 = torch.as_tensor(prob.q0)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")
    QN, state = tsolver._init_batch(robot, cfg, q0, torch.as_tensor(prob.qN))
    hmc = cfg.mode == "chomp" and cfg.use_hamiltonian_monte_carlo
    noise = GeneratorNoise(_gen(), q0.shape[1], q0.shape[0],
                           cfg.num_rollouts, cfg.num_timesteps, "cpu",
                           hmc=hmc)
    step = tsolver.make_step(robot, world, cfg, ops, q0, QN, noise)
    return step, step(state, 0)


@pytest.mark.parametrize("case", list(_CASES))
def test_step_is_its_draw_then_its_advance(case):
    """step(state, it) is advance(state, draw(it, done)) bitwise; the
    draw written into buffers (the default source's `into`, or a copy of a
    caller's draw) is the draw itself."""
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**{**_BASE, **_CASES[case]})
    step, state = _first_state(robot, world, cfg, prob)
    gen_state = step.noise_fn.generator.get_state()
    got = step(state, 1)
    step.noise_fn.generator.set_state(gen_state)
    draws = step.draw(1, state.done)
    ref = step.advance(state, draws)
    for a, b in zip(_tensors.fields(got), _tensors.fields(ref)):
        assert torch.equal(a, b)
    bufs = tuple(torch.empty(s) for s in step.draw_shapes())
    for source in (step.noise_fn, lambda it, active: draws):
        step.noise_fn.generator.set_state(gen_state)
        dataclasses.replace(step, noise_fn=source).draw_into(
            1, ~state.done, bufs)
        flat = (draws if cfg.mode == "chomp" else (draws,)) or ()
        assert all(torch.equal(b, d) for b, d in zip(bufs, flat))


def _runs():
    """{case: run()}: every step branch of _CASES, a cone (STOMP and
    CHOMP), a voxel world, HyperParams (tune), compaction's buckets,
    plan_timed's chunks and a retry round."""
    robot, world, prob = _scene7()
    cone = OrientationConstraint.make(axis_local=(0, 0, 1),
                                      target_world=(0, 0, 1),
                                      tolerance=0.25, weight=0.3)
    base = PlannerConfig(**_BASE)
    runs = {name: (lambda c=PlannerConfig(**{**_BASE, **kw}): plan_batch(
        robot, world, prob, c, device="cpu", generator=_gen()))
        for name, kw in _CASES.items()}
    runs.update(
        cone=lambda: plan_batch(robot, world, prob, base, device="cpu",
                                constraints=cone, generator=_gen()),
        chomp_cone=lambda: plan_batch(
            robot, world, prob, base.replace(mode="chomp"), device="cpu",
            constraints=cone, generator=_gen()),
        grid=lambda: plan_batch(
            robot, grid_from_analytic(world, origin=(-0.2, -0.9, -0.1),
                                      shape=(24, 28, 20), resolution=0.06),
            prob, base, device="cpu", generator=_gen()),
        compaction=lambda: plan_batch(
            robot, world, prob, base.replace(batch_compaction="on",
                                             compaction_chunk=2,
                                             compaction_min_bucket=1),
            device="cpu", generator=_gen()),
        tune=lambda: tune(robot, world, prob, base, noise_scale=(0.7, 1.0),
                          h=(5.0,), decay=(1.0,), device="cpu").table,
        plan_timed=lambda: plan_timed(
            robot, world, ProblemSpec(q0=prob.q0[0], qN=prob.qN[0]), base,
            device="cpu", generator=_gen(), chunk_iterations=2),
        retry=lambda: plan_batch_retry(
            robot, world, prob, base.replace(max_iterations=2),
            device="cpu", generator=_gen(), retry_restarts=2),
    )
    return runs


@pytest.mark.parametrize("case", list(_runs()))
def test_graphed_solves_are_bitwise_the_eager_loop(emulated, case):
    """The graph path (capture at the first call, a hit at the second)
    bitwise the eager loop, and it replayed."""
    run = _runs()[case]
    with graph.eager():
        ref = run()
    for _ in range(2):
        replayed = graph.GRAPHS["replayed"]
        got = run()
        assert graph.GRAPHS["replayed"] > replayed
        if case == "tune":
            assert got == ref
        else:
            _assert_same(got, ref)


def test_cache_hits_and_misses(emulated):
    """Equal inputs replay the cached graph; a new batch size, config,
    robot or constraint captures a new one, and a world written in place
    by torch (a new _version) replays it with the world's new values
    loaded into the graph's copy: the result is the eager loop's on the
    changed world."""
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**_BASE)
    cone = OrientationConstraint.make(axis_local=(0, 0, 1),
                                      target_world=(0, 0, 1),
                                      tolerance=0.25, weight=0.3)

    def solve(r=robot, w=world, p=prob, c=cfg, **kw):
        return plan_batch(r, w, p, c, device="cpu", generator=_gen(), **kw)

    first = solve()         # an entry: its loop, solve-in and solve-out
    assert graph.GRAPHS["captured"] == 3
    _assert_same(solve(), first)
    assert graph.GRAPHS["captured"] == 3 and len(graph.cached()) == 1
    two = ProblemSpec(q0=prob.q0[:2], qN=prob.qN[:2])
    new_robot = dataclasses.replace(robot,
                                    joint_lower=robot.joint_lower.clone())
    for i, kw in enumerate([dict(p=two), dict(c=cfg.replace(pi2_h=12.0)),
                            dict(r=new_robot), dict(constraints=cone)]):
        solve(**kw)
        assert graph.GRAPHS["captured"] == 3 * (2 + i), kw
    solve(r=new_robot)
    assert graph.GRAPHS["captured"] == 15           # a hit
    world.box_half.mul_(1.2)                        # in place
    got = solve()
    assert graph.GRAPHS["invalidated"] == 0
    assert graph.GRAPHS["captured"] == 15           # a hit, its input loaded
    assert graph.GRAPHS["inputs_loaded"] == 1
    with graph.eager():
        _assert_same(got, solve())
    assert not torch.equal(got.cost, first.cost)


def test_cache_is_bounded(emulated, monkeypatch):
    """At most LIMIT graphs; the least recently used goes first."""
    monkeypatch.setattr(graph, "LIMIT", 2)
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 3})
    for h in (5.0, 6.0, 7.0, 5.0):
        plan_batch(robot, world, prob, cfg.replace(pi2_h=h), device="cpu",
                   generator=_gen())
    assert len(graph.cached()) == 2
    assert graph.GRAPHS["evicted"] == 2 and graph.GRAPHS["captured"] == 12


def test_cached_reports_every_kind_with_the_same_keys(emulated):
    """A solve, a goal band and an MPC tick are entries of one kind
    (graph.Entry): graph.cached() reports each with the same keys, its
    regions under their names."""
    robot, world, prob = _scene7()
    band = dataclasses.replace(prob, goal_tolerance_below=0.05,
                               goal_tolerance_above=0.05)
    plan_batch(robot, world, band, PlannerConfig(**_BASE), device="cpu",
               generator=_gen())
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 3,
                           "record_metrics": False})
    rng = np.random.default_rng(1)
    state = mpc.init_mpc(robot, cfg, prob.q0, prob.qN,
                         rng.uniform(0.4, 0.7, (3, 1, 3)),
                         rng.normal(0, 0.3, (3, 1, 3)))
    mpc.run_mpc_batch(robot, cfg, state, [0.12], 2, 0.1, static_world=world,
                      device="cpu", generator=_gen())
    entries = {e["kind"]: e for e in graph.cached()}
    assert set(entries) == {"stomp", "goal_band", "mpc_tick"}
    keys = ["kind", "route", "k", "batch", "static_bytes", "pool_bytes",
            "capture_ms", "instantiate_ms", "replays", "regions"]
    assert all(list(e) == keys for e in entries.values())
    assert set(entries["stomp"]["regions"]) == {"loop", "solve_in",
                                                "solve_out"}
    assert set(entries["goal_band"]["regions"]) == {"goal_band"}
    assert set(entries["mpc_tick"]["regions"]) == {"tick_in", "loop",
                                                   "tick_out"}
    assert entries["goal_band"]["route"] is None
    assert entries["stomp"]["route"] == entries["mpc_tick"]["route"] == (
        "chunk")
    assert all(e["batch"] == (3, 7) and e["static_bytes"] > 0
               for e in entries.values())


_CALLERS = ("tpustomp_torch/engine/mpc.py", "tpustomp_torch/engine/solver.py",
            "tpustomp_torch/api/plan.py")


@pytest.mark.parametrize("path", _CALLERS)
def test_callers_use_only_the_public_seam_of_graph(path):
    """engine/graph.py owns its cache and the graph-or-eager choice: its
    callers name none of its private names, build no SimpleNamespace
    stand-in step, never ask graph.route and ask graph.eager_reason at
    most once (the MPC tick's choice)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    tree = ast.parse((root / path).read_text())
    private, calls = [], collections.Counter()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "graph"):
            if node.attr.startswith("_"):
                private.append(f"graph.{node.attr}:{node.lineno}")
            calls[node.attr] += 1
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.ImportFrom) else
                 [node.id] if isinstance(node, ast.Name) else
                 [node.attr] if isinstance(node, ast.Attribute) else [])
        assert "SimpleNamespace" not in names, (path, node.lineno)
    assert private == []
    assert calls["route"] == 0
    assert calls["eager_reason"] <= (1 if path.endswith("mpc.py") else 0)


def test_results_survive_the_next_replay(emulated):
    """A Solution is the solve's own: it shares no storage with the graph's
    buffers (iterations and metrics come from the returned state), and the
    next solve replaying the same graph leaves it as it was."""
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**_BASE)
    first = plan_batch(robot, world, prob, cfg, device="cpu",
                       generator=_gen())
    tensors = [first.trajectory, first.cost, first.success, first.iterations,
               *_tensors.fields(first.metrics)]
    kept = [v.clone() for v in tensors]
    (g,) = graph._CACHE.values()
    bufs = {v.untyped_storage().data_ptr()
            for v in _tensors.fields(g.loop.state)}
    assert not bufs & {v.untyped_storage().data_ptr() for v in tensors}
    other = ProblemSpec(q0=prob.q0[::-1].copy(), qN=prob.qN[::-1].copy())
    plan_batch(robot, world, other, cfg, device="cpu", generator=_gen(4))
    assert graph.GRAPHS["captured"] == 3 and graph.GRAPHS["replayed"] > 3
    assert all(torch.equal(a, b) for a, b in zip(tensors, kept))


def test_eager_cases_are_counted_by_reason(monkeypatch):
    """Each eager case, decided before any capture, counts its iterations
    under its reason: a CPU step, debug_mode, tensors moved under
    inference_mode, and the caller's request (a CPU step in one of the
    other cases counts under that case). A world with a row axis is no
    eager case: its rows are graph inputs (test_row_worlds_are_graph_inputs)."""
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 3})

    def solve(r=robot):
        return plan_batch(r, world, prob, cfg, device="cpu",
                          generator=_gen())

    with torch.inference_mode():
        frozen = dataclasses.replace(robot, **{
            f.name: getattr(robot, f.name).clone()
            for f in dataclasses.fields(robot)
            if isinstance(getattr(robot, f.name), torch.Tensor)})
    cases = {
        "cpu": solve,
        "debug_mode": lambda: _in(tracing.debug_mode(), solve),
        "requested": lambda: _in(graph.eager(), solve),
        "inference_tensors": lambda: solve(frozen),
    }
    for why, run in cases.items():
        graph.reset_counts()
        run()
        assert graph.GRAPHS == {f"eager:{why}": 3}, why
    graph.clear()


def _in(ctx, fn):
    with ctx:
        return fn()


def _rows_solve(robot, world, prob, cfg):
    """solve_batch with one world row per scenario (the MPC tick's)."""
    B = len(prob.q0)
    rows = AnalyticWorld(*(v[None].expand((B,) + v.shape).clone()
                           for v in _tensors.fields(world)))
    q0 = torch.as_tensor(prob.q0)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")
    noise = GeneratorNoise(_gen(), 7, B, cfg.num_rollouts,
                           cfg.num_timesteps, "cpu")
    return tsolver.solve_batch(robot, rows, cfg, ops, q0,
                               torch.as_tensor(prob.qN), noise,
                               world_batched=True)


def test_replays_count_what_the_eager_loop_counts(emulated, monkeypatch):
    """The kernel counters count host calls: what a capture added is taken
    back and added again at every replay, so a graphed solve leaves
    LAUNCHES, PARAM_ROUTES, LAYOUTS and BODY_ORDER where the eager loop
    leaves them."""
    real_rows = tsolver._obstacle_rows

    def counted(robot, world, cfg, fulls, *a, **kw):
        tr.LAUNCHES["rollout_analytic"] += 1
        tr.PARAM_ROUTES["block"] += 1
        tr.LAYOUTS["time_major" if kw.get("time_major") else
                   "candidate_major"] += 1
        tr.BODY_ORDER["sorted"] += 1
        return real_rows(robot, world, cfg, fulls, *a, **kw)

    monkeypatch.setattr(tsolver, "_obstacle_rows", counted)
    robot, world, prob = _scene7()
    counts = {}
    for mode in ("chomp", "stomp"):
        cfg = PlannerConfig(**{**_BASE, "mode": mode})
        for run in ("eager", "graphed", "graphed_again"):
            tr.reset_launches()
            if run == "eager":
                with graph.eager():
                    plan_batch(robot, world, prob, cfg, device="cpu",
                               generator=_gen())
            else:
                plan_batch(robot, world, prob, cfg, device="cpu",
                           generator=_gen())
            counts[run] = [dict(c) for c in graph._COUNTERS]
        assert counts["eager"][0]["rollout_analytic"] > 0
        assert counts["graphed"] == counts["eager"] == counts[
            "graphed_again"], mode


def test_launch_params_reads_nothing_while_capturing(monkeypatch):
    """While a capture is reported, a set without host copies is never
    read to the host, not even at the launch that would read it: it takes
    the memory path (pack_params's device vector) and PARAM_READS stays;
    once the capture is over, the next launch makes the one read."""
    robot = arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    tr.reset_launches()
    real_pack = tr.pack_params

    class NoRead(torch.Tensor):
        def cpu(self, *a, **k):
            raise AssertionError("device read during a capture")

    monkeypatch.setattr(tr, "_capturing", lambda: True)
    monkeypatch.setattr(tr, "pack_params",
                        lambda *a: real_pack(*a).as_subclass(NoRead))
    for _ in range(3):
        route, vec = tr._launch_params(robot, world, True)
        assert route == "memory" and isinstance(vec, NoRead)
    assert tr.PARAM_READS == {"device": 0, "deferred": 3}
    monkeypatch.setattr(tr, "_capturing", lambda: False)
    monkeypatch.setattr(tr, "pack_params", real_pack)
    route, vec = tr._launch_params(robot, world, True)
    assert route == "block" and tr.PARAM_READS["device"] == 1
    assert np.array_equal(vec, real_pack(robot, world).numpy())


@pytest.mark.parametrize("knob", ["pi2_cost_mode", "pi2_include_control_cost",
                                  "joint_limit_method"])
def test_pi2_knobs_match_jax(knob):
    """One time-major step with each PI² knob the captured step branches on
    (ROADMAP §C 2), from a state with θ beyond joint 1's upper limit on
    every scenario, so the projection works (the sequential method's
    worst-violation loop too): against the JAX step under its replayed
    draws, to the tolerances of test_one_batched_step_matches_jax."""
    value = {"pi2_cost_mode": "local", "pi2_include_control_cost": True,
             "joint_limit_method": "sequential"}[knob]
    cj, ct = _configs(**{knob: value,
                         "noise": jcfg.NoiseConfig(stddev=0.25, decay=0.9,
                                                   num_rollouts_reused=2)})
    jr, jw, robot, world = _scene()
    B, N, d, Kr = 3, ct.num_timesteps, 7, 2
    q0, qN = _jitter(B, 1)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    QNj, sj = jsolver._init_batch(jr, cj, jnp.asarray(q0), jnp.asarray(qN),
                                  keys, None)
    rng = np.random.default_rng(4)
    theta = np.asarray(sj.theta) + rng.normal(0, 0.05, (B, N, d)).astype(
        np.float32)
    upper = np.asarray(jr.joint_upper)
    theta[:, 6:12, 1] = upper[1] + 0.15             # beyond the limit
    assert bool(np.asarray(jr.joint_limited)[1])
    reuse = theta[:, None] + rng.normal(0, 0.1, (B, Kr, N, d)).astype(
        np.float32)
    sj = sj.replace(theta=jnp.asarray(theta), best_theta=jnp.asarray(theta),
                    reuse_theta=jnp.asarray(reuse),
                    iteration=jnp.asarray([0, 2, 1], jnp.int32))
    ops_j = j_device_ops(N, cj.dt, cj.smoothness)
    ref = jax.jit(jsolver.make_step_batch_tm(jr, jw, None, cj, ops_j,
                                             jnp.asarray(q0), QNj))(sj)
    state = tsolver.SolverState(**{
        f.name: torch.from_numpy(np.array(getattr(sj, f.name)))
        for f in dataclasses.fields(tsolver.SolverState)})
    step = tsolver.make_step_batch_tm(
        robot, world, ct, convert.ops_from_numpy(_fields(ops_j)),
        torch.from_numpy(q0), torch.from_numpy(np.array(QNj)),
        _ReplayJaxNoise(keys, d, ct.num_rollouts, N))
    got = step(state, 0)
    assert float(got.theta[:, :, 1].max()) <= upper[1] + 1e-6
    for f in dataclasses.fields(tsolver.SolverState):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(got, f.name).numpy()
        if a.dtype == bool or a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)


@pytest.mark.parametrize("deferred", ["first_launch", "every_launch"])
def test_a_deferred_read_settles_before_the_capture(emulated, monkeypatch,
                                                    deferred):
    """A set built on the card defers its device read to its second launch
    (PARAM_READS["deferred"]): after a first iteration that deferred one,
    one more runs eagerly ("param_read"), so the capture finds the read
    made; never more than that one, even when every launch defers. The
    solve is the eager loop's bitwise."""
    real_rows = tsolver._obstacle_rows
    launches = []

    def deferring(*a, **kw):
        if deferred == "every_launch" or not launches:
            tr.PARAM_READS["deferred"] += 1
        launches.append(1)
        return real_rows(*a, **kw)

    monkeypatch.setattr(tsolver, "_obstacle_rows", deferring)
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**_BASE)
    with graph.eager():
        ref = plan_batch(robot, world, prob, cfg, device="cpu",
                         generator=_gen())
    launches.clear()
    graph.reset_counts()
    got = plan_batch(robot, world, prob, cfg, device="cpu", generator=_gen())
    _assert_same(got, ref)
    assert graph.GRAPHS["eager:first_iteration"] == 1
    assert graph.GRAPHS["eager:param_read"] == 1
    assert graph.GRAPHS["captured"] == 3 and graph.GRAPHS["replayed"] > 0


def test_a_graph_whose_tensors_are_gone_is_dropped(emulated):
    """The cache holds the key's tensors weakly, and the graph's step runs
    on copies of them and of the world (what its kernels read stays with
    the graph): a world that is gone leaves the graph, whose key names
    only its shapes; once the robot a graph was captured on is gone, the
    next call into the cache drops the graph ("dead") and frees its
    pool."""
    robot, world, prob = _scene7()
    plan_batch(robot, world, prob, PlannerConfig(**_BASE), device="cpu",
               generator=_gen())
    (g,) = graph._CACHE.values()
    for a, b in zip(_tensors.fields(g.loop.step.world),
                    _tensors.fields(world)):
        assert torch.equal(a, b) and a is not b
        assert a.numel() == 0 or a.data_ptr() != b.data_ptr()
    assert g.robot.joint_axis.data_ptr() != robot.joint_axis.data_ptr()
    assert len(graph.cached()) == 1
    del world
    gc.collect()
    assert len(graph.cached()) == 1
    del robot
    gc.collect()
    assert graph.cached() == [] and graph.GRAPHS["dead"] == 1
    assert g.loop.graph.body is None                # reset


def test_shared_copy_of_equal_cpu_objects():
    """Equal CPU objects get one device copy: small tensors compared by
    value, a large one by identity and version; a changed value, a new
    large tensor or an in-place write gets a new copy, and the copy of a
    large tensor goes with it. ("meta" stands in for the card.)"""
    a, b = arm_7dof(), arm_7dof()
    ra = _tensors.shared_copy(a, "meta")
    assert _tensors.shared_copy(b, "meta") is ra
    assert ra.joint_axis.device.type == "meta"
    assert _tensors.shared_copy(a, "cpu") is not ra
    moved = dataclasses.replace(b, joint_lower=b.joint_lower - 0.1)
    assert _tensors.shared_copy(moved, "meta") is not ra
    b.joint_upper.add_(0.1)                       # in place, new values
    assert _tensors.shared_copy(b, "meta") is not ra
    grid = grid_from_analytic(AnalyticWorld.make(boxes=_BOXES),
                              origin=(-0.2, -0.9, -0.1), shape=(24, 28, 20),
                              resolution=0.06)
    gw = _tensors.shared_copy(grid, "meta")
    assert _tensors.shared_copy(grid, "meta") is gw
    clone = dataclasses.replace(grid, grid=grid.grid.clone())
    assert _tensors.shared_copy(clone, "meta") is not gw  # by identity
    grid.grid.mul_(1.0)                            # a write: new version
    assert _tensors.shared_copy(grid, "meta") is not gw
    n = len(_tensors._SHARED)
    del grid, clone
    gc.collect()
    assert len(_tensors._SHARED) == n - 3


def test_joint_types_come_from_joint_static():
    """FK and RNE take the joint types from joint_static when it is set:
    no read of joint_type, so a robot whose joint_type only the device
    holds is captured; one without joint_static and without a host copy
    runs in the eager loop ("joint_types_on_card")."""
    robot = arm_7dof()
    elsewhere = dataclasses.replace(
        robot, joint_type=robot.joint_type.to("meta"))
    assert joint_types_on_host(robot) and joint_types_on_host(elsewhere)
    q = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (5, 7)).astype(np.float32))
    for a, b in zip(fk_frames(elsewhere, q), fk_frames(robot, q)):
        assert torch.equal(a, b)
    bare = dataclasses.replace(elsewhere, joint_static=None)
    assert not joint_types_on_host(bare)
    world = AnalyticWorld.make(boxes=_BOXES)
    assert graph.eager_reason(torch.device("cpu"), bare,
                              world=world) == "joint_types_on_card"

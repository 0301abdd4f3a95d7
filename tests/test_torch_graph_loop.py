"""The solver's compiled solve on the CPU (tpustomp_torch/engine/graph.py):
the loop's chunks behind IF nodes with the draws inside the graph, the
solve-in and solve-out regions, the per-iteration route of a caller's
noise_fn, and the MPC tick on chunks.

A graph is emulated as in tests/test_torch_graph.py (its `_emulate`): a
capture runs the region's host code once and puts every static buffer
back, a replay runs it again with the kernel counters left as they were,
and an IF node runs its body at a replay only when its condition holds.
Every graphed run is held bitwise to the eager loop (engine/graph.eager())
under the same generator: results, the iteration count, the generator's
state after the solve, and the kernel counters. The card's own checks are
the `chunk` tests of tests/test_torch_cuda.py.
"""

import dataclasses
import math

import jax
import pytest
import torch

from tests.test_torch_graph import (_BASE, _CAPTURING, _assert_same,
                                    _emulate, _gen, _scene7)
from tests.test_torch_mpc_graph import CFG as MPC_CFG
from tests.test_torch_mpc_graph import DT_WORLD, RADIUS, _static
from tests.test_torch_mpc_graph import _states as _mpc_states
from tests.test_torch_plan import _assert_solutions
from tests.test_torch_solver import _ReplayJaxNoise, _configs, _jitter, _scene
from tpustomp.api.plan import plan_batch as j_plan_batch
from tpustomp.api.problem import ProblemSpec as JProblem
from tpustomp_torch import ProblemSpec, plan_batch, plan_timed
from tpustomp_torch._tensors import fields
from tpustomp_torch.api.config import PlannerConfig
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import graph, mpc
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.engine.sampling import DrawPlan, GeneratorNoise
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot.model import arm_7dof

_MODES = {
    "stomp": {},
    "chomp": dict(mode="chomp", learning_rate=0.3),
    "hmc": dict(mode="chomp", use_hamiltonian_monte_carlo=True,
                hmc_step_size=0.3, hmc_leapfrog_steps=2,
                hmc_temperature=0.05),
}


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


def _counting(monkeypatch):
    """Every evaluator call counts as the card's wrapper counts its launch
    (on the CPU the plain version runs and counts nothing)."""
    real_rows = tsolver._obstacle_rows

    def counted(robot, world, cfg, fulls, *a, **kw):
        tr.LAUNCHES["rollout_analytic"] += 1
        tr.LAYOUTS["time_major" if kw.get("time_major") else
                   "candidate_major"] += 1
        return real_rows(robot, world, cfg, fulls, *a, **kw)

    monkeypatch.setattr(tsolver, "_obstacle_rows", counted)


def _counters():
    return dict(tr.LAUNCHES), dict(tr.LAYOUTS)


def _start(cfg, scene, seed=3):
    """(step, initial state, generator) of a CPU solve of the scene's
    (_scene7's) three queries, its goals wrapped."""
    robot, world, prob = scene
    q0 = torch.as_tensor(prob.q0)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")
    QN, state = tsolver._init_batch(robot, cfg, q0, torch.as_tensor(prob.qN))
    gen = _gen(seed)
    hmc = cfg.mode == "chomp" and cfg.use_hamiltonian_monte_carlo
    noise = GeneratorNoise(gen, 7, 3, cfg.num_rollouts, cfg.num_timesteps,
                           "cpu", hmc=hmc)
    step = tsolver.make_step(robot, world, cfg, ops, q0, QN, noise)
    return step, state, gen


def _run(cfg, limits, eager: bool, scene):
    """run_until over the successive iteration limits (a resumed run, as
    plan_timed's chunks): (states, counts, generator state, counters,
    GRAPHS)."""
    tr.reset_launches()
    graph.reset_counts()
    step, state, gen = _start(cfg, scene)
    states, counts, count = [], [], 0
    for limit in limits:
        if eager:
            with graph.eager():
                state, count = tsolver.run_until(step, state, limit, count)
        else:
            state, count = tsolver.run_until(step, state, limit, count)
        states.append(state)
        counts.append(count)
    return states, counts, gen.get_state(), _counters(), dict(graph.GRAPHS)


def _same_states(a, b):
    for x, y in zip(fields(a), fields(b)):
        assert torch.equal(x, y)


def _check_route(eager, graphed, hit=False):
    """Two _run results agree: states, counts, generator, counters; the
    graphed run's iterations all ran in chunks (past the eager ones a
    miss runs before its capture)."""
    for a, b in zip(eager[0], graphed[0]):
        _same_states(a, b)
    assert eager[1] == graphed[1]
    assert torch.equal(eager[2], graphed[2])
    assert eager[3] == graphed[3]
    ran = eager[4]["eager:requested"]
    g = graphed[4]
    settled = g.get("eager:first_iteration", 0) + g.get("eager:param_read", 0)
    assert g.get("chunk", 0) + settled == ran
    assert g.get("chunk", 0) > 0
    assert not hit or settled == 0
    assert not any(k.startswith("per_iteration") for k in g)


@pytest.mark.parametrize("mode", list(_MODES))
def test_chunks_are_bitwise_the_eager_loop(emulated, monkeypatch, mode):
    """STOMP, CHOMP and HMC: the chunk route (a miss that captures, then a
    hit) equals the eager loop in every state field, the count, the
    generator's state after the solve and the kernel counters."""
    _counting(monkeypatch)
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 12, **_MODES[mode]})
    limits, scene = [cfg.max_iterations], _scene7()
    ref = _run(cfg, limits, True, scene)
    _check_route(ref, _run(cfg, limits, False, scene))
    _check_route(ref, _run(cfg, limits, False, scene), hit=True)


def test_a_solve_that_ends_mid_chunk(emulated, monkeypatch):
    """A solve whose rows finish (collision-free stop) inside a chunk: the
    device skips the rest of the chunk's bodies, and the host reads the
    condition at most ceil(iterations / k) + 1 times."""
    _counting(monkeypatch)
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 40,
                           "max_iterations_after_collision_free": 5})
    scene = _scene7()
    ref = _run(cfg, [40], True, scene)
    _run(cfg, [40], False, scene)                     # captures
    got = _run(cfg, [40], False, scene)
    _check_route(ref, got, hit=True)
    n = got[1][-1]
    assert n < 40 and n % graph.CHUNK != 0
    assert got[4]["flag_reads"] <= math.ceil(n / graph.CHUNK) + 1


def test_an_iteration_limit_inside_a_chunk(emulated, monkeypatch):
    """run_until resumed at limits that fall inside chunks (plan_timed's
    wall-clock chunks hand the count on): the same states, counts and
    generator as the eager loop's, and plan_timed's Solution equals the
    eager one."""
    _counting(monkeypatch)
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 20})
    limits, scene = [3, 5, 14, 20], _scene7()
    ref = _run(cfg, limits, True, scene)
    _check_route(ref, _run(cfg, limits, False, scene))
    _check_route(ref, _run(cfg, limits, False, scene), hit=True)
    robot, world, prob = scene

    def timed():
        return plan_timed(robot, world, ProblemSpec(q0=prob.q0[0],
                                                    qN=prob.qN[0]),
                          cfg, device="cpu", generator=_gen(),
                          chunk_iterations=3)

    with graph.eager():
        want = timed()
    _assert_same(timed(), want)


@pytest.mark.parametrize("chunk", [graph.CHUNK, 3])
def test_compacted_chunks(emulated, monkeypatch, chunk):
    """solve_batch_compacted with chunk = k and below it: the full batch's
    init and finalize are regions of its entry (chunks of `chunk`), each
    chunk is one replay of a graph of `chunk` iterations, and the done
    mask read after it the host's one read of the chunk. Bitwise the eager
    loop, the generator too."""
    _counting(monkeypatch)
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**{**_BASE, "max_iterations": 20,
                           "max_iterations_after_collision_free": 2})
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")

    def compacted():
        tr.reset_launches()
        graph.reset_counts()
        gen = _gen()
        noise = GeneratorNoise(gen, 7, 3, cfg.num_rollouts,
                               cfg.num_timesteps, "cpu")
        sol = tsolver.solve_batch_compacted(
            robot, world, cfg, ops, torch.as_tensor(prob.q0),
            torch.as_tensor(prob.qN), noise, chunk=chunk, min_bucket=1)
        return sol, gen.get_state(), _counters(), dict(graph.GRAPHS)

    with graph.eager():
        ref = compacted()
    for _ in range(2):
        got = compacted()
        _assert_same(got[0], ref[0])
        assert torch.equal(got[1], ref[1]) and got[2] == ref[2]
        g = got[3]
        assert g["chunk"] > 0 and not any(k.startswith("per_iteration")
                                          for k in g)
        assert 0 < g["flag_reads"] <= g["replayed"]
    (entry,) = [e for e in graph.cached() if e["batch"] == (3, 7)]
    assert entry["k"] == chunk
    assert {"solve_in", "solve_out"} <= set(entry["regions"])


@pytest.mark.parametrize("max_iterations", [graph.CHUNK, graph.CHUNK + 3])
def test_mpc_episodes_on_chunks(emulated, monkeypatch, max_iterations):
    """A 6-tick episode whose solve fits one chunk (max_iterations = k) and
    one that takes two: bitwise the eager episode in every MPCState field,
    the generator after it, the default noise's used and padded draws and
    the kernel counters; a second episode hits the tick and reads nothing
    until its copy-out."""
    _counting(monkeypatch)
    cfg = MPC_CFG.replace(max_iterations=max_iterations)
    robot, static = arm_7dof(), _static("analytic")

    def episode():
        tr.reset_launches()
        graph.reset_counts()
        monkeypatch.setattr(mpc, "NOISE_DRAWS", {"used": 0, "padded": 0})
        gen = _gen(3)
        out = mpc.run_mpc_batch(robot, cfg, _mpc_states(), RADIUS, 6,
                                DT_WORLD, static_world=static, device="cpu",
                                generator=gen)
        return (out, gen.get_state(), dict(mpc.NOISE_DRAWS), _counters(),
                dict(graph.GRAPHS))

    with graph.eager():
        ref = episode()
    assert ref[2]["padded"] > 0
    for hit in (False, True):
        got = episode()
        for f in dataclasses.fields(got[0]):
            assert torch.equal(getattr(got[0], f.name),
                               getattr(ref[0], f.name)), f.name
        assert torch.equal(got[1], ref[1])
        assert got[2] == ref[2] and got[3] == ref[3]
        assert got[4]["chunk"] > 0
        assert not any(k.startswith("per_iteration") for k in got[4])
        if hit:
            assert got[4].get("flag_reads", 0) == 0
            assert got[4]["replayed"] == 6 * (2 + math.ceil(
                max_iterations / graph.CHUNK))


def test_a_callers_noise_fn_takes_the_per_iteration_route(emulated):
    """A noise_fn without a DrawPlan (a caller's own draws, as the parity
    tests' replayed JAX key chain) replays one iteration a replay, counted
    as "per_iteration:noise_fn"; per_iteration() asks for that route with
    the default noise ("per_iteration:requested"). Both are bitwise the
    eager loop."""
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**_BASE)

    def own_noise():
        gen = _gen()
        noise = GeneratorNoise(gen, 7, 3, cfg.num_rollouts,
                               cfg.num_timesteps, "cpu")
        return plan_batch(robot, world, prob, cfg, device="cpu",
                          noise_fn=lambda it, active: noise(it, active))

    with graph.eager():
        ref = own_noise()
    graph.reset_counts()
    _assert_same(own_noise(), ref)
    assert graph.GRAPHS["per_iteration:noise_fn"] > 0
    assert graph.GRAPHS["chunk"] == 0
    assert graph.route("stomp", lambda it, active: None) == (
        "per_iteration:noise_fn")
    graph.reset_counts()
    with graph.per_iteration():
        got = plan_batch(robot, world, prob, cfg, device="cpu",
                         generator=_gen())
    with graph.eager():
        _assert_same(got, plan_batch(robot, world, prob, cfg, device="cpu",
                                     generator=_gen()))
    assert graph.GRAPHS["per_iteration:requested"] > 0
    assert graph.GRAPHS["chunk"] == 0


class _Injected(_ReplayJaxNoise):
    """The replayed JAX key chain with a DrawPlan, so the solve takes the
    chunk route; the test puts its draws into the bodies."""

    def draw_plan(self):
        d, K, N = self.shape
        B = self.keys.shape[0]
        return DrawPlan(torch.Generator(), ((d, B, K, N),), 0, B)


def test_replayed_jax_draws_through_the_chunk_bodies(emulated, monkeypatch):
    """plan_batch on the chunk route with each body's draw replaced by the
    JAX key chain's for that iteration (the count and active rows the body
    sees on the device): the whole slice against the JAX package, to the
    tolerances of tests/test_torch_plan.py."""
    cj, ct = _configs()
    jr, jw, robot, world = _scene()
    q0, qN = _jitter(3, 0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref = j_plan_batch(jr, jw, JProblem(q0=q0, qN=qN), cj, keys=keys)
    noise = _Injected(keys, 7, ct.num_rollouts, ct.num_timesteps)

    def injected(g):
        if _CAPTURING:              # a capture records; it draws nothing
            return g.draws[0]
        g.draws[0].copy_(noise(int(g.ctl[1]), ~g.state.done))
        return g.draws[0]

    monkeypatch.setattr(graph.Loop, "draw", injected)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), ct,
                     device="cpu", noise_fn=noise)
    assert graph.GRAPHS["chunk"] > 0
    _assert_solutions(got, ref)


def test_state_layout_is_init_states():
    """solver.state_layout (a graphed solve's key before any state) is the
    layout of the state init_state makes, with and without metrics."""
    robot = arm_7dof()
    for record in (True, False):
        cfg = PlannerConfig(**{**_BASE, "record_metrics": record})
        _, state = tsolver._init_batch(robot, cfg, torch.zeros(5, 7),
                                       torch.ones(5, 7))
        assert tsolver.state_layout(cfg, 5, 7) == graph.layout(state)


def test_solve_in_and_out_are_regions(emulated, monkeypatch):
    """A graphed plan_batch's entry holds its loop, solve-in and solve-out
    (with restarts, the choice of the best); a second call replays all
    three and runs no eager iteration; a warm start gets a solve-in of its
    own. Bitwise the eager solves."""
    _counting(monkeypatch)
    robot, world, prob = _scene7()
    cfg = PlannerConfig(**{**_BASE, "num_restarts": 2})

    def solve():
        return plan_batch(robot, world, prob, cfg, device="cpu",
                          generator=_gen())

    with graph.eager():
        ref = solve()
    _assert_same(solve(), ref)
    (entry,) = graph.cached()
    assert set(entry["regions"]) == {"loop", "solve_in",
                                     "solve_out:restarts=2"}
    graph.reset_counts()
    _assert_same(solve(), ref)
    assert graph.GRAPHS["captured"] == 0
    assert not any(k.startswith("eager") for k in graph.GRAPHS)
    regions = graph.cached()[0]["regions"]
    assert regions["solve_in"]["replays"] == 1
    assert regions["solve_out:restarts=2"]["replays"] == 1

    q0 = torch.as_tensor(prob.q0)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, "cpu")
    theta0 = torch.linspace(0, 1, 6 * 16 * 7).reshape(6, 16, 7) * 0.01 + \
        q0.repeat_interleave(2, 0)[:, None]

    def warm():
        noise = GeneratorNoise(_gen(), 7, 6, cfg.num_rollouts,
                               cfg.num_timesteps, "cpu")
        return tsolver.solve_batch(
            robot, world, cfg, ops, q0.repeat_interleave(2, 0),
            torch.as_tensor(prob.qN).repeat_interleave(2, 0), noise,
            theta0=theta0)

    with graph.eager():
        want = warm()
    _assert_same(warm(), want)
    _assert_same(warm(), want)
    assert any("solve_in:theta0" in e["regions"] for e in graph.cached())

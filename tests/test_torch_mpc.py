"""The port's batched MPC (engine/mpc.py) and its solver plumbing (warm
start theta0, per-scenario worlds) against the JAX package, under the same
noise: the port's noise_fn replays the JAX key chain (per tick
vmap(split)(state.key) -> (key, sub); then solve_batch's per-iteration
split of sub for active rows, tests/test_torch_solver.py).

The JAX side runs with the Pallas evaluator in interpret mode
(obstacle_backend="pallas", pallas_interpret=True): K3 with
per_cand_world=True, and K5 + _grid_finish's per_cand branch over a voxel
static world. The port runs on the CPU (the plain evaluator). Tolerances:
q, theta and sphere_center atol 1e-5 after 6 ticks; collided, reached_tick
and steps equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpustomp.api.config as jcfg
from tpustomp.dynamics.device import device_ops as j_device_ops
from tpustomp.engine import mpc as jmpc
from tpustomp.engine import solver as jsolver
from tpustomp.robot import model as jmodel
from tpustomp.world.edt import grid_from_analytic
from tpustomp.world.sdf import AnalyticWorld as JWorld
from tpustomp.world.sdf import CompositeWorld as JComposite
from tests.test_torch_plan import _assert_solutions
from tests.test_torch_solver import (_ReplayJaxNoise, _configs, _fields,
                                     _jitter, _scene)
import tpustomp_torch.api.config as tcfg
from tpustomp_torch import convert
from tpustomp_torch.engine import mpc as tmpc
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.world import sdf as tsdf

@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after): the problems are
    small, and the suite runs several test processes per core, where
    torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q0 = np.array([-0.56, 1.65], np.float32)
QN = np.array([1.16, -1.46], np.float32)
TICKS, DT_WORLD = 6, 0.1
RADIUS = np.asarray([0.25], np.float32)


def _mpc_configs(**kw):
    """The JAX package's MPC test config (tests/integration/test_mpc.py),
    through its Pallas kernels in interpret mode."""
    cj = jcfg.PlannerConfig(
        num_timesteps=20, duration=2.1, num_rollouts=8,
        noise=jcfg.NoiseConfig(stddev=0.25, decay=1.0, num_rollouts_reused=2),
        weights=jcfg.CostWeights(obstacle=1.0, smoothness=0.1),
        collision_clearance=0.1, max_iterations=8,
        max_iterations_after_collision_free=2, record_metrics=False,
        obstacle_backend="pallas", pallas_interpret=True, **kw)
    ct = tcfg.from_dict({**jcfg.to_dict(cj), "pallas_interpret": False})
    return cj, ct


def _robots():
    jr = jmodel.planar_2r(body_radius=0.05)
    return jr, convert.robot_from_numpy(_fields(jr))


def _jax_states(jr, cj, B, seed=1):
    """B scenarios: obstacles sweeping toward the arm's path; for B >= 4,
    row 2 starts near its goal (the flush guard and the reached latch
    engage) and row 3 with the obstacle on the arm (a collision)."""
    rng = np.random.default_rng(seed)
    centers = np.tile([[2.4, -0.6, 0.0]], (B, 1, 1)).astype(np.float32)
    centers += rng.uniform(-0.1, 0.1, centers.shape).astype(np.float32)
    vels = np.tile([[-0.15, 0.25, 0.0]], (B, 1, 1)).astype(np.float32)
    q0 = np.tile(Q0, (B, 1))
    if B >= 4:
        q0[2] = QN + np.float32(0.03)
        centers[3, 0] = (1.0, 0.0, 0.0)        # on link 1 at q = 0
        q0[3] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(
        lambda a, c, v, k: jmpc.init_mpc(jr, cj, a, QN, c, v, k)
    )(jnp.asarray(q0), jnp.asarray(centers), jnp.asarray(vels), keys)


class _ReplayJaxMPC:
    """noise_fn(tick, iteration, active) replaying the JAX MPC key chain."""

    def __init__(self, keys, d, K, N):
        self.keys, self.dims, self.ticks = keys, (d, K, N), []

    def __call__(self, tick, iteration, active):
        if iteration == 0:                     # a new tick's solve
            self.ticks.append(tick)
            keys = jax.vmap(jax.random.split)(self.keys)
            self.keys = keys[:, 0]
            self.solve = _ReplayJaxNoise(keys[:, 1], *self.dims)
        return self.solve(iteration, active)


def _port_run(states, robot, ct, static_world=None, **kw):
    got = tmpc.run_mpc_batch(
        robot, ct, convert.mpc_state_from_numpy(_fields(states)), RADIUS,
        TICKS, DT_WORLD, static_world=static_world, device="cpu",
        noise_fn=_ReplayJaxMPC(states.key, 2, ct.num_rollouts,
                               ct.num_timesteps), **kw)
    return got


def _assert_states(got, ref, atol=1e-5):
    for f in ("q", "theta", "sphere_center", "qN", "sphere_vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=atol,
                                   rtol=0, err_msg=f)
    for f in ("collided", "reached_tick", "steps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def _static(kind):
    """(JAX static world, port static world): none, an analytic box plus a
    sphere (merged into every scenario's world after its moving spheres),
    or that box voxelized (the CompositeWorld grid)."""
    box = JWorld.make(boxes=[((1.3, 1.0, 0.0), (0.25, 0.25, 0.4))],
                      spheres=[((-1.2, 1.2, 0.0), 0.15)])
    if kind == "none":
        return None, None
    if kind == "analytic":
        return box, convert.world_from_numpy(_fields(box))
    grid = grid_from_analytic(JWorld.make(boxes=[((1.3, 1.0, 0.0),
                                                  (0.25, 0.25, 0.4))]),
                              origin=(-2.5, -2.5, -0.5), shape=(50, 50, 12),
                              resolution=0.1)
    return grid, convert.grid_from_numpy(_fields(grid))


@pytest.mark.parametrize("kind", ["none", "analytic", "grid"])
def test_run_mpc_batch_matches_jax(kind):
    """B=4 scenarios, 6 ticks, per-scenario moving spheres over no static
    world, an analytic one and a voxel one."""
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    js, ts = _static(kind)
    states = _jax_states(jr, cj, 4)
    ref = jmpc.run_mpc_batch(jr, cj, states, jnp.asarray(RADIUS), TICKS,
                             DT_WORLD, static_world=js)
    got = _port_run(states, robot, ct, ts)
    _assert_states(got, ref)
    assert got.steps.tolist() == [TICKS] * 4
    # the episode covers both outcomes the state latches
    assert bool(got.collided[3]) and not bool(got.collided[:3].any())
    assert int(got.reached_tick[2]) >= 1
    np.testing.assert_allclose(
        got.sphere_center.numpy(),
        np.asarray(states.sphere_center) + TICKS * DT_WORLD * np.asarray(
            states.sphere_vel), atol=1e-5)


def test_run_mpc_is_run_mpc_batch_row():
    """run_mpc on one scenario equals row 0 of run_mpc_batch under the same
    noise, and the ticks reach noise_fn in order."""
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    states = _jax_states(jr, cj, 1)
    batch = _port_run(states, robot, ct)
    noise = _ReplayJaxMPC(states.key, 2, ct.num_rollouts, ct.num_timesteps)
    one = tmpc.run_mpc(
        robot, ct, convert.mpc_state_from_numpy(
            {k: v[0] for k, v in _fields(states).items()}),
        RADIUS, TICKS, DT_WORLD, device="cpu", noise_fn=noise)
    assert one.q.shape == (2,) and one.theta.shape == (20, 2)
    assert noise.ticks == list(range(TICKS))
    for f in dataclasses.fields(one):
        torch.testing.assert_close(getattr(one, f.name),
                                   getattr(batch, f.name)[0], rtol=0, atol=0)


def test_goal_flush_and_reached_match_jax():
    """The flush guard (tests/integration/test_mpc.py:223-260): from a far
    obstacle the flush reaches the goal exactly, the reached tick latches
    as in JAX, and the selection seam takes the warm start only near the
    goal with a clear margin."""
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    near = QN + np.float32(0.2)
    js = jmpc.init_mpc(jr, cj, near, QN, np.array([[50.0, 50.0, 0.0]],
                                                   np.float32),
                       np.zeros((1, 3), np.float32), jax.random.PRNGKey(3))
    states = jax.tree.map(lambda x: x[None], js)
    ticks = cj.num_timesteps + 2
    ref = jmpc.run_mpc_batch(jr, cj, states, jnp.asarray([0.1]), ticks, 0.1)
    noise = _ReplayJaxMPC(states.key, 2, ct.num_rollouts, ct.num_timesteps)
    got = tmpc.run_mpc_batch(robot, ct,
                             convert.mpc_state_from_numpy(_fields(states)),
                             [0.1], ticks, 0.1, device="cpu", noise_fn=noise)
    _assert_states(got, ref)
    assert float((got.q - got.qN).abs().max()) == 0.0
    assert 1 <= int(got.reached_tick[0]) <= ticks

    theta_r = torch.ones(4, 2) * 7.0
    theta_f = torch.zeros(4, 2)
    close, far = torch.zeros(2), torch.tensor([3.0, 0.0])
    goal = torch.zeros(2)

    def pick(q, m):
        return tmpc._apply_flush(theta_r, theta_f, q, goal,
                                 torch.tensor(m), ct, 0.5)

    assert torch.equal(pick(close, 0.2), theta_f)
    assert torch.equal(pick(close, -0.01), theta_r)
    assert torch.equal(pick(far, 0.2), theta_r)


def test_tick_world_batch_matches_jax():
    """The tick's per-scenario world (moving spheres first, then the static
    spheres and boxes broadcast per row; a GridSDF as a composite's shared
    grid) and the per-row sdf against JAX vmap(sdf)."""
    from tpustomp.world.sdf import sdf as jsdf_fn

    rng = np.random.default_rng(0)
    B = 3
    centers = rng.uniform(-1, 1, (B, 2, 3)).astype(np.float32)
    radius = np.asarray([0.2, 0.3], np.float32)
    pts = rng.uniform(-2, 2, (B, 5, 3)).astype(np.float32)
    for kind in ("none", "analytic", "grid"):
        js, ts = _static(kind)
        jw = jmpc._tick_world_batch(jnp.asarray(centers), jnp.asarray(radius),
                                    js)
        tw = tmpc._tick_world_batch(torch.from_numpy(centers),
                                    torch.from_numpy(radius), ts)
        assert tsdf.world_rows(tw) == B
        jo = jw.overlay if isinstance(jw, JComposite) else jw
        to = tw.overlay if isinstance(tw, tsdf.CompositeWorld) else tw
        for f in ("sphere_center", "sphere_radius", "box_center",
                  "box_half"):
            np.testing.assert_array_equal(getattr(to, f).numpy(),
                                          np.asarray(getattr(jo, f)))
        axes = JComposite(grid=None, overlay=0) if kind == "grid" else 0
        ref = jax.vmap(jsdf_fn, in_axes=(axes, 0))(jw, jnp.asarray(pts))
        np.testing.assert_allclose(tsdf.sdf(tw, torch.from_numpy(pts)),
                                   np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["analytic", "composite"])
def test_solve_batch_warm_start_per_scenario_world_matches_jax(kind):
    """solve_batch(theta0=, world_batched=True) on arm_7dof (B=3, C=33):
    each scenario in its own world (the tabletop plus its own sphere; or
    the voxel tabletop with a per-scenario overlay sphere), warm-started
    from a perturbed min-jerk plan."""
    cj, ct = _configs()
    jr, jw, robot, world = _scene()
    B, N = 3, ct.num_timesteps
    q0, qN = _jitter(B, 2)
    rng = np.random.default_rng(4)
    centers = np.stack([rng.uniform(0.3, 0.6, B), rng.uniform(-0.3, 0.3, B),
                        rng.uniform(0.5, 0.8, B)], 1)[:, None].astype(
        np.float32)
    radii = np.full((B, 1), 0.1, np.float32)
    if kind == "analytic":
        leaves = dict(
            sphere_center=centers, sphere_radius=radii,
            box_center=np.broadcast_to(np.asarray(jw.box_center),
                                       (B, 2, 3)).copy(),
            box_half=np.broadcast_to(np.asarray(jw.box_half),
                                     (B, 2, 3)).copy())
        jworld = JWorld(**{k: jnp.asarray(v) for k, v in leaves.items()})
        tworld = convert.world_from_numpy(leaves)
    else:
        from tests.test_torch_plan import _grid_scene
        _, jg, _, tg = _grid_scene("grid")
        leaves = dict(sphere_center=centers, sphere_radius=radii,
                      box_center=np.zeros((B, 0, 3), np.float32),
                      box_half=np.zeros((B, 0, 3), np.float32))
        jworld = JComposite(grid=jg, overlay=JWorld(
            **{k: jnp.asarray(v) for k, v in leaves.items()}))
        tworld = convert.composite_from_numpy(_fields(jg), leaves)
    theta0 = (np.asarray(jax.vmap(lambda a, b: jsolver.min_jerk_init(
        a, b, N))(jnp.asarray(q0), jnp.asarray(qN)))
              + rng.normal(0, 0.02, (B, N, 7))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    ops_j = j_device_ops(N, cj.dt, cj.smoothness)
    ref = jsolver.solve_batch(jr, jworld, None, cj, ops_j, jnp.asarray(q0),
                              jnp.asarray(qN), keys,
                              theta0=jnp.asarray(theta0), world_batched=True)
    got = tsolver.solve_batch(
        robot, tworld, ct, convert.ops_from_numpy(_fields(ops_j)),
        torch.from_numpy(q0), torch.from_numpy(qN),
        _ReplayJaxNoise(keys, 7, ct.num_rollouts, N),
        theta0=torch.from_numpy(theta0), world_batched=True)
    _assert_solutions(got, ref)
    with pytest.raises(ValueError, match="world_batched=False"):
        tsolver.solve_batch(robot, tworld, ct,
                            convert.ops_from_numpy(_fields(ops_j)),
                            torch.from_numpy(q0), torch.from_numpy(qN),
                            _ReplayJaxNoise(keys, 7, ct.num_rollouts, N))


def _clean_and_faulty(ct, robot, states, fault, noise):
    """The same episode unchunked and chunked with a fault hook, from one
    generator seed, or from one numpy noise bank indexed by (tick,
    iteration)."""
    def source():
        if noise == "generator":
            return dict(generator=torch.Generator().manual_seed(7))
        z = np.random.default_rng(7).standard_normal(
            (TICKS, ct.max_iterations, 2, states.q.shape[0],
             ct.num_rollouts, ct.num_timesteps)).astype(np.float32)
        return dict(noise_fn=lambda t, it, active: torch.from_numpy(z[t, it]))

    kw = dict(static_world=None, device="cpu")
    clean = tmpc.run_mpc_batch(robot, ct, states, RADIUS, TICKS, DT_WORLD,
                               **source(), **kw)
    rec = tmpc.run_mpc_resilient(robot, ct, states, RADIUS, TICKS, DT_WORLD,
                                 chunk_ticks=3, _fault_hook=fault,
                                 **source(), **kw)
    return clean, rec


@pytest.mark.parametrize("noise", ["generator", "noise_fn"])
def test_run_mpc_resilient_recovers_bitwise(noise):
    """Scenarios 2 and 5 corrupted in the first chunk (as a dead dispatch
    leaves them) are recovered by replaying the full batch from the
    snapshot with the generator's state (or the noise_fn at the chunk's
    ticks): the result equals the clean unchunked run bit for bit."""
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    states = convert.mpc_state_from_numpy(_fields(_jax_states(jr, cj, 8)))
    hits = []

    def fault(chunk_idx, out):
        if chunk_idx == 0:
            hits.append(chunk_idx)
            out.theta[2] = float("nan")
            out.q[5] = float("nan")
            out.steps[6] = 0                   # finite garbage
        return out

    clean, rec = _clean_and_faulty(ct, robot, states, fault, noise)
    assert hits == [0]
    for f in dataclasses.fields(rec):
        torch.testing.assert_close(getattr(rec, f.name),
                                   getattr(clean, f.name), rtol=0, atol=0)


def test_run_mpc_resilient_gives_up_on_persistent_failure():
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    states = convert.mpc_state_from_numpy(_fields(_jax_states(jr, cj, 8)))
    states.theta[1, 0, 0] = float("nan")       # poisons every re-dispatch
    with pytest.raises(RuntimeError, match=r"scenarios \[1\].*unhealthy"):
        tmpc.run_mpc_resilient(robot, ct, states, RADIUS, 3, DT_WORLD,
                               chunk_ticks=3, max_retries=1, device="cpu")


def test_mpc_state_from_numpy_and_refusals():
    cj, ct = _mpc_configs()
    jr, robot = _robots()
    js = _jax_states(jr, cj, 2)
    ts = convert.mpc_state_from_numpy(_fields(js))
    assert ts.steps.dtype == torch.int32 and ts.collided.dtype == torch.bool
    tinit = tmpc.init_mpc(robot, ct, np.tile(Q0, (2, 1)), np.tile(QN, (2, 1)),
                          np.asarray(js.sphere_center),
                          np.asarray(js.sphere_vel))
    np.testing.assert_allclose(tinit.theta.numpy(), np.asarray(js.theta),
                               atol=1e-5)
    assert tinit.reached_tick.tolist() == [-1, -1]
    if not torch.cuda.is_available():     # no device: the card, or raise
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmpc.run_mpc_batch(robot, ct, ts, RADIUS, 1, DT_WORLD)
    with pytest.raises(NotImplementedError, match="static_world"):
        tmpc.run_mpc_batch(robot, ct, ts, RADIUS, 1, DT_WORLD,
                           static_world=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mode"):
        tmpc.run_mpc_batch(robot, ct.replace(mode="chomp"), ts, RADIUS, 1,
                           DT_WORLD, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmpc.run_mpc_batch(robot, ct, ts, RADIUS, 1, DT_WORLD,
                               device="cuda")

"""Batched MPC replanning with moving obstacles (BASELINE config 5; port of
``tpustomp/engine/mpc.py``).

Every control tick, for all B scenarios at once:
  1. advance the world (each scenario's spheres move; no EDT rebuild),
  2. execute the first waypoint of the current plan (q <- theta[0]),
  3. warm-start theta by shifting the plan one step toward the goal, and
  4. re-solve with a small iteration budget (solver.solve_batch with one
     world row per scenario: the evaluator's per-candidate-world kernels),
  5. near the goal, keep the shifted plan if it is collision-free
     (GOAL_FLUSH), and check the executed segment for collisions.

Differences from the JAX package, by design:
  - No jit/scan/vmap: the tick loop is a Python loop, the batch axis is
    written out, and `run_mpc` is `run_mpc_batch` at B=1 (as `plan` is
    `plan_batch` at B=1). On the card a tick replays CUDA graphs, the
    counterpart of the compiled `lax.scan` body: `_Tick`, an entry of
    engine/graph.py's cache (graph.Entry), opened, loaded and captured
    through that module's interface (graph.entry, graph.load,
    graph.ready, graph.capture). This module keeps what is the tick's:
    its regions before the solve (steps 1-3 and the solver's initial
    state) and after it (the solve's finalize and step 5), and the
    generator arithmetic of its draws; the loop between them is
    graph.py's (graph.Loop). With the default noise the loop is
    ceil(max_iterations / graph.CHUNK) chunk replays whose condition and
    draws are on the device, so an episode makes no host read between its
    load and its copy-out; a caller's noise_fn keeps the draw on the host
    and one replay and flag read an iteration. The static world is an
    input of the entry (its values loaded at each episode), so a grid
    edited between chunks of ticks replays the cached tick. The eager
    tick runs in graph.eager_reason's cases.
  - `MPCState` carries no PRNG key. Noise is an argument: by default one
    ``torch.randn`` [d, B, K, N] per solver iteration from an explicit
    generator (engine/sampling.draw_z; `_TickDraws`: exactly
    cfg.max_iterations draws per tick), or ``noise_fn(tick, iteration,
    active) -> z``, through which tests replay the JAX key chain.
  - The draw is batch-level (like the JAX package's prng_impl="rbg"), so
    `run_mpc_resilient` recovers by replaying the FULL batch from the
    snapshot, generator state included, and keeping the failed rows.
  - `run_mpc_sharded` runs this rank's shard of the batch
    (engine/distributed.py): the draw is the global batch's, cut to the
    shard's rows, so results do not depend on the sharding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpustomp_torch._tensors import (clone_with_mirrors, fields,
                                     map_tensors, shared_copy, to_device)
from tpustomp_torch.api.config import PlannerConfig, check_supported
from tpustomp_torch.api.plan import _resolve_device, resolve_backend
from tpustomp_torch.dynamics.device import DeviceOps, device_ops
from tpustomp_torch.engine import graph, solver
from tpustomp_torch.engine.distributed import Mesh, make_mesh
from tpustomp_torch.engine.sampling import (DrawPlan, draw_plan, draw_z,
                                            shard_noise)
from tpustomp_torch.engine.trajectory import min_jerk_init, wrap_goal
from tpustomp_torch.robot.fk import body_positions
from tpustomp_torch.robot.model import RobotSpec, check_joint_static
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import (AnalyticWorld, CompositeWorld, GridSDF,
                                      sdf)

# noise_fn(tick, iteration, active [B] bool) -> z [d, B, K, N]
MPCNoiseFn = Callable[[int, int, torch.Tensor], torch.Tensor]

# Interpolation samples per executed q -> q_next segment in the collision
# check (the segment's end included; its start was checked the tick before).
_SEGMENT_CHECK_SAMPLES = 4

# A scenario counts as reached the first tick its executed configuration is
# within GOAL_EPS (rad, per-joint inf-norm) of the goal.
GOAL_EPS = 0.05

# Near-goal flush guard (rad, 2-norm): within it, the warm-start plan (the
# previous plan shifted toward the goal) is executed instead of the replan
# whenever its margin clears the collision threshold; the replan re-spreads
# the remaining motion over the full horizon and stalls short of the goal
# (the JAX package's mpc.py:89-104). None disables it.
GOAL_FLUSH = 0.5

# The default noise's draws in this process (_TickDraws): "used" reached a
# solver iteration, "padded" were skipped to keep the stream at
# cfg.max_iterations draws per tick after a tick's solve stopped early
# (drawn and discarded in the eager loop; on the graphed route a move of
# the generator's offset, with no draw).
NOISE_DRAWS = {"used": 0, "padded": 0}


@dataclass(frozen=True)
class MPCState:
    """Replanning state; the batched functions take a leading [B] on every
    field, `run_mpc` one scenario's state without it."""

    q: torch.Tensor              # [B, d] current configuration
    qN: torch.Tensor             # [B, d] goal
    theta: torch.Tensor          # [B, N, d] current plan (free waypoints)
    sphere_center: torch.Tensor  # [B, S, 3] moving obstacle positions
    sphere_vel: torch.Tensor     # [B, S, 3] obstacle velocities
    steps: torch.Tensor          # [B] int32 ticks executed
    collided: torch.Tensor       # [B] bool: an executed segment hit
    reached_tick: torch.Tensor   # [B] int32 first tick within GOAL_EPS, or -1

    def to(self, device) -> "MPCState":
        with tracing.request("state.copy", to=device):
            return to_device(self, device)


def _f32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)                # a copy: never read-only
    return torch.as_tensor(x, dtype=torch.float32)


def init_mpc(robot: RobotSpec, cfg: PlannerConfig, q0, qN, sphere_center,
             sphere_vel) -> MPCState:
    """Initial state: q0/qN [..., d], spheres [..., S, 3] (any leading
    batch axes, none for one scenario), on q0's device. The goal is wrapped
    once against q0 (continuous joints), so every replan and the warm-start
    shift share it; the plan starts as the min-jerk trajectory."""
    with tracing.request("mpc.init") as s:
        q0 = _f32(q0)
        dev = q0.device
        qN = wrap_goal(q0, _f32(qN).to(dev), robot.joint_limited.to(dev))
        batch = q0.shape[:-1]
        s.set(B=batch.numel(), device=dev)
        return MPCState(
            q=q0,
            qN=qN,
            theta=min_jerk_init(q0, qN, cfg.num_timesteps),
            sphere_center=_f32(sphere_center).to(dev),
            sphere_vel=_f32(sphere_vel).to(dev),
            steps=torch.zeros(batch, dtype=torch.int32, device=dev),
            collided=torch.zeros(batch, dtype=torch.bool, device=dev),
            reached_tick=torch.full(batch, -1, dtype=torch.int32,
                                    device=dev),
        )


def _shift_warm_start(theta: torch.Tensor, qN: torch.Tensor) -> torch.Tensor:
    """Shift each plan one waypoint toward its goal (execute-and-slide):
    theta [B, N, d], qN [B, d]."""
    return torch.cat([theta[:, 1:], qN[:, None]], dim=1)


def _tick_world_batch(centers: torch.Tensor, sphere_radius: torch.Tensor,
                      static_world):
    """The tick's world, one row per scenario: the moving spheres
    (centers [B, S, 3], one radius per sphere), then

    - static_world=None: nothing more;
    - an AnalyticWorld: its spheres after the moving ones and its boxes,
      the same in every row (broadcast, not copied);
    - a GridSDF: the shared grid of a CompositeWorld whose overlay rows are
      the moving spheres."""
    B = centers.shape[0]
    rad = sphere_radius.expand((B,) + sphere_radius.shape)
    none = centers.new_zeros((B, 0, 3))
    moving = AnalyticWorld(sphere_center=centers, sphere_radius=rad,
                           box_center=none, box_half=none)
    if static_world is None:
        return moving
    if isinstance(static_world, GridSDF):
        return CompositeWorld(grid=static_world, overlay=moving)

    def bcast(x):
        return x.expand((B,) + x.shape)

    return AnalyticWorld(
        sphere_center=torch.cat(
            [centers, bcast(static_world.sphere_center)], dim=1),
        sphere_radius=torch.cat(
            [rad, bcast(static_world.sphere_radius)], dim=1),
        box_center=bcast(static_world.box_center),
        box_half=bcast(static_world.box_half))


def _probe_world(static_world):
    """A world of the kind each tick builds, for resolve_backend; refuses
    a static world of another kind."""
    if not isinstance(static_world, (type(None), AnalyticWorld, GridSDF)):
        raise NotImplementedError(
            f"static_world {type(static_world).__name__}: MPC takes None, an "
            "AnalyticWorld or a GridSDF")
    moving = AnalyticWorld.make(spheres=[((0.0, 0.0, 0.0), 1.0)])
    if isinstance(static_world, GridSDF):
        return CompositeWorld(grid=static_world, overlay=moving)
    return moving


def _flush_margin_batch(robot, worldB, q_next, qN, theta0,
                        cfg: PlannerConfig) -> torch.Tensor:
    """Margins [B] of the warm-start plans, each in its own world: one
    evaluator call over B rows (the per-candidate kernel on CUDA)."""
    fulls = torch.cat([q_next[:, None], theta0, qN[:, None]], dim=1)
    _, margin = solver._obstacle_rows(robot, worldB, cfg, fulls)
    return margin


def _apply_flush(theta_replan, theta0, q_next, qN, margin,
                 cfg: PlannerConfig, goal_flush: float) -> torch.Tensor:
    """Per scenario, the warm-start plan theta0 where the configuration is
    within goal_flush of the goal and theta0's margin clears the collision
    threshold, else the replan. q_next/qN [..., d], margin [...]."""
    err = torch.sqrt(torch.sum((q_next - qN) ** 2, dim=-1))
    use = (err < goal_flush) & (margin > cfg.collision_threshold)
    shape = use.shape + (1,) * (theta_replan.dim() - use.dim())
    return torch.where(use.reshape(shape), theta0, theta_replan)


def _update_reached(reached_tick, q_next, qN, steps, goal_eps: float):
    """Latch steps + 1 the first time |q_next - qN|inf < goal_eps."""
    err = torch.amax(torch.abs(q_next - qN), dim=-1)
    now = err < goal_eps
    return torch.where((reached_tick < 0) & now, steps + 1, reached_tick)


def _segment_margin(robot, worldB, q, q_next) -> torch.Tensor:
    """Min clearance [B] along each executed segment q -> q_next, at
    _SEGMENT_CHECK_SAMPLES points (its start excluded)."""
    alphas = torch.linspace(0.0, 1.0, _SEGMENT_CHECK_SAMPLES + 1,
                            device=q.device)[1:]
    qs = q[:, None, :] + alphas[None, :, None] * (q_next - q)[:, None, :]
    x = body_positions(robot, qs)                          # [B, 4, nb, 3]
    return torch.amin(sdf(worldB, x) - robot.body_radius, dim=(1, 2))


@dataclass(frozen=True)
class _TickIn:
    """What a tick computes before its solve: the moved spheres [B, S, 3],
    the tick's world (one row per scenario), the executed configuration
    q_next (the solve's start), the warm start theta0, the wrapped goal
    QN and the solver's initial state."""

    centers: torch.Tensor
    world: object
    q_next: torch.Tensor
    theta0: torch.Tensor
    QN: torch.Tensor
    state: solver.SolverState


def _tick_in(robot, cfg: PlannerConfig, state: MPCState, radius,
             world_dt: float, static_world) -> _TickIn:
    """Steps 1-3 of a tick and the solver's initial state (solve_batch's
    _init_batch)."""
    centers = state.sphere_center + state.sphere_vel * world_dt
    world = _tick_world_batch(centers, radius, static_world)
    q_next = state.theta[:, 0]
    theta0 = _shift_warm_start(state.theta, state.qN)
    QN, start = solver._init_batch(robot, cfg, q_next, state.qN, theta0)
    return _TickIn(centers, world, q_next, theta0, QN, start)


def _tick_out(robot, cfg: PlannerConfig, ops: DeviceOps, state: MPCState,
              tin: _TickIn, final: solver.SolverState, goal_eps: float,
              goal_flush: float | None) -> MPCState:
    """The solve's finalize and step 5: the next MPCState from the tick's
    input `state`, what _tick_in computed and the solve's last state."""
    sol = solver.finalize(robot, tin.world, cfg, ops, tin.q_next, tin.QN,
                          final)
    theta_new = sol.trajectory[:, 1:-1]
    if goal_flush is not None:
        fm = _flush_margin_batch(robot, tin.world, tin.q_next, state.qN,
                                 tin.theta0, cfg)
        theta_new = _apply_flush(theta_new, tin.theta0, tin.q_next, state.qN,
                                 fm, cfg, goal_flush)
    margin = _segment_margin(robot, tin.world, state.q, tin.q_next)
    return dataclasses.replace(
        state,
        q=tin.q_next,
        theta=theta_new,
        sphere_center=tin.centers,
        steps=state.steps + 1,
        collided=state.collided | (margin <= 0.0),
        reached_tick=_update_reached(state.reached_tick, tin.q_next,
                                     state.qN, state.steps, goal_eps),
    )


def _eager_tick(robot, cfg, ops, state, radius, world_dt, noise_fn,
                static_world, goal_eps, goal_flush) -> MPCState:
    """One tick, launch by launch: _tick_in, solve_batch's loop
    (solver.run_until, which takes its own graph or eager path) and
    _tick_out."""
    tin = _tick_in(robot, cfg, state, radius, world_dt, static_world)
    solver._check_batch(cfg, None, tin.q_next, tin.world, True, None)
    step = solver.make_step(robot, tin.world, cfg, ops, tin.q_next, tin.QN,
                            noise_fn, world_batched=True)
    final, _ = solver.run_until(step, tin.state, cfg.max_iterations)
    return _tick_out(robot, cfg, ops, state, tin, final, goal_eps,
                     goal_flush)


def _copy(dst, src) -> None:
    """src's tensors into dst's, field by field through nested dataclasses
    (a tensor that is dst's own is left as it is)."""
    for a, b in zip(fields(dst), fields(src)):
        if isinstance(a, torch.Tensor):
            if a is not b:
                a.copy_(b)
        elif dataclasses.is_dataclass(a):
            _copy(a, b)


@dataclasses.dataclass(eq=False, kw_only=True)
class _Tick(graph.Entry):
    """A graphed tick: an engine/graph.py entry of three regions over
    static buffers. "tick_in" (:meth:`tick_in`) computes _tick_in from the
    static MPCState `state` and `radius` into `tin`, whose world, q_next,
    QN and state are the loop's buffers; "loop" replays `n` chunks a tick
    (route "chunk": no host read) or once an iteration; "tick_out"
    (:meth:`tick_out`) writes _tick_out into `state` and adds the tick's
    iterations to `total`. Between ticks the state stays in its buffers:
    an episode loads it once and copies it out once. The regions run over
    the entry's own robot, DeviceOps and static world (`world`, the
    entry's input, loaded at each episode)."""

    cfg: PlannerConfig
    world_dt: float
    goal_eps: float
    goal_flush: float | None
    state: MPCState
    radius: torch.Tensor
    tin: _TickIn
    n: int                    # chunk replays a tick
    total: torch.Tensor       # int32 []: iterations the ticks ran

    def tick_in(self) -> None:
        _copy(self.tin, _tick_in(self.robot, self.cfg, self.state,
                                 self.radius, self.world_dt, self.world))
        torch.logical_not(self.loop.state.done, out=self.loop.active)
        self.loop.ctl[1].zero_()

    def tick_out(self) -> None:
        _copy(self.state, _tick_out(self.robot, self.cfg, self.ops,
                                    self.state, self.tin, self.loop.state,
                                    self.goal_eps, self.goal_flush))
        self.total.add_(self.loop.ctl[1])

    def buffers(self) -> list:
        return [*fields(self.state), self.radius, self.tin.centers,
                self.tin.theta0, self.total, *self.loop.buffers()]


def _first_tick(robot, cfg, ops, state, radius, world_dt, static_world,
                goal_eps, goal_flush, source) -> _Tick:
    """The entry of a miss, built by running tick 0 as its warm-up over its
    buffers: _tick_in eagerly, the solve's eager iterations, the loop's
    capture and its replays (graph.ready), _tick_out eagerly (both on the
    capture stream, whose cuBLAS workspace they set up), then tick-in and
    tick-out captured. Its state after tick 0 is in its static state, and
    the default noise's stream at tick 1's first draw."""
    own = clone_with_mirrors
    robot, ops = own(robot), own(ops)
    static_world = None if static_world is None else own(static_world)
    state, radius = map_tensors(state, torch.clone), radius.clone()
    dev = state.q.device
    tin = graph.eagerly(dev, lambda: _tick_in(
        robot, cfg, state, radius, world_dt, static_world))
    solver._check_batch(cfg, None, tin.q_next, tin.world, True, None)
    step = solver.make_step(robot, tin.world, cfg, ops, tin.q_next, tin.QN,
                            _TickNoise(source, 0), world_batched=True)
    loop = graph.Loop.over(step, tin.state,
                           min(graph.CHUNK, max(cfg.max_iterations, 1)),
                           own=lambda x: x)
    tick = _Tick(
        kind="mpc_tick", device=dev, batch=tuple(state.q.shape),
        robot=robot, ops=ops, world=static_world, loop=loop,
        parts=dict(tick_in=graph.Region(region="tick-in"), loop=loop,
                   tick_out=graph.Region(region="tick-out")),
        cfg=cfg, world_dt=world_dt, goal_eps=goal_eps,
        goal_flush=goal_flush, state=state, radius=radius,
        n=-(-cfg.max_iterations // loop.k),
        total=torch.zeros((), dtype=torch.int32, device=dev),
        tin=_TickIn(tin.centers.clone(), loop.step.world, loop.Q0,
                    tin.theta0.clone(), loop.QN, loop.state))
    used = NOISE_DRAWS["used"]
    _, count, over = graph.ready(tick, True, step, tin.state,
                                 cfg.max_iterations, keep=True)
    if not over:
        count = graph.Handle(step, entry=tick).run(cfg.max_iterations, count)
    if isinstance(source, _TickDraws) and loop.route == "chunk":
        # the chunks' draws came from the graph: tick 0 drew `count`
        NOISE_DRAWS["used"] = used + count
        source.drawn = count
    graph.eagerly(dev, lambda: tick.tick_out() or ())
    graph.capture(tick.parts["tick_in"], dev, tick.tick_in)
    graph.capture(tick.parts["tick_out"], dev, tick.tick_out)
    return tick


def _chunk_ticks(tick: _Tick, first: int, num_ticks: int, draws) -> None:
    """Ticks first..num_ticks-1 on the chunk route: per tick one replay of
    tick-in, `n` chunk replays and one of tick-out, and no host read. The
    loop's generator starts at tick `first`'s first draw of the default
    noise `draws`, and moves exactly max_iterations draws a tick."""
    g, per_tick = tick.loop, draws.per_tick
    g.gen.set_state(draws.generator.get_state())
    _skip(g, first * per_tick - draws.drawn)
    g.limit.fill_(tick.cfg.max_iterations)
    tick.total.zero_()
    for t in range(first, num_ticks):
        with tracing.span("mpc.tick", device=True, tick=t):
            tick.parts["tick_in"].replay()
            for _ in range(tick.n):
                g.replay()
            # the chunks moved the generator n·k draws; a tick moves
            # per_tick
            if g.gen.device.type == "cuda":
                _skip(g, per_tick - tick.n * g.k)
            else:
                _skip(g, per_tick - int(g.ctl[1]))
            tick.parts["tick_out"].replay()


def _skip(g: graph.Loop, n: int) -> None:
    """g's generator moved by n iterations' draws (back where n < 0): its
    offset on the card; on the CPU, where a graph is only emulated and a
    skipped body draws nothing, by n draws made and dropped."""
    if n == 0:
        return
    if g.gen.device.type == "cuda":
        g.gen.set_offset(g.gen.get_offset() + n * g.inc)
        return
    for _ in range(n):
        g.draw()


def _graphed_ticks(robot, cfg, ops, state, radius, world_dt, static_world,
                   goal_eps, goal_flush, num_ticks, source) -> MPCState:
    """num_ticks ticks on the cached _Tick of these inputs (built in tick
    0 on a miss): the state loaded once, then per tick one replay of
    tick-in, the solve's chunk replays (the default noise: no host read)
    or its draws, replays and flag reads (a caller's noise_fn), one replay
    of tick-out; the state copied out once, with one read of the
    iterations the ticks ran."""
    dev = state.q.device
    solver._check_fp32_matmul(dev)
    shapes = tuple((tuple(v.shape), v.dtype)
                   for v in (*fields(state), radius))
    with graph.entry(
            "mpc_tick", cfg, dev, shapes, world_dt, goal_eps, goal_flush,
            robot=robot, ops=ops, world=static_world,
            draws=("stomp", _TickNoise(source, 0)), span=None,
            build=lambda: _first_tick(robot, cfg, ops, state, radius,
                                      world_dt, static_world, goal_eps,
                                      goal_flush, source)) as (tick, new):
        g = tick.loop
        if not new:
            pairs = [*zip(fields(tick.state), fields(state)),
                     (tick.radius, radius)]
            if g.rows is not None:                  # this shard's rows
                pairs.append((g.rows, draw_plan(source).index(dev)))
            graph.load(tick, pairs, static_world, span="mpc.load")
        done = 1 if new else 0
        if g.route == "chunk":
            if done < num_ticks:
                _chunk_ticks(tick, done, num_ticks, source)
                ran = _read_total(tick)
                g.tally(ran)
                _skip_source(g, source, num_ticks, ran)
        else:
            for t in range(done, num_ticks):
                with tracing.span("mpc.tick", device=True, tick=t):
                    tick.parts["tick_in"].replay()
                    if cfg.max_iterations > 0:
                        g.iterate(dataclasses.replace(
                            g.step, noise_fn=_TickNoise(source, t)),
                            cfg.max_iterations, 0)
                    tick.parts["tick_out"].replay()
        with tracing.span("mpc.copy_out"):
            return map_tensors(tick.state, torch.clone)


def _read_total(tick: _Tick) -> int:
    """The iterations the episode's ticks ran: one read, after the last
    tick, through pinned memory."""
    with tracing.span("mpc.total_read"):
        host = torch.zeros((), dtype=torch.int32,
                           pin_memory=tick.total.is_cuda)
        host.copy_(tick.total, non_blocking=True)
        if tick.total.is_cuda:
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        return int(host)


def _skip_source(g: graph.Loop, draws, num_ticks: int, ran: int) -> None:
    """The default noise after chunk ticks up to num_ticks, in which `ran`
    iterations drew: its generator at tick num_ticks's first draw (where
    the eager episode's padding leaves it), the draws since its last
    counted used or padded."""
    skipped = num_ticks * draws.per_tick - draws.drawn
    if g.gen.device.type != "cuda":
        draws.generator.set_state(g.gen.get_state())
    elif skipped:
        draws.generator.set_offset(draws.generator.get_offset()
                                   + skipped * g.inc)
    NOISE_DRAWS["used"] += ran
    NOISE_DRAWS["padded"] += skipped - ran
    draws.drawn = num_ticks * draws.per_tick


def _run_ticks(robot, cfg, ops, state, radius, world_dt, static_world,
               goal_eps, goal_flush, num_ticks, source) -> MPCState:
    """num_ticks ticks from `state` (all on one device); source(tick,
    iteration, active) is the episode's noise (_TickDraws, or a caller's
    cut to this shard). Graphed (_graphed_ticks) but in
    graph.eager_reason's cases for the robot, the static world and
    DeviceOps (the CPU, debug_mode, graph.eager(), ...), where every tick
    runs _eager_tick."""
    why = graph.eager_reason(state.q.device, robot, ops, static_world)
    if why is None and num_ticks > 0:
        return _graphed_ticks(robot, cfg, ops, state, radius, world_dt,
                              static_world, goal_eps, goal_flush, num_ticks,
                              source)
    for t in range(num_ticks):
        with tracing.span("mpc.tick", device=True, tick=t):
            state = _eager_tick(robot, cfg, ops, state, radius, world_dt,
                                _TickNoise(source, t), static_world,
                                goal_eps, goal_flush)
    return state


def mpc_step_batch(robot: RobotSpec, cfg: PlannerConfig, ops: DeviceOps,
                   state: MPCState, sphere_radius: torch.Tensor,
                   world_dt: float, noise_fn: solver.NoiseFn,
                   static_world=None, goal_eps: float = GOAL_EPS,
                   goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """One control tick for every scenario (state fields [B, ...], all on
    one device with robot, ops and static_world). noise_fn(iteration,
    active) feeds this tick's solve. On the card the tick replays its
    cached graphs (_Tick), as every tick of run_mpc_batch does; the state
    returned is the caller's own."""
    return _run_ticks(robot, cfg, ops, state, sphere_radius, world_dt,
                      static_world, goal_eps, goal_flush, 1,
                      lambda t, iteration, active: noise_fn(iteration,
                                                            active))


class _TickDraws:
    """The default noise of an MPC run: per solver iteration one draw_z of
    all `total` rows of the global batch from `generator`, cut to this
    shard's rows [lo, hi). The stream advances exactly cfg.max_iterations
    draws per tick however many iterations the tick's solve ran (`finish`
    pads the last tick), so the draw a scenario gets depends only on (tick,
    iteration): not on how long the other rows of its shard kept a tick
    running, on how the batch is split across ranks, or on where an
    episode is cut into chunks or checkpointed."""

    def __init__(self, generator, cfg: PlannerConfig, d: int, lo: int,
                 hi: int, total: int, device):
        self.generator, self.device = generator, device
        self.shape = (d, total, cfg.num_rollouts, cfg.num_timesteps)
        self.lo, self.hi = lo, hi
        self.per_tick = cfg.max_iterations
        self.drawn = 0

    def _draw(self):
        self.drawn += 1
        return draw_z(self.generator, *self.shape, self.device)

    def _skip_to(self, n: int) -> None:
        while self.drawn < n:
            self._draw()
            NOISE_DRAWS["padded"] += 1

    def finish(self, ticks: int) -> None:
        self._skip_to(ticks * self.per_tick)

    def __call__(self, tick, iteration, active):
        self._skip_to(tick * self.per_tick + iteration)
        NOISE_DRAWS["used"] += 1
        return self._draw()[:, self.lo:self.hi]

    def draw_plan(self) -> DrawPlan:
        """One iteration's draw: the whole batch's z, cut to this shard
        (the tick's chunks draw it in the graph, engine/graph.py)."""
        return DrawPlan(self.generator, (self.shape,), self.lo, self.hi)

    def into(self, tick, iteration, active, out) -> None:
        """The draw a call returns, written into out[0] (a solver graph's
        buffer): drawn there when this shard is the whole batch, else cut
        out and copied."""
        if self.hi - self.lo != self.shape[1]:
            out[0].copy_(self(tick, iteration, active))
            return
        self._skip_to(tick * self.per_tick + iteration)
        NOISE_DRAWS["used"] += 1
        self.drawn += 1
        torch.randn(self.shape, generator=self.generator, out=out[0])


class _TickNoise:
    """Tick `tick`'s solver noise_fn(iteration, active) of an MPC
    noise_fn(tick, iteration, active), with the source's `into` where it
    has one (the default draw: solver.Step.draw_into then draws straight
    into a graph's buffer)."""

    def __init__(self, source, tick: int):
        self.source, self.tick = source, tick
        if hasattr(source, "into"):
            self.into = lambda iteration, active, out: source.into(
                tick, iteration, active, out)

    def __call__(self, iteration, active):
        return self.source(self.tick, iteration, active)

    def draw_plan(self) -> DrawPlan | None:
        return draw_plan(self.source)


def run_mpc_batch(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                  sphere_radius, num_ticks: int, world_dt: float, *,
                  static_world=None, goal_eps: float = GOAL_EPS,
                  goal_flush: float | None = GOAL_FLUSH, device="cuda",
                  generator: torch.Generator | None = None,
                  noise_fn: MPCNoiseFn | None = None) -> MPCState:
    """Run `num_ticks` control ticks over B scenarios (state fields [B, ...]);
    returns the final state on `device`.

    Runs on the card unless device="cpu", as plan_batch. sphere_radius [S]
    is shared by every scenario's moving spheres. static_world: None, an
    AnalyticWorld or a GridSDF (see _tick_world_batch). Noise: by default
    one draw_z per solver iteration from `generator` (seed 0 on `device` if
    None), cfg.max_iterations draws per tick (_TickDraws);
    noise_fn(tick, iteration, active) replaces it. A robot whose
    joint_static disagrees with its joint arrays runs on the runtime chain,
    with a warning (check_joint_static).
    """
    return run_mpc_sharded(robot, cfg, state, sphere_radius, num_ticks,
                           world_dt, mesh=Mesh(0, 1, torch.device(device)),
                           static_world=static_world, goal_eps=goal_eps,
                           goal_flush=goal_flush, generator=generator,
                           noise_fn=noise_fn)


def run_mpc_sharded(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                    sphere_radius, num_ticks: int, world_dt: float, *,
                    mesh: Mesh | None = None, static_world=None,
                    goal_eps: float = GOAL_EPS,
                    goal_flush: float | None = GOAL_FLUSH, device="cuda",
                    generator: torch.Generator | None = None,
                    noise_fn: MPCNoiseFn | None = None) -> MPCState:
    """Batched MPC over the scenario group (BASELINE config 5): `state` is
    this rank's shard (fields [B, ...], every rank the same B), ticked as
    run_mpc_batch ticks on mesh.device (mesh: make_mesh(device) if None);
    no collective runs. The noise is the global batch's, cut to this shard:
    the default draws all world_size·B rows from `generator` (seed it the
    same on every rank); noise_fn(tick, iteration, active) is the global
    batch's and gets the global active mask. At world size 1 the result is
    run_mpc_batch's bitwise."""
    with tracing.request("mpc.run", ticks=num_ticks) as s:
        if mesh is None:
            mesh = make_mesh(device)
        check_supported(cfg)
        device = _resolve_device(mesh.device)
        cfg = resolve_backend(cfg, robot, _probe_world(static_world))
        robot = check_joint_static(robot)
        # a robot or static world on the CPU: the copy made for an equal one
        # before, so repeated episodes replay one cached tick
        robot, state = shared_copy(robot, device), state.to(device)
        if static_world is not None:
            static_world = shared_copy(static_world, device)
        radius = _f32(sphere_radius).to(device)
        B, d = state.q.shape
        s.set(B=B)
        lo, hi, total = mesh.rows(B)
        draws = None
        if noise_fn is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            noise_fn = draws = _TickDraws(generator, cfg, d, lo, hi, total,
                                          device)
        else:
            noise_fn = shard_noise(noise_fn, lo, hi, total)
        ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, device)
        state = _run_ticks(robot, cfg, ops, state, radius, world_dt,
                           static_world, goal_eps, goal_flush, num_ticks,
                           noise_fn)
        if draws is not None:
            draws.finish(num_ticks)
        return state


def run_mpc(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
            sphere_radius, num_ticks: int, world_dt: float, **kw) -> MPCState:
    """One scenario (state fields without the batch axis): run_mpc_batch at
    B=1, with the batch axis removed from the result. Keyword arguments as
    for run_mpc_batch."""
    out = run_mpc_batch(robot, cfg, map_tensors(state, lambda v: v[None]),
                        sphere_radius, num_ticks, world_dt, **kw)
    return map_tensors(out, lambda v: v[0])


def _unhealthy(state_host: MPCState,
               expected_steps: torch.Tensor | None = None) -> np.ndarray:
    """Per-scenario failure mask [B]: a non-finite float field, or a tick
    count other than expected_steps (a dead dispatch that returned finite
    garbage)."""
    bad = np.zeros(state_host.q.shape[0], bool)
    for f in dataclasses.fields(state_host):
        v = getattr(state_host, f.name)
        if v.is_floating_point():
            bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(1).numpy()
    if expected_steps is not None:
        bad |= (state_host.steps != expected_steps).numpy()
    return bad


def _to_host(state: MPCState) -> MPCState:
    """A CPU copy (the recovery snapshot; never aliases device buffers)."""
    return map_tensors(state, lambda v: v.detach().to("cpu", copy=True))


# Device faults a re-dispatch may survive; programming errors (shapes,
# types) are not retried.
_RETRYABLE = (torch.AcceleratorError, torch.OutOfMemoryError)


def run_mpc_resilient(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                      sphere_radius, num_ticks: int, world_dt: float, *,
                      chunk_ticks: int | None = None, max_retries: int = 2,
                      static_world=None, goal_eps: float = GOAL_EPS,
                      goal_flush: float | None = GOAL_FLUSH, device="cuda",
                      generator: torch.Generator | None = None,
                      noise_fn: MPCNoiseFn | None = None,
                      mesh: Mesh | None = None,
                      _fault_hook=None) -> MPCState:
    """Failure-detecting MPC loop (the JAX package's run_mpc_resilient,
    mpc.py:462-588): run_mpc_batch on one device, or with a mesh
    run_mpc_sharded on this rank's shard, which it alone recovers.

    - The loop runs in chunks of `chunk_ticks`; before each chunk the state
      is snapshotted to the host, with the generator's state beside it.
    - A chunk that raises a device fault is re-dispatched whole, up to
      `max_retries` times.
    - After each chunk, scenarios with non-finite state or a wrong tick
      count (_unhealthy) are recovered: the FULL batch is replayed from the
      snapshot — same generator state, same ticks — and only the failed
      rows are kept. The draw is batch-level, so a subset replay would give
      those rows other noise; the full replay makes a recovered scenario
      equal a never-failed one bitwise. A noise_fn must be a function of
      its arguments alone for the same to hold.

    `_fault_hook(chunk_idx, state_host) -> state_host` is the test seam that
    corrupts a chunk's result as a dead dispatch would.
    """
    if chunk_ticks is None:
        chunk_ticks = max(1, min(num_ticks, 10))
    if mesh is None:
        mesh = Mesh(0, 1, torch.device(device))
    device = _resolve_device(mesh.device)
    robot = check_joint_static(robot)     # once, not once per chunk
    if noise_fn is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    state = _to_host(state)
    done = chunk_idx = 0
    while done < num_ticks:
        ticks = min(chunk_ticks, num_ticks - done)
        snapshot = state
        gen_state = None if generator is None else generator.get_state()

        def run_chunk(snapshot=snapshot, gen_state=gen_state, ticks=ticks,
                      first=done):
            if generator is not None:
                generator.set_state(gen_state)
            chunk_noise = None if noise_fn is None else (
                lambda t, it, active: noise_fn(first + t, it, active))
            return _to_host(run_mpc_sharded(
                robot, cfg, snapshot, sphere_radius, ticks, world_dt,
                mesh=mesh, static_world=static_world, goal_eps=goal_eps,
                goal_flush=goal_flush, generator=generator,
                noise_fn=chunk_noise))

        for attempt in range(max_retries + 1):
            try:
                out = run_chunk()
                break
            except _RETRYABLE as e:
                print(f"[tpustomp_torch.mpc] chunk {chunk_idx} attempt "
                      f"{attempt} failed: {type(e).__name__}: {e}",
                      flush=True)
                if attempt == max_retries:
                    raise
        if _fault_hook is not None:
            out = _fault_hook(chunk_idx, out)
        expected = snapshot.steps + ticks
        bad = _unhealthy(out, expected)
        for _ in range(max_retries):
            if not bad.any():
                break
            idx = torch.from_numpy(np.flatnonzero(bad))
            redo = run_chunk()
            out = map_tensors(out, lambda v: v.clone())
            for f in dataclasses.fields(out):
                getattr(out, f.name)[idx] = getattr(redo, f.name)[idx]
            bad = _unhealthy(out, expected)
        if bad.any():
            raise RuntimeError(
                f"MPC scenarios {np.flatnonzero(bad).tolist()} still "
                f"unhealthy after {max_retries} re-dispatches "
                f"(chunk {chunk_idx}, ticks {done}..{done + ticks})")
        state = out
        done += ticks
        chunk_idx += 1
    return state.to(device)

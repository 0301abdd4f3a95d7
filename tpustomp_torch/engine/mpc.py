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
    `plan_batch` at B=1).
  - `MPCState` carries no PRNG key. Noise is an argument: by default one
    ``torch.randn`` [d, B, K, N] per solver iteration from an explicit
    generator (engine/sampling.draw_z), or ``noise_fn(tick, iteration,
    active) -> z``, through which tests replay the JAX key chain.
  - The draw is batch-level (like the JAX package's prng_impl="rbg"), so
    `run_mpc_resilient` recovers by replaying the FULL batch from the
    snapshot, generator state included, and keeping the failed rows.
  - `run_mpc_sharded` (the scenario mesh) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpustomp_torch._tensors import map_tensors, to_device
from tpustomp_torch.api.config import PlannerConfig, check_supported
from tpustomp_torch.api.plan import _resolve_device, resolve_backend
from tpustomp_torch.dynamics.device import DeviceOps, device_ops
from tpustomp_torch.engine import solver
from tpustomp_torch.engine.sampling import draw_z
from tpustomp_torch.engine.trajectory import min_jerk_init, wrap_goal
from tpustomp_torch.robot.fk import body_positions
from tpustomp_torch.robot.model import RobotSpec, check_joint_static
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
    q0 = _f32(q0)
    dev = q0.device
    qN = wrap_goal(q0, _f32(qN).to(dev), robot.joint_limited.to(dev))
    batch = q0.shape[:-1]
    return MPCState(
        q=q0,
        qN=qN,
        theta=min_jerk_init(q0, qN, cfg.num_timesteps),
        sphere_center=_f32(sphere_center).to(dev),
        sphere_vel=_f32(sphere_vel).to(dev),
        steps=torch.zeros(batch, dtype=torch.int32, device=dev),
        collided=torch.zeros(batch, dtype=torch.bool, device=dev),
        reached_tick=torch.full(batch, -1, dtype=torch.int32, device=dev),
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


def mpc_step_batch(robot: RobotSpec, cfg: PlannerConfig, ops: DeviceOps,
                   state: MPCState, sphere_radius: torch.Tensor,
                   world_dt: float, noise_fn: solver.NoiseFn,
                   static_world=None, goal_eps: float = GOAL_EPS,
                   goal_flush: float | None = GOAL_FLUSH) -> MPCState:
    """One control tick for every scenario (state fields [B, ...], all on
    one device with robot, ops and static_world). noise_fn(iteration,
    active) feeds this tick's solve."""
    centers = state.sphere_center + state.sphere_vel * world_dt
    worldB = _tick_world_batch(centers, sphere_radius, static_world)
    q_next = state.theta[:, 0]
    theta0 = _shift_warm_start(state.theta, state.qN)
    sol = solver.solve_batch(robot, worldB, cfg, ops, q_next, state.qN,
                             noise_fn, theta0=theta0, world_batched=True)
    theta_new = sol.trajectory[:, 1:-1]
    if goal_flush is not None:
        fm = _flush_margin_batch(robot, worldB, q_next, state.qN, theta0, cfg)
        theta_new = _apply_flush(theta_new, theta0, q_next, state.qN, fm,
                                 cfg, goal_flush)
    margin = _segment_margin(robot, worldB, state.q, q_next)
    return dataclasses.replace(
        state,
        q=q_next,
        theta=theta_new,
        sphere_center=centers,
        steps=state.steps + 1,
        collided=state.collided | (margin <= 0.0),
        reached_tick=_update_reached(state.reached_tick, q_next, state.qN,
                                     state.steps, goal_eps),
    )


def run_mpc_batch(robot: RobotSpec, cfg: PlannerConfig, state: MPCState,
                  sphere_radius, num_ticks: int, world_dt: float, *,
                  static_world=None, goal_eps: float = GOAL_EPS,
                  goal_flush: float | None = GOAL_FLUSH, device,
                  generator: torch.Generator | None = None,
                  noise_fn: MPCNoiseFn | None = None) -> MPCState:
    """Run `num_ticks` control ticks over B scenarios (state fields [B, ...]);
    returns the final state on `device`.

    `device` is required, as for plan_batch. sphere_radius [S] is shared by
    every scenario's moving spheres. static_world: None, an AnalyticWorld or
    a GridSDF (see _tick_world_batch). Noise: by default one draw_z per
    solver iteration from `generator` (seed 0 on `device` if None);
    noise_fn(tick, iteration, active) replaces it. A robot whose
    joint_static disagrees with its joint arrays runs on the runtime chain,
    with a warning (check_joint_static).
    """
    check_supported(cfg)
    device = _resolve_device(device)
    cfg = resolve_backend(cfg, robot, _probe_world(static_world))
    robot = check_joint_static(robot)
    robot, state = robot.to(device), state.to(device)
    if static_world is not None:
        static_world = static_world.to(device)
    radius = _f32(sphere_radius).to(device)
    B, d = state.q.shape
    if noise_fn is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        K, N = cfg.num_rollouts, cfg.num_timesteps

        def noise_fn(tick, iteration, active):
            return draw_z(generator, d, B, K, N, device)

    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, device)
    for t in range(num_ticks):
        state = mpc_step_batch(
            robot, cfg, ops, state, radius, world_dt,
            lambda it, active, t=t: noise_fn(t, it, active), static_world,
            goal_eps, goal_flush)
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
                      goal_flush: float | None = GOAL_FLUSH, device,
                      generator: torch.Generator | None = None,
                      noise_fn: MPCNoiseFn | None = None,
                      _fault_hook=None) -> MPCState:
    """Failure-detecting MPC driver on one device (the JAX package's
    run_mpc_resilient, mpc.py:462-588).

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
    device = _resolve_device(device)
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
            return _to_host(run_mpc_batch(
                robot, cfg, snapshot, sphere_radius, ticks, world_dt,
                static_world=static_world, goal_eps=goal_eps,
                goal_flush=goal_flush, device=device, generator=generator,
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

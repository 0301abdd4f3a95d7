"""Batched STOMP solver (port of ``tpustomp/engine/solver.py``'s batched
time-major path: ``make_step_batch_tm``, ``solve_batch``, ``finalize``,
``select_best``).

One iteration, for all B scenarios at once:
sample → assemble candidates → clip to joint limits → ONE fused evaluator
call over all B·C candidates (kernels/rollout.py) → smoothness rows → PI²
softmax and M-smoothed update → limit projection → rollout reuse → A.12
bookkeeping → freeze finished scenarios. Tensors stay in the evaluator's
time-major layout [N, d, B, C]; only O(B·N·d) tensors are transposed.

Differences from the JAX package, by design:
  - No jit/vmap: batch axes are written out, and the loop is a Python
    `while` over "any scenario still active" with one host sync per
    iteration.
  - The noise source is an argument, not state: ``noise_fn(iteration,
    active) -> z [d, B, K, N]`` (default: one ``torch.randn`` per iteration
    from an explicit generator, engine/sampling.draw_z). Tests pass a
    noise_fn that replays the JAX key chain.
  - Finished scenarios' candidate rows are skipped inside the evaluator
    kernel (row_active) and their state is frozen by the same select as the
    reference (solver.py:734-738).
  - Per-scenario worlds (world_batched=True, batched MPC) reach the
    evaluator as B world rows with cands_per_row = C, where the reference
    repeats each scenario's world C times (solver.py:507-526).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch

from tpustomp_torch._tensors import map_tensors
from tpustomp_torch.api.config import PlannerConfig, check_supported
from tpustomp_torch.api.problem import IterationMetrics, Solution
from tpustomp_torch.costs.smoothness import smoothness_cost_per_timestep_tm
from tpustomp_torch.dynamics.device import DeviceOps
from tpustomp_torch.engine import pi2
from tpustomp_torch.engine.limits import project_limits
from tpustomp_torch.engine.sampling import sample_noise_tm
from tpustomp_torch.engine.trajectory import (full_trajectory, min_jerk_init,
                                              wrap_goal)
from tpustomp_torch.kernels.rollout import obstacle_cost_batch
from tpustomp_torch.robot.model import RobotSpec
from tpustomp_torch.world.sdf import world_rows

# noise_fn(iteration, active [B] bool) -> z [d, B, K, N] standard normals
NoiseFn = Callable[[int, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class SolverState:
    """Batched solver state; every field has a leading scenario axis [B]."""

    theta: torch.Tensor        # [B, N, d] current free waypoints
    iteration: torch.Tensor    # [B] int32
    best_theta: torch.Tensor   # [B, N, d] best collision-free iterate so far
    best_cost: torch.Tensor    # [B] its total cost (inf while none found)
    found_cf: torch.Tensor     # [B] bool — any collision-free iterate seen
    cf_count: torch.Tensor     # [B] int32 — consecutive collision-free iterations
    done: torch.Tensor         # [B] bool
    reuse_theta: torch.Tensor  # [B, K_reuse, N, d] best rollouts kept
    m_total: torch.Tensor      # [B, max_iterations] (or [B, 0]) metrics
    m_obstacle: torch.Tensor
    m_smooth: torch.Tensor
    m_constraint: torch.Tensor
    m_cf: torch.Tensor


def _check_fp32_matmul(device: torch.device) -> None:
    """The FD smoothness rows cancel catastrophically below fp32; refuse to
    run on CUDA with TF32 (or lower) float32 matmuls enabled."""
    if device.type == "cuda" and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; the smoothness rows "
            "need true fp32: torch.set_float32_matmul_precision('highest')")


def _obstacle_rows(robot, world, cfg: PlannerConfig, fulls, row_active=None,
                   time_major: bool = False, cands_per_row=None):
    """The evaluator (kernels/rollout.obstacle_cost_batch: the CUDA kernel
    for CUDA tensors, its plain version on the CPU). obstacle_backend="xla"
    names the plain path, so it is refused off the CPU: the card never
    silently runs without the kernel."""
    if cfg.obstacle_backend == "xla" and fulls.device.type != "cpu":
        raise ValueError("obstacle_backend='xla' selects the plain "
                         "evaluator, which runs on the CPU only; use 'auto' "
                         "on CUDA")
    return obstacle_cost_batch(robot, world, fulls, cfg.dt,
                               cfg.collision_clearance,
                               row_active=row_active, time_major=time_major,
                               cands_per_row=cands_per_row)


def init_state(robot: RobotSpec, cfg: PlannerConfig, q0: torch.Tensor,
               qN: torch.Tensor, theta0: torch.Tensor | None = None
               ) -> SolverState:
    """Initial state for q0/qN [B, d]: the warm start theta0 [B, N, d]
    (MPC replanning) or, by default, the min-jerk trajectory (A.1)."""
    N = cfg.num_timesteps
    B, d = q0.shape
    dev = q0.device
    if theta0 is None:
        theta0 = min_jerk_init(q0, qN, N)
    elif theta0.shape != (B, N, d):
        raise ValueError(f"theta0 must be [{B}, {N}, {d}], got "
                         f"{tuple(theta0.shape)}")
    n_m = cfg.max_iterations if cfg.record_metrics else 0
    zeros_m = torch.zeros((B, n_m), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    return SolverState(
        theta=theta0,
        iteration=zero_i,
        best_theta=theta0,
        best_cost=torch.full((B,), math.inf, dtype=torch.float32,
                             device=dev),
        found_cf=false,
        cf_count=zero_i,
        done=false,
        reuse_theta=theta0[:, None].expand(
            B, cfg.noise.num_rollouts_reused, N, d).clone(),
        m_total=zeros_m, m_obstacle=zeros_m, m_smooth=zeros_m,
        m_constraint=zeros_m,
        m_cf=torch.zeros((B, n_m), dtype=torch.bool, device=dev),
    )


def _record(state: SolverState, it, total, parts, cf) -> dict:
    """Per-iteration metrics: row b's column it[b] takes this iteration's
    values. Frozen rows are restored by the caller's select."""
    if state.m_total.shape[1] == 0:        # record_metrics off
        return {}
    col = it.long().clamp(max=state.m_total.shape[1] - 1)[:, None]

    def put(m, v):
        return m.scatter(1, col, v[:, None].to(m.dtype))

    return dict(m_total=put(state.m_total, total),
                m_obstacle=put(state.m_obstacle, parts[0]),
                m_smooth=put(state.m_smooth, parts[1]),
                m_constraint=put(state.m_constraint, parts[2]),
                m_cf=put(state.m_cf, cf))


def _freeze(done: torch.Tensor, old: SolverState,
            new: SolverState) -> SolverState:
    """Rows that were already done keep their old values."""
    def sel(o, n):
        return torch.where(done.reshape((-1,) + (1,) * (n.dim() - 1)), o, n)

    return SolverState(**{f.name: sel(getattr(old, f.name),
                                      getattr(new, f.name))
                          for f in dataclasses.fields(SolverState)})


def make_step_batch_tm(robot: RobotSpec, world, cfg: PlannerConfig,
                       ops: DeviceOps, Q0: torch.Tensor, QN: torch.Tensor,
                       noise_fn: NoiseFn, world_batched: bool = False):
    """One STOMP iteration over B scenarios (Q0/QN [B, d]) in the
    evaluator's time-major layout. Returns step(state, iteration) -> state;
    `iteration` is the batch loop's count, handed to noise_fn.
    world_batched: the world has one row per scenario (world_rows == B)."""
    B, d = Q0.shape
    N = cfg.num_timesteps
    K = cfg.num_rollouts
    Kr = cfg.noise.num_rollouts_reused
    C = 1 + K + Kr
    T = N + 2
    dev = Q0.device
    sigma0 = torch.tensor(cfg.noise_stddevs(d), dtype=torch.float32,
                          device=dev)
    lower, upper, limited = (robot.joint_lower, robot.joint_upper,
                             robot.joint_limited)
    bcast = (slice(None), None, None)                   # [d] -> [d, 1, 1]
    w_obs, w_smooth = cfg.weights.obstacle, cfg.weights.smoothness
    q0_tm = Q0.t()[:, None, :, None].expand(d, 1, B, C)
    qN_tm = QN.t()[:, None, :, None].expand(d, 1, B, C)
    rows = torch.arange(B, device=dev)[:, None]

    def project(theta):
        return project_limits(theta, lower, upper, limited, ops.Rinv,
                              cfg.joint_limit_iterations,
                              cfg.joint_limit_method)

    def step(state: SolverState, iteration: int) -> SolverState:
        active = ~state.done
        # --- propose, time-major -----------------------------------------
        decay = torch.pow(cfg.noise.decay,
                          state.iteration.to(torch.float32))      # [B]
        sigma = sigma0[None, :] * decay[:, None]                  # [B, d]
        z = noise_fn(iteration, active)
        if z.shape != (d, B, K, N):
            raise ValueError(f"noise_fn returned {tuple(z.shape)}, "
                             f"expected {(d, B, K, N)}")
        eps_tm = sample_noise_tm(z, ops.L_sample, sigma)          # [N,d,B,K]
        theta_tm = state.theta.permute(1, 2, 0)                   # [N, d, B]
        cand_tm = torch.cat([theta_tm[..., None],
                             theta_tm[..., None] + eps_tm,
                             state.reuse_theta.permute(2, 3, 0, 1)],
                            dim=3)                                # [N,d,B,C]
        cand_tm = torch.where(
            limited[bcast],
            torch.clamp(cand_tm, lower[bcast], upper[bcast]), cand_tm)

        # --- evaluate: ONE evaluator call over all B·C candidates --------
        full = torch.cat([q0_tm, cand_tm.permute(1, 0, 2, 3), qN_tm],
                         dim=1).reshape(d, T, B * C)              # [d,T,B·C]
        q_obs, margins = _obstacle_rows(
            robot, world, cfg, full,
            row_active=active[:, None].expand(B, C).reshape(B * C),
            time_major=True, cands_per_row=C if world_batched else None)
        q_obs = q_obs.reshape(B, C, T)
        margins = margins.reshape(B, C)
        ctrl_all = smoothness_cost_per_timestep_tm(ops, cand_tm, Q0, QN)
        S_all = w_obs * q_obs
        ctrl_sums = torch.sum(ctrl_all, dim=2)
        totals = torch.sum(S_all, dim=2) + w_smooth * ctrl_sums   # [B, C]

        # --- update (A.9/A.10), time-major ---------------------------------
        S_used = S_all[:, 1:, :]
        if cfg.pi2_include_control_cost:
            S_used = S_used + w_smooth * ctrl_all[:, 1:, :]
        if cfg.pi2_cost_mode == "cumulative":
            S_used = torch.flip(torch.cumsum(torch.flip(S_used, [2]), dim=2),
                                [2])
        delta = pi2.update_tm_cand(cand_tm[..., 1:], theta_tm,
                                   S_used[:, :, 1:-1], ops.M, cfg.pi2_h)
        theta_new = project(state.theta + delta)

        # rollout reuse: the lowest-total-cost noisy candidates (A.3); a
        # stable sort breaks ties by index, as the reference's top_k does
        keep = torch.argsort(totals[:, 1:], dim=1, stable=True)[:, :Kr] + 1
        reuse_new = cand_tm[:, :, rows, keep].permute(2, 3, 0, 1)

        # --- A.12 bookkeeping on the current θ (slot 0) --------------------
        it = state.iteration
        total0 = totals[:, 0]
        cf = margins[:, 0] > cfg.collision_threshold
        cf_count = torch.where(cf, state.cf_count + 1,
                               torch.zeros_like(state.cf_count))
        improved = cf & (total0 < state.best_cost)
        done = ((it + 1 >= cfg.max_iterations)
                | (cf_count >= cfg.max_iterations_after_collision_free))
        parts0 = (torch.sum(q_obs[:, 0, :], dim=1), ctrl_sums[:, 0],
                  torch.zeros_like(total0))
        new = dataclasses.replace(
            state,
            theta=theta_new,
            iteration=it + 1,
            best_theta=torch.where(improved[:, None, None], state.theta,
                                   state.best_theta),
            best_cost=torch.where(improved, total0, state.best_cost),
            found_cf=state.found_cf | cf,
            cf_count=cf_count,
            done=done,
            reuse_theta=reuse_new,
            **_record(state, it, total0, parts0, cf),
        )
        return _freeze(state.done, state, new)

    return step


def _init_batch(robot: RobotSpec, cfg: PlannerConfig, Q0, QN, theta0=None):
    """Wrap goals + build the initial batched state. Returns (QN, state)."""
    QN = wrap_goal(Q0, QN, robot.joint_limited)
    return QN, init_state(robot, cfg, Q0, QN, theta0)


def finalize(robot: RobotSpec, world, cfg: PlannerConfig, ops: DeviceOps,
             Q0, QN, state: SolverState) -> Solution:
    """Assemble the batched Solution: per scenario the best collision-free
    trajectory if one was found, else the final iterate with success=False.
    The returned trajectory is re-evaluated (one evaluator call, B rows; a
    world with B rows evaluates each row against its own world)."""
    ret_theta = torch.where(state.found_cf[:, None, None], state.best_theta,
                            state.theta)
    fulls = full_trajectory(ret_theta, Q0, QN)                    # [B, T, d]
    q_obs, margin = _obstacle_rows(robot, world, cfg, fulls)
    ctrl = smoothness_cost_per_timestep_tm(
        ops, ret_theta.permute(1, 2, 0)[..., None], Q0, QN)[:, 0, :]
    total = (torch.sum(cfg.weights.obstacle * q_obs, dim=1)
             + cfg.weights.smoothness * torch.sum(ctrl, dim=1))
    B, T = fulls.shape[0], fulls.shape[1]
    times = (torch.arange(T, dtype=torch.float32, device=fulls.device)
             * cfg.dt).expand(B, T)
    metrics = IterationMetrics(
        total_cost=state.m_total, obstacle_cost=state.m_obstacle,
        smoothness_cost=state.m_smooth, constraint_cost=state.m_constraint,
        collision_free=state.m_cf) if cfg.record_metrics else None
    return Solution(
        trajectory=fulls,
        times=times,
        success=state.found_cf & (margin > cfg.collision_threshold),
        cost=total,
        iterations=state.iteration,
        metrics=metrics,
    )


def solve_batch(robot: RobotSpec, world, cfg: PlannerConfig, ops: DeviceOps,
                Q0: torch.Tensor, QN: torch.Tensor, noise_fn: NoiseFn,
                theta0: torch.Tensor | None = None,
                world_batched: bool = False) -> Solution:
    """Batched planning (BASELINE config 4): B scenarios to termination.

    Q0/QN [B, d] on the device everything runs on (robot, world and ops
    must be there too). Runs until every scenario is done; each iteration
    launches the evaluator once over all B·C candidates.

    theta0: optional warm start [B, N, d] (MPC replanning).
    world_batched=True: the world's spheres/boxes (a composite's overlay)
    carry a leading [B] scenario axis — each scenario plans in its own
    world (MPC moving obstacles); a composite's grid stays shared.
    """
    check_supported(cfg)
    _check_fp32_matmul(Q0.device)
    rows = world_rows(world)
    if world_batched != (rows is not None) or rows not in (None, Q0.shape[0]):
        raise ValueError(
            f"world_batched={world_batched} needs a world with one row per "
            f"scenario ({Q0.shape[0]}) exactly when True; the world has "
            f"{'no row axis' if rows is None else f'{rows} rows'}")
    QN, state = _init_batch(robot, cfg, Q0, QN, theta0)
    step = make_step_batch_tm(robot, world, cfg, ops, Q0, QN, noise_fn,
                              world_batched)
    iteration = 0
    while not bool(state.done.all()):        # the one host sync per iteration
        state = step(state, iteration)
        iteration += 1
    return finalize(robot, world, cfg, ops, Q0, QN, state)


def select_best(sols: Solution) -> Solution:
    """Pick one Solution per row from a trailing restart axis: fields
    [B, R, ...] -> [B, ...]. Any successful restart beats every failed one;
    ties are broken by lowest total cost."""
    cost = torch.clamp(sols.cost, max=1e18)
    score = torch.where(sols.success, cost, cost + 1e20)
    idx = torch.argmin(score, dim=1)                              # [B]
    rows = torch.arange(idx.shape[0], device=idx.device)
    return map_tensors(sols, lambda v: v[rows, idx])

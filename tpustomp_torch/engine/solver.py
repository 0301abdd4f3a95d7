"""Batched solver (port of ``tpustomp/engine/solver.py``: the time-major
STOMP step ``make_step_batch_tm``, the CHOMP and CHOMP-HMC steps of
``make_step`` with the scenario axis written out, ``HyperParams``, the
resumable runner ``init_state`` / ``run_until`` / ``finalize``,
``solve_batch``, ``solve_batch_compacted``, ``select_best``).

One STOMP iteration, for all B scenarios at once:
sample → assemble candidates → clip to joint limits → ONE fused evaluator
call over all B·C candidates (kernels/rollout.py; with constraints it also
returns the end-effector frame, which feeds costs/constraints.py) → torque
rows if weighted → smoothness rows → PI² softmax and M-smoothed update →
limit projection → rollout reuse → A.12 bookkeeping → freeze finished
scenarios. Tensors stay in the evaluator's time-major layout [N, d, B, C];
only O(B·N·d) tensors are transposed.

One CHOMP iteration: the gradient of every scenario (engine/chomp.py,
plain PyTorch), the update capped per scenario, limit projection, then ONE
evaluator call over the B new trajectories for the bookkeeping. HMC adds a
leapfrog of hmc_leapfrog_steps gradient steps and, with hmc_metropolis,
two more evaluator calls for the accept test.

Differences from the JAX package, by design:
  - No jit/vmap: batch axes are written out. On the CPU the loop is a
    Python `while` over "any scenario still active" with one host sync per
    iteration. On the card a solve replays cached CUDA graphs
    (engine/graph.py), the counterpart of the jitted solve: its init, its
    loop in chunks of iterations whose condition is read on the device,
    and its finalize.
  - The noise source is an argument, not state: ``noise_fn(iteration,
    active) -> z [d, B, K, N]`` (default: one ``torch.randn`` per iteration
    from an explicit generator, engine/sampling.draw_z); for HMC it returns
    (z [d, B, 1, N], u [B]): momentum normals and Metropolis uniforms
    (engine/sampling.draw_hmc). Tests pass a noise_fn that replays the JAX
    key chain.
  - Finished scenarios' candidate rows are skipped inside the evaluator
    kernel (row_active) and their state is frozen by the same select as the
    reference (solver.py:734-738).
  - Per-scenario worlds (world_batched=True, batched MPC) reach the
    evaluator as B world rows with cands_per_row = C, where the reference
    repeats each scenario's world C times (solver.py:507-526).
  - rollout_limit_projection="smooth" stays in the time-major step (the
    reference drops to its scenario-major step for it): all B·C candidates
    go through the same projection as θ, viewed as [B·C, N, d].
  - Compaction needs no pad rows: nothing is compiled per shape, so the
    regrouped batch is exactly the active rows.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpustomp_torch._tensors import map_tensors
from tpustomp_torch.api.config import PlannerConfig, check_supported
from tpustomp_torch.api.problem import IterationMetrics, Solution
from tpustomp_torch.costs.constraints import as_tuple
from tpustomp_torch.costs.smoothness import (smoothness_cost,
                                             smoothness_cost_per_timestep_tm)
from tpustomp_torch.costs.torque import torque_cost
from tpustomp_torch.dynamics.device import DeviceOps
from tpustomp_torch.engine import graph, pi2
from tpustomp_torch.engine.chomp import chomp_gradient
from tpustomp_torch.engine.limits import project_limits
from tpustomp_torch.engine.sampling import (RowNoise, noise_product_tm,
                                            sample_noise_tm)
from tpustomp_torch.engine.trajectory import (full_trajectory, min_jerk_init,
                                              wrap_goal)
from tpustomp_torch.kernels import chomp_grad, propose
from tpustomp_torch.kernels import pi2 as pi2_tail
from tpustomp_torch.kernels.rollout import obstacle_cost_batch
from tpustomp_torch.robot.model import RobotSpec
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import CompositeWorld, world_rows

# noise_fn(iteration, active [B] bool) -> z [d, B, K, N] standard normals;
# for HMC -> (z [d, B, 1, N], u [B] uniforms in [0, 1))
NoiseFn = Callable[[int, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class HyperParams:
    """Per-scenario STOMP hyperparameters (the reference's HyperParams,
    solver.py:48-76): every leaf is [B], or a Python float that broadcasts
    over the batch. A hyperparameter grid then runs as ONE batched solve
    (api/tune.py). `hyper=None` wherever it is accepted means the static
    values of the PlannerConfig.

    noise_scale: multiplier on cfg's per-joint noise stddevs (A.3).
    h:           PI² cost sensitivity (A.9; cfg.pi2_h).
    decay:       per-iteration noise decay (A.3; cfg.noise.decay).
    """

    noise_scale: torch.Tensor | float
    h: torch.Tensor | float
    decay: torch.Tensor | float

    @staticmethod
    def from_config(cfg: PlannerConfig, batch: int) -> "HyperParams":
        """The config's static values as [batch] leaves (parity helper)."""
        def mk(v):
            return torch.full((batch,), v, dtype=torch.float32)

        return HyperParams(noise_scale=mk(1.0), h=mk(cfg.pi2_h),
                           decay=mk(cfg.noise.decay))

    def rows(self, B: int, device) -> "HyperParams":
        """Every leaf as a float32 [B] tensor on `device`."""
        def mk(v):
            v = torch.as_tensor(v, dtype=torch.float32, device=device)
            if v.dim() == 0:
                return v.expand(B)
            if v.shape != (B,):
                raise ValueError(f"HyperParams leaf of shape "
                                 f"{tuple(v.shape)}; expected [] or [{B}]")
            return v

        return HyperParams(noise_scale=mk(self.noise_scale), h=mk(self.h),
                           decay=mk(self.decay))


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
                   time_major: bool = False, cands_per_row=None,
                   constraints=()):
    """The evaluator (kernels/rollout.obstacle_cost_batch: the CUDA kernel
    for CUDA tensors, its plain version on the CPU): (q_obs, margin), and
    the constraints' cost rows q_con when there are constraints (a tuple:
    the kernels' constraint route). obstacle_backend="xla" names the plain
    path, so it is refused off the CPU: the card never silently runs
    without the kernel."""
    if cfg.obstacle_backend == "xla" and fulls.device.type != "cpu":
        raise ValueError("obstacle_backend='xla' selects the plain "
                         "evaluator, which runs on the CPU only; use 'auto' "
                         "on CUDA")
    return obstacle_cost_batch(robot, world, fulls, cfg.dt,
                               cfg.collision_clearance,
                               row_active=row_active, time_major=time_major,
                               cands_per_row=cands_per_row,
                               constraints=constraints or None)


def _add_weighted(S: torch.Tensor, q: torch.Tensor, w: float) -> torch.Tensor:
    """S + w·q. One launch on the card (torch.add's alpha); on the CPU w·q
    is rounded before the sum, as the reference computes it, where
    torch.add's alpha would fuse a multiply-add."""
    if S.device.type == "cpu":
        return S + w * q
    return torch.add(S, q, alpha=w)


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


def _projector(robot: RobotSpec, cfg: PlannerConfig, ops: DeviceOps):
    """theta [B, N, d] -> its joint-limit projection (A.7) under cfg."""
    def project(theta):
        return project_limits(theta, robot.joint_lower, robot.joint_upper,
                              robot.joint_limited, ops.Rinv,
                              cfg.joint_limit_iterations,
                              cfg.joint_limit_method)

    return project


def _bookkeeping(state: SolverState, cfg: PlannerConfig, total, margin):
    """A.12 on one evaluated iterate per scenario: (collision-free,
    consecutive collision-free count, improved on the best, done)."""
    cf = margin > cfg.collision_threshold
    cf_count = torch.where(cf, state.cf_count + 1,
                           torch.zeros_like(state.cf_count))
    improved = cf & (total < state.best_cost)
    done = ((state.iteration + 1 >= cfg.max_iterations)
            | (cf_count >= cfg.max_iterations_after_collision_free))
    return cf, cf_count, improved, done


@dataclass(frozen=True, eq=False)
class Step:
    """One batched iteration, split as JAX's ``while_loop`` body is split
    from its key chain: :meth:`draw` is the noise, ``noise_fn(iteration,
    ~done)``, always run eagerly; ``advance(state, draws)`` is all the rest,
    a function of device tensors alone that reads nothing back to the host
    (engine/graph.py captures it). ``step(state, iteration)`` is one eager
    iteration, ``advance(state, step.draw(iteration, state.done))``; an
    advance with `phases` (CHOMP's) runs them in turn, the first under a
    `chomp.grad` span.

    kind: "stomp" (the time-major STOMP step), "chomp" or "hmc". draws:
    z [d, B, K, N] for STOMP, (z [d, B, 1, N], u [B]) for HMC, None for
    CHOMP. Q0/QN [B, d] (QN wrapped), constraints a tuple, hyper the
    HyperParams as [B] rows on the device or None. advance is built from
    the other fields (:meth:`over` rebuilds it on other tensors, as the
    graph's static buffers and copies)."""

    kind: str
    robot: RobotSpec
    world: object
    cfg: PlannerConfig
    ops: DeviceOps
    Q0: torch.Tensor
    QN: torch.Tensor
    noise_fn: NoiseFn | None
    world_batched: bool = False
    constraints: tuple = ()
    hyper: HyperParams | None = None
    advance: Callable = dataclasses.field(default=None, compare=False,
                                          repr=False)

    def __post_init__(self):
        if self.advance is None:
            object.__setattr__(self, "advance", _ADVANCE[self.kind](self))

    def __call__(self, state: SolverState, iteration: int) -> SolverState:
        phases = getattr(self.advance, "phases", None)
        if phases is None:
            return self.advance(state, self.draw(iteration, state.done))
        grad_u, update = phases
        with tracing.span("chomp.grad", device=True):
            grad = grad_u(state.theta)
        return update(state, grad)

    def over(self, **fields) -> "Step":
        """This step with its advance built on other fields of the same
        shapes (Q0, QN, hyper, robot, world, constraints, ops)."""
        return dataclasses.replace(self, advance=None, **fields)

    def draw_shapes(self) -> tuple:
        """The shapes of what :meth:`draw` returns, as a tuple (one for
        STOMP, two for HMC, none for CHOMP)."""
        B, d = self.Q0.shape
        N = self.cfg.num_timesteps
        if self.kind == "stomp":
            return ((d, B, self.cfg.num_rollouts, N),)
        return ((d, B, 1, N), (B,)) if self.kind == "hmc" else ()

    def draw(self, iteration: int, done: torch.Tensor):
        """noise_fn(iteration, ~done), its shapes checked; None for CHOMP,
        which draws nothing."""
        if self.kind == "chomp":
            return None
        return self._checked(self.noise_fn(iteration, ~done))

    def draw_into(self, iteration: int, active: torch.Tensor,
                  out: tuple) -> None:
        """The draw for the rows `active` written into the tensors `out`
        (draw_shapes): by the noise source itself where it can
        (`noise_fn.into`, the default generator draw), else copied."""
        if self.kind == "chomp":
            return
        into = getattr(self.noise_fn, "into", None)
        if into is not None:
            into(iteration, active, out)
            return
        drawn = self._checked(self.noise_fn(iteration, active))
        for buf, v in zip(out, drawn if self.kind == "hmc" else (drawn,)):
            buf.copy_(v)

    def _checked(self, out):
        shapes = self.draw_shapes()
        if self.kind == "stomp":
            if out.shape != shapes[0]:
                raise ValueError(f"noise_fn returned {tuple(out.shape)}, "
                                 f"expected {shapes[0]}")
            return out
        z, u = out
        if z.shape != shapes[0] or u.shape != shapes[1]:
            raise ValueError(f"HMC noise_fn returned {tuple(z.shape)} and "
                             f"{tuple(u.shape)}, expected {shapes[0]} "
                             f"and {shapes[1]}")
        return z, u


def make_step_batch_tm(robot: RobotSpec, world, cfg: PlannerConfig,
                       ops: DeviceOps, Q0: torch.Tensor, QN: torch.Tensor,
                       noise_fn: NoiseFn, world_batched: bool = False,
                       constraints=None, hyper: HyperParams | None = None
                       ) -> Step:
    """One STOMP iteration over B scenarios (Q0/QN [B, d]) in the
    evaluator's time-major layout: a :class:`Step`, called as
    step(state, iteration) -> state; `iteration` is the batch loop's
    count, handed to noise_fn.
    world_batched: the world has one row per scenario (world_rows == B).
    constraints: their cost rows come from the evaluator (its constraint
    route: the reference's time-major path on the end-effector frame, in
    the kernel); a torque weight adds the RNE rows of every candidate (as
    its scenario-major path does).
    hyper: per-scenario noise_scale / h / decay (HyperParams), or None for
    the config's values."""
    if hyper is not None:
        hyper = hyper.rows(Q0.shape[0], Q0.device)
    return Step("stomp", robot, world, cfg, ops, Q0, QN, noise_fn,
                world_batched, as_tuple(constraints), hyper)


def _stomp_advance(s: Step):
    """advance(state, z) of the time-major STOMP step `s`."""
    robot, world, cfg, ops, Q0, QN = (s.robot, s.world, s.cfg, s.ops, s.Q0,
                                      s.QN)
    cons, hyper = s.constraints, s.hyper
    B, d = Q0.shape
    N = cfg.num_timesteps
    K = cfg.num_rollouts
    Kr = cfg.noise.num_rollouts_reused
    C = 1 + K + Kr
    T = N + 2
    dev = Q0.device
    sigma0 = torch.tensor(cfg.noise_stddevs(d), dtype=torch.float32,
                          device=dev)
    w_obs, w_smooth = cfg.weights.obstacle, cfg.weights.smoothness
    w_con, w_tau = cfg.weights.constraint, cfg.weights.torque
    rows = torch.arange(B, device=dev)[:, None]
    project = _projector(robot, cfg, ops)
    smooth = cfg.rollout_limit_projection == "smooth"
    if dev.type == "cuda":
        pi2_tail.load(dev)
        if not smooth:
            propose.load(dev)
    decay_base = cfg.noise.decay if hyper is None else hyper.decay
    # PI²'s h as a device scalar made here, not a host value copied to the
    # device every iteration (no copy may run inside a captured graph)
    pi2_h = (torch.full((), cfg.pi2_h, dtype=torch.float32, device=dev)
             if hyper is None else hyper.h)

    def advance(state: SolverState, z: torch.Tensor) -> SolverState:
        active = ~state.done
        # --- propose, time-major -----------------------------------------
        decay = torch.pow(decay_base,
                          state.iteration.to(torch.float32))      # [B]
        sigma = sigma0[None, :] * decay[:, None]                  # [B, d]
        if hyper is not None:
            sigma = sigma * hyper.noise_scale[:, None]
        theta_tm = state.theta.permute(1, 2, 0)                   # [N, d, B]
        if smooth:      # θ's projection on every candidate, [B·C, N, d]
            cand_tm = propose.candidates_plain(
                sample_noise_tm(z, ops.L_sample, sigma), state.theta,
                state.reuse_theta)                                # [N,d,B,C]
            cand_tm = project(cand_tm.permute(2, 3, 0, 1).reshape(
                B * C, N, d)).reshape(B, C, N, d).permute(2, 3, 0, 1)
            full = propose.full_plain(cand_tm, Q0, QN)            # [d,T,B·C]
        else:           # one kernel: scale, add, clip and both layouts
            cand_tm, full = propose.propose(
                noise_product_tm(z, ops.L_sample), sigma, state.theta,
                state.reuse_theta, Q0, QN, robot.joint_lower,
                robot.joint_upper, robot.joint_limited)

        # --- evaluate: ONE evaluator call over all B·C candidates --------
        outs = _obstacle_rows(
            robot, world, cfg, full,
            row_active=active[:, None].expand(B, C).reshape(B * C),
            time_major=True, cands_per_row=C if s.world_batched else None,
            constraints=cons)
        q_obs = outs[0].reshape(B, C, T)
        margins = outs[1].reshape(B, C)
        ctrl_all = smoothness_cost_per_timestep_tm(ops, cand_tm, Q0, QN)
        S_all = w_obs * q_obs
        q_con = None
        if cons:
            q_con = outs[2].reshape(B, C, T)
            S_all = _add_weighted(S_all, q_con, w_con)
        if w_tau > 0.0:
            S_all = S_all + w_tau * torque_cost(
                robot, full.permute(2, 1, 0), cfg.dt).reshape(B, C, T)
        ctrl_sums = torch.sum(ctrl_all, dim=2)
        totals = torch.sum(S_all, dim=2) + w_smooth * ctrl_sums   # [B, C]

        # --- update (A.9/A.10), time-major: the cost-to-go, P and the
        # probability-weighted candidates in one kernel on the card -------
        delta = pi2.smooth_tm(pi2_tail.tail(
            S_all, ctrl_all if cfg.pi2_include_control_cost else None,
            w_smooth, cfg.pi2_cost_mode == "cumulative", cand_tm[..., 1:],
            theta_tm, pi2_h), ops.M)
        theta_new = project(state.theta + delta)

        # rollout reuse: the lowest-total-cost noisy candidates (A.3); a
        # stable sort breaks ties by index, as the reference's top_k does
        keep = torch.argsort(totals[:, 1:], dim=1, stable=True)[:, :Kr] + 1
        reuse_new = cand_tm[:, :, rows, keep].permute(2, 3, 0, 1)

        # --- A.12 bookkeeping on the current θ (slot 0) --------------------
        it = state.iteration
        total0 = totals[:, 0]
        cf, cf_count, improved, done = _bookkeeping(state, cfg, total0,
                                                    margins[:, 0])
        parts0 = (torch.sum(q_obs[:, 0, :], dim=1), ctrl_sums[:, 0],
                  torch.zeros_like(total0) if q_con is None
                  else torch.sum(q_con[:, 0, :], dim=1))
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

    return advance


def _init_batch(robot: RobotSpec, cfg: PlannerConfig, Q0, QN, theta0=None):
    """Wrap goals + build the initial batched state. Returns (QN, state)."""
    QN = wrap_goal(Q0, QN, robot.joint_limited)
    return QN, init_state(robot, cfg, Q0, QN, theta0)


def state_layout(cfg: PlannerConfig, B: int, d: int) -> tuple:
    """The (shape, dtype) of every SolverState field init_state makes for
    B scenarios of d joints (a graphed solve's key, before any state)."""
    N, Kr = cfg.num_timesteps, cfg.noise.num_rollouts_reused
    n_m = cfg.max_iterations if cfg.record_metrics else 0
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return (((B, N, d), f32), ((B,), i32), ((B, N, d), f32), ((B,), f32),
            ((B,), b), ((B,), i32), ((B,), b), ((B, Kr, N, d), f32),
            *(((B, n_m), f32),) * 4, ((B, n_m), b))


def run_until(step: Step, state: SolverState, it_limit: int, count: int = 0):
    """Advance `state` with `step` until every row is done or the batch
    loop's count reaches `it_limit` (the reference's run_until, which the
    wall-clock and chunked loops resume). `count` is the number of
    iterations run so far; it is handed on to noise_fn, so a resumed run
    draws what one uninterrupted run would. Returns (state, count).

    engine/graph.run: on the card the loop replays cached CUDA graphs (the
    counterpart of JAX's jitted while_loop), in chunks of iterations with
    the draw in the graph and the loop's condition read on the device, or,
    for a noise_fn that cannot be captured, one replay an iteration; in
    graph.eager_reason's cases (the CPU, utils.tracing.debug_mode,
    tensors moved under inference_mode, graph.eager()) one step(state,
    count) an iteration and one host sync."""
    return graph.run(step, state, it_limit, count)


def _evaluate(robot: RobotSpec, world, constraints, cfg: PlannerConfig,
              ops: DeviceOps, Q0, QN, theta, row_active=None):
    """The reference's per-trajectory ``_evaluate`` for B trajectories at
    once, theta [B, N, d]: ONE evaluator call over the B rows (with the
    constraint route when there are constraints). Returns (full
    trajectories [B, T, d], total cost [B], margin [B], (obstacle,
    smoothness, constraint) sums [B]). A world with B rows evaluates each
    trajectory against its own row. row_active as for the evaluator."""
    cons = as_tuple(constraints)
    fulls = full_trajectory(theta, Q0, QN)                        # [B, T, d]
    outs = _obstacle_rows(robot, world, cfg, fulls, row_active=row_active,
                          constraints=cons)
    q_obs, margin = outs[0], outs[1]
    S = cfg.weights.obstacle * q_obs
    q_con_sum = torch.zeros_like(margin)
    if cons:
        S = _add_weighted(S, outs[2], cfg.weights.constraint)
        q_con_sum = torch.sum(outs[2], dim=1)
    if cfg.weights.torque > 0.0:
        S = S + cfg.weights.torque * torque_cost(robot, fulls, cfg.dt)
    ctrl = smoothness_cost(ops, theta, Q0, QN)
    total = torch.sum(S, dim=1) + cfg.weights.smoothness * ctrl
    return fulls, total, margin, (torch.sum(q_obs, dim=1), ctrl, q_con_sum)


def finalize(robot: RobotSpec, world, cfg: PlannerConfig, ops: DeviceOps,
             Q0, QN, state: SolverState, constraints=None) -> Solution:
    """Assemble the batched Solution: per scenario the best collision-free
    trajectory if one was found, else the final iterate with success=False.
    The returned trajectory is re-evaluated (one evaluator call, B rows; a
    world with B rows evaluates each row against its own world)."""
    ret_theta = torch.where(state.found_cf[:, None, None], state.best_theta,
                            state.theta)
    fulls, total, margin, _ = _evaluate(robot, world, constraints, cfg, ops,
                                        Q0, QN, ret_theta)
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


def make_step_chomp(robot: RobotSpec, world, cfg: PlannerConfig,
                    ops: DeviceOps, Q0: torch.Tensor, QN: torch.Tensor,
                    noise_fn: NoiseFn, constraints=None) -> Step:
    """One CHOMP iteration (or, with use_hamiltonian_monte_carlo, one HMC
    proposal) over B scenarios: the reference's per-scenario chomp_step /
    chomp_hmc_step and finish, with the scenario axis written out. Every
    per-scenario quantity (update cap, temperature, kinetic energy,
    Metropolis test) is reduced over that scenario's [N, d] alone.
    Returns a :class:`Step`, called as step(state, iteration) -> state."""
    return Step("hmc" if cfg.use_hamiltonian_monte_carlo else "chomp", robot,
                world, cfg, ops, Q0, QN, noise_fn,
                constraints=as_tuple(constraints))


def _chomp_parts(s: Step):
    """What the CHOMP and HMC advances share: (cap, total_cost, grad_u,
    finish, project)."""
    robot, world, cfg, ops, Q0, QN = (s.robot, s.world, s.cfg, s.ops, s.Q0,
                                      s.QN)
    cons = s.constraints
    dt, clearance = cfg.dt, cfg.collision_clearance
    w = cfg.weights
    limit = cfg.chomp_joint_update_limit
    grad_kw = dict(use_pseudo_inverse=cfg.use_pseudo_inverse,
                   pinv_ridge=cfg.pseudo_inverse_ridge_factor,
                   gradient_mode=cfg.chomp_gradient_mode, constraints=cons,
                   w_constraint=w.constraint, w_torque=w.torque)

    def cap(delta):
        """Direction-preserving trust region: each scenario's max |δ| to at
        most chomp_joint_update_limit (reference joint_update_limit)."""
        max_d = torch.amax(torch.abs(delta), dim=(1, 2), keepdim=True)
        return torch.clamp(limit / (max_d + 1e-12), max=1.0) * delta

    def total_cost(theta, active):
        return _evaluate(robot, world, cons, cfg, ops, Q0, QN, theta,
                         row_active=active)[1]

    if Q0.device.type == "cuda" and cfg.chomp_gradient_mode != "exact":
        chomp_grad.load(robot, world, Q0[:, None, :])

    def grad_u(theta):
        return chomp_gradient(ops, robot, world, theta, Q0, QN, dt,
                              clearance, w.obstacle, w.smoothness, **grad_kw)

    def finish(state: SolverState, theta_new) -> SolverState:
        _, total, margin, parts = _evaluate(robot, world, cons, cfg, ops,
                                            Q0, QN, theta_new,
                                            row_active=~state.done)
        it = state.iteration
        cf, cf_count, improved, done = _bookkeeping(state, cfg, total, margin)
        new = dataclasses.replace(
            state,
            theta=theta_new,
            iteration=it + 1,
            best_theta=torch.where(improved[:, None, None], theta_new,
                                   state.best_theta),
            best_cost=torch.where(improved, total, state.best_cost),
            found_cf=state.found_cf | cf,
            cf_count=cf_count,
            done=done,
            **_record(state, it, total, parts, cf),
        )
        return _freeze(state.done, state, new)

    return cap, total_cost, grad_u, finish, _projector(robot, cfg, ops)


def _chomp_advance(s: Step):
    """advance(state, None) of the CHOMP step `s`: chomp_delta's update,
    −η·R⁻¹·∇U, capped and projected. Its two phases are
    `advance.phases`: grad_u(theta) -> ∇U, and update(state, ∇U) -> the
    new state; the per-iteration loops run them apart, the gradient under
    a `chomp.grad` span."""
    lr, Rinv = s.cfg.learning_rate, s.ops.Rinv
    cap, _, grad_u, finish, project = _chomp_parts(s)

    def update(state: SolverState, grad: torch.Tensor) -> SolverState:
        delta = -lr * (Rinv @ grad)
        return finish(state, project(state.theta + cap(delta)))

    def advance(state: SolverState, draws=None) -> SolverState:
        return update(state, grad_u(state.theta))

    advance.phases = (grad_u, update)
    return advance


def _hmc_advance(s: Step):
    """advance(state, (z, u)) of the CHOMP-HMC step `s`."""
    cfg, ops = s.cfg, s.ops
    cap, total_cost, grad_u, finish, project = _chomp_parts(s)
    # the reference's float32 scalars, rounded as it rounds them
    eta = float(np.float32(cfg.hmc_step_size))
    kick = float(np.float32(0.5) * np.float32(cfg.hmc_step_size)
                 * np.float32(1.0 / ops.cov_scale))
    half_mass = float(np.float32(0.5) * np.float32(ops.cov_scale))
    decay = torch.tensor(cfg.noise.decay, dtype=torch.float32,
                         device=s.Q0.device)

    def kinetic(v):
        return half_mass * torch.sum(v * (ops.R @ v), dim=(1, 2))

    def advance(state: SolverState, draws) -> SolverState:
        # velocity-form leapfrog with mass c·R (c = ops.cov_scale): the
        # momentum N(0, temp·R⁻¹/c) is what the smooth sampler draws
        z, u = draws
        active = ~state.done
        temp = cfg.hmc_temperature * torch.pow(
            decay, state.iteration.to(torch.float32))              # [B]
        v0 = (torch.einsum("nm,dbm->bnd", ops.L_sample, z[:, :, 0])
              * torch.sqrt(temp)[:, None, None])
        th0 = state.theta
        th, v, g = th0, v0, grad_u(th0)
        for _ in range(cfg.hmc_leapfrog_steps):
            v = v - kick * (ops.Rinv @ g)
            dth = eta * v
            if not cfg.hmc_metropolis:
                dth = cap(dth)
            th = th + dth
            g = grad_u(th)
            v = v - kick * (ops.Rinv @ g)
        if cfg.hmc_metropolis:
            h0 = total_cost(th0, active) + kinetic(v0)
            h1 = total_cost(th, active) + kinetic(v)
            accept = u < torch.exp(-(h1 - h0) / torch.clamp(temp, min=1e-6))
            th = torch.where(accept[:, None, None], th, th0)
        return finish(state, project(th))

    return advance


_ADVANCE = {"stomp": _stomp_advance, "chomp": _chomp_advance,
            "hmc": _hmc_advance}


def _check_batch(cfg: PlannerConfig, constraints, Q0, world,
                 world_batched: bool, hyper) -> None:
    check_supported(cfg, constraints)
    _check_fp32_matmul(Q0.device)
    rows = world_rows(world)
    if world_batched != (rows is not None) or rows not in (None, Q0.shape[0]):
        raise ValueError(
            f"world_batched={world_batched} needs a world with one row per "
            f"scenario ({Q0.shape[0]}) exactly when True; the world has "
            f"{'no row axis' if rows is None else f'{rows} rows'}")
    if world_batched and cfg.mode == "chomp":
        raise NotImplementedError(
            "mode='chomp' with per-scenario worlds (world_batched=True, as "
            "MPC replans) is not ported; the reference's batched CHOMP "
            "plans in one shared world")
    if hyper is not None and cfg.mode != "stomp":
        raise ValueError("HyperParams are STOMP's exploration knobs; "
                         f"mode={cfg.mode!r}")


def make_step(robot: RobotSpec, world, cfg: PlannerConfig, ops: DeviceOps,
              Q0, QN, noise_fn: NoiseFn, world_batched: bool = False,
              constraints=None, hyper: HyperParams | None = None):
    """The batched step of cfg.mode: STOMP (time-major) or CHOMP(-HMC)."""
    if cfg.mode == "chomp":
        return make_step_chomp(robot, world, cfg, ops, Q0, QN, noise_fn,
                               constraints)
    return make_step_batch_tm(robot, world, cfg, ops, Q0, QN, noise_fn,
                              world_batched, constraints, hyper)


def _finish(step: Step, state: SolverState, restarts: int = 1) -> Solution:
    """finalize, and with restarts > 1 the best of each query's restarts
    (rows restart-minor: b·R + r)."""
    sols = finalize(step.robot, step.world, step.cfg, step.ops, step.Q0,
                    step.QN, state, step.constraints)
    return select_restarts(sols, restarts)


def select_restarts(sols: Solution, restarts: int) -> Solution:
    """[B·R, ...] -> [B, ...]: the best of each query's R restarts (rows
    restart-minor), select_best's choice; the Solution itself at R = 1."""
    if restarts == 1:
        return sols
    B = sols.trajectory.shape[0] // restarts
    return select_best(map_tensors(
        sols, lambda v: v.reshape((B, restarts) + v.shape[1:])))


def solve_batch(robot: RobotSpec, world, cfg: PlannerConfig, ops: DeviceOps,
                Q0: torch.Tensor, QN: torch.Tensor, noise_fn: NoiseFn,
                theta0: torch.Tensor | None = None,
                world_batched: bool = False, constraints=None,
                hyper: HyperParams | None = None,
                restarts: int = 1) -> Solution:
    """Batched planning (BASELINE configs 3 and 4): B scenarios to
    termination, with the STOMP or the CHOMP(-HMC) step by cfg.mode.

    Q0/QN [B, d] on the device everything runs on (robot, world, ops and
    constraints must be there too). Runs until every scenario is done; a
    STOMP iteration launches the evaluator once over all B·C candidates, a
    CHOMP iteration once over the B new trajectories.

    theta0: optional warm start [B, N, d] (MPC replanning).
    world_batched=True (STOMP only): the world's spheres/boxes (a
    composite's overlay) carry a leading [B] scenario axis — each scenario
    plans in its own world (MPC moving obstacles); a composite's grid stays
    shared.
    constraints: None, one Orientation/PositionConstraint, or a tuple.
    hyper: per-scenario HyperParams (STOMP only), or None for cfg's values.
    restarts: rows are R = restarts restarts of each query (restart-minor);
    the Solution has the best of each (select_restarts), [B / R, ...].

    On the card the whole solve replays cached CUDA graphs (graph.solve:
    solve-in, the loop, solve-out), except in graph.eager_reason's cases.
    """
    _check_batch(cfg, constraints, Q0, world, world_batched, hyper)
    step = make_step(robot, world, cfg, ops, Q0, QN, noise_fn,
                     world_batched, constraints, hyper)
    return graph.solve(step, theta0, restarts, state_layout(cfg, *Q0.shape),
                       _init_batch, _finish)[0]


def _gather_world(world, idx: torch.Tensor, world_batched: bool):
    """The rows `idx` of a per-scenario world (a composite's grid stays
    shared); a shared world unchanged."""
    if not world_batched:
        return world
    if isinstance(world, CompositeWorld):
        return dataclasses.replace(
            world, overlay=map_tensors(world.overlay, lambda v: v[idx]))
    return map_tensors(world, lambda v: v[idx])


def solve_batch_compacted(robot: RobotSpec, world, cfg: PlannerConfig,
                          ops: DeviceOps, Q0: torch.Tensor, QN: torch.Tensor,
                          noise_fn: NoiseFn,
                          theta0: torch.Tensor | None = None,
                          world_batched: bool = False, constraints=None,
                          chunk: int | None = None,
                          min_bucket: int | None = None) -> Solution:
    """`solve_batch` (STOMP) with finished scenarios compacted away (the
    reference's solve_batch_compacted, solver.py:937-1021).

    Every `chunk` iterations (cfg.compaction_chunk) the host reads the done
    mask; when the active rows' bucket, max(min_bucket, next power of two),
    is smaller than the current batch, the batch is regrouped onto exactly
    the active rows: their state, Q0/QN and, for a per-scenario world, its
    rows. Finished rows are written back with index_copy of real rows only
    (there are no pad rows), and the evaluator then sees the smaller B·C.
    noise_fn is still called once per iteration with the full-B active
    mask and cut to the current rows (sampling.RowNoise), so results equal
    solve_batch's row for row. On the card (graph.solve) the full batch's
    init and finalize are regions of its cache entry, a chunk is one
    replay of a graph of `chunk` iterations (the full batch's, or its
    bucket's), and the mask read after it is the host's one read of the
    chunk.
    """
    if cfg.mode != "stomp":
        raise ValueError("batch compaction is the STOMP batched path; "
                         f"mode={cfg.mode!r}")
    _check_batch(cfg, constraints, Q0, world, world_batched, None)
    chunk = cfg.compaction_chunk if chunk is None else chunk
    if min_bucket is None:
        min_bucket = cfg.compaction_min_bucket
    B = Q0.shape[0]
    full = make_step_batch_tm(robot, world, cfg, ops, Q0, QN, noise_fn,
                              world_batched, constraints)

    def loop(h, count) -> int:
        """The chunks from the full batch's state (h's) after `count`
        iterations, regrouped onto the active rows when their bucket is
        smaller: the full batch's chunks are h's, a bucket's run on an
        entry of its own, and its rows go back into h's state when the
        batch regroups again and at the end. Returns the count."""
        rows, step = None, full
        while True:
            if rows is None:
                count, done = h.run(count + chunk, count, mask=True)
                state = h.state
            else:
                h.hold()
                state, count, done = graph.run(step, state, count + chunk,
                                               count, k=chunk, mask=True)
            n_active = int((~done).sum())
            if n_active == 0:
                break
            bucket = max(min_bucket, 1 << (n_active - 1).bit_length())
            if bucket >= done.size:
                continue            # no win at this size; run on as it is
            keep = torch.from_numpy(np.flatnonzero(~done)).to(Q0.device)
            if rows is not None:
                h.put(state, rows)
            rows = keep if rows is None else rows[keep]
            state = map_tensors(state, lambda v: v[keep])
            step = make_step_batch_tm(
                robot, _gather_world(world, rows, world_batched), cfg, ops,
                Q0[rows], h.QN[rows], RowNoise(noise_fn, rows, B),
                world_batched, constraints)
        if rows is not None:
            h.put(state, rows)
        return count

    return graph.solve(full, theta0, 1, state_layout(cfg, *Q0.shape),
                       _init_batch, _finish, loop=loop, k=chunk)[0]


def select_best(sols: Solution) -> Solution:
    """Pick one Solution per row from a trailing restart axis: fields
    [B, R, ...] -> [B, ...]. Any successful restart beats every failed one;
    ties are broken by lowest total cost."""
    cost = torch.clamp(sols.cost, max=1e18)
    score = torch.where(sols.success, cost, cost + 1e20)
    idx = torch.argmin(score, dim=1)                              # [B]
    rows = torch.arange(idx.shape[0], device=idx.device)
    return map_tensors(sols, lambda v: v[rows, idx])

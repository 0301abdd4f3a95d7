"""A plain STOMP replan: the first tick of an MPC episode, from its inputs.

From the start (q0, the goal, each scenario's sphere) and the noise the
tick draws (one N(0, 1) draw z [d, B, K, N] an iteration, from a generator
in the state the episode started in), the tick as the configuration
defines it:

1. the plan starts as the min-jerk path from q0 to the goal (continuous
   joints take the shorter turn); the sphere moves by v·world_dt;
2. the arm executes the plan's first waypoint q1; the plan shifts one
   waypoint toward the goal (the warm start);
3. STOMP from the warm start, at most max_iterations iterations. Each
   draws K noisy plans (sigma · L z, L L^T = R^-1 / max|R^-1|, clipped to
   the joint limits), keeps the current plan and the Kr cheapest noisy
   plans of the last iteration as candidates, costs each at every
   waypoint, and moves the plan by M (the probability-weighted noise) with
   PI^2's probabilities of the per-waypoint costs to go (min-max scaled
   over candidates, exp(-h ·)), then projects it onto the limits (Jacobi
   passes through R^-1 with a trust region, then a clamp). The best
   collision-free current plan is kept; a scenario stops after
   max_iterations_after_collision_free collision-free iterations in a row;
4. the tick returns the best collision-free plan (else the last), or the
   warm start where the arm is within goal_flush of the goal and the warm
   start is collision free; the executed segment q0 -> q1, sampled at 4
   points, marks a collision; q1 within goal_eps of the goal marks the goal
   reached at tick 1.

Costs are those of reference/costs.py; R, M and L come from the same
derivative operators, built in float64. Every matmul runs in the check's
precision (reference/precision.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.costs import (World, derivative_operator,
                                       obstacle_rows, smoothness_rows)
from benchmark.reference.kinematics import Chain
from benchmark.reference.precision import Precision

# The planner's settings for keys a configuration leaves out, as the
# configurations here state the method: these and only these are followed.
DEFAULTS = {"pi2_cost_mode": "cumulative", "pi2_include_control_cost": False,
            "rollout_limit_projection": "clip", "joint_limit_method": "jacobi",
            "joint_limit_iterations": 10, "collision_threshold": 0.0,
            "smoothness": {"stencil": "fd3", "ridge_factor": 0.0}}
SEGMENT_SAMPLES = 4
PI2_EPS = 1e-8


def _setting(planner: dict, key: str):
    value = planner.get(key, DEFAULTS[key])
    if value != DEFAULTS[key]:
        raise NotImplementedError(f"{key}={value!r}: the reference follows "
                                  f"{DEFAULTS[key]!r} only")
    return value


def operators(planner: dict, prec: Precision, device) -> dict:
    """R^-1, M (R^-1 with each column scaled to a largest entry of 1/N) and
    L (the Cholesky factor of R^-1 / max|R^-1|), built in float64 and held
    in the check's precision."""
    N = planner["num_timesteps"]
    dt = planner["duration"] / (N + 1)
    sm = planner["smoothness"]
    for key, want in DEFAULTS["smoothness"].items():
        if sm.get(key, want) != want:
            raise NotImplementedError(f"smoothness {key}={sm[key]!r}")
    R = np.zeros((N, N))
    for order, w in zip((1, 2, 3), (sm["weight_velocity"],
                                    sm["weight_acceleration"],
                                    sm["weight_jerk"])):
        if w:
            A, _ = derivative_operator(N, dt, order)
            R += w * A.T @ A
    Rinv = np.linalg.inv(R)
    Rinv = 0.5 * (Rinv + Rinv.T)
    M = Rinv / (N * np.abs(Rinv).max(axis=0)[None, :])
    L = np.linalg.cholesky(Rinv / np.abs(Rinv).max())

    def t(x):
        return torch.as_tensor(x, dtype=prec.dtype, device=device)

    return {"Rinv": t(Rinv), "M": t(M), "L": t(L), "dt": dt}


def wrap_goal(q0: torch.Tensor, qN: torch.Tensor, limited) -> torch.Tensor:
    """The goal a continuous joint reaches: q0 plus the start-to-goal turn
    in (-pi, pi]; a limited joint's goal as given."""
    delta = qN - q0
    wrapped = q0 + delta - 2 * math.pi * torch.round(delta / (2 * math.pi))
    return torch.where(limited, qN, wrapped)


def min_jerk(q0: torch.Tensor, qN: torch.Tensor, N: int) -> torch.Tensor:
    """[n, d] endpoints -> the N interior waypoints [n, N, d] of
    s(u) = 10u^3 - 15u^4 + 6u^5."""
    u = torch.arange(1, N + 1, dtype=q0.dtype, device=q0.device)[:, None]
    u = u / (N + 1)
    s = 10 * u**3 - 15 * u**4 + 6 * u**5
    return q0[:, None] + s * (qN - q0)[:, None]


def project(theta, chain: Chain, Rinv, iterations: int, prec: Precision):
    """Jacobi projection of theta [..., N, d] onto the joint limits."""
    lo, hi, lim = chain.lower, chain.upper, chain.limited
    diag = torch.diagonal(Rinv)[:, None]
    th = theta
    for _ in range(iterations):
        v = torch.clamp(th - hi, min=0.0) + torch.clamp(th - lo, max=0.0)
        v = torch.where(lim, v, torch.zeros_like(v))
        c = prec.matmul(Rinv, v / diag)
        v_max = v.abs().amax(dim=-2, keepdim=True)
        c_max = c.abs().amax(dim=-2, keepdim=True)
        th = th - c * torch.clamp(v_max / (c_max + 1e-12), max=1.0)
    return torch.where(lim, torch.minimum(torch.maximum(th, lo), hi), theta)


def probabilities(S: torch.Tensor, h: float) -> torch.Tensor:
    """S [n, K, N] -> PI^2's P [n, K, N] over the candidate axis."""
    lo = S.amin(dim=1, keepdim=True)
    hi = S.amax(dim=1, keepdim=True)
    e = torch.exp(-h * (S - lo) / (hi - lo + PI2_EPS))
    return e / e.sum(dim=1, keepdim=True)


class Tick:
    """The scene of n scenarios' first tick in precision `prec`."""

    def __init__(self, config: dict, prec: str, device):
        self.planner, self.mpc = config["planner"], config["mpc"]
        self.prec = Precision(prec)
        self.device = device
        self.chain = Chain(config["robot"]["geometry"], self.prec, device)
        self.boxes = config["world"]["boxes"]
        self.ops = operators(self.planner, self.prec, device)
        for key in DEFAULTS:
            if key != "smoothness":
                _setting(self.planner, key)
        self.thr = DEFAULTS["collision_threshold"]

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=self.prec.dtype, device=self.device)

    def costs(self, world_rows, full: torch.Tensor):
        """full [n, C, T, d] in the scenarios' worlds -> (obstacle cost at
        each waypoint [n, C, T], smoothness at each waypoint [n, C, T],
        margin [n, C])."""
        n, C, T, d = full.shape
        p = self.planner
        centers = world_rows.repeat_interleave(C, dim=0)
        world = World(self.boxes, self.prec.dtype, self.device, centers,
                      torch.full(centers.shape[:2], self.mpc["sphere_radius"],
                                 dtype=self.prec.dtype, device=self.device))
        flat = full.reshape(n * C, T, d)
        q_obs, margin = obstacle_rows(self.chain, world, flat,
                                      self.ops["dt"],
                                      p["collision_clearance"])
        sm = p["smoothness"]
        ctrl = smoothness_rows(self.prec, flat, self.ops["dt"],
                               (sm["weight_velocity"],
                                sm["weight_acceleration"], sm["weight_jerk"]))
        return (q_obs.reshape(n, C, T), ctrl.reshape(n, C, T),
                margin.reshape(n, C))

    def run(self, q0, qN, c0, v, draws) -> dict:
        """q0, qN [n, d], c0, v [n, 1, 3] (the episode's inputs) and
        draws(j) -> z [d, n, K, N] for iteration j: the state after the
        tick, as numpy float64 (q, theta, sphere_center, collided,
        reached, and the segment's margin and distance to the goal)."""
        p, ops, chain = self.planner, self.ops, self.chain
        N, K = p["num_timesteps"], p["num_rollouts"]
        Kr = p["noise"]["num_rollouts_reused"]
        w_obs, w_sm = p["weights"]["obstacle"], p["weights"]["smoothness"]
        q0, qN, c0, v = (self._t(x) for x in (q0, qN, c0, v))
        n, d = q0.shape
        lim = chain.limited
        goal = wrap_goal(q0, qN, lim)
        plan = min_jerk(q0, goal, N)
        centers = c0 + v * self.mpc["world_dt"]
        q1 = plan[:, 0]
        QN = wrap_goal(q1, goal, lim)
        warm = torch.cat([plan[:, 1:], goal[:, None]], dim=1)
        theta, best = warm, warm
        best_cost = torch.full((n,), math.inf, dtype=q0.dtype,
                               device=q0.device)
        reuse = warm[:, None].expand(n, Kr, N, d)
        found = torch.zeros(n, dtype=torch.bool, device=q0.device)
        cf_count = torch.zeros(n, dtype=torch.int64, device=q0.device)
        done = torch.zeros_like(found)
        sigma = self._t(np.full(d, p["noise"]["stddev"]))
        decay = p["noise"]["decay"]
        ends = (q1[:, None, None].expand(n, 1 + K + Kr, 1, d),
                QN[:, None, None].expand(n, 1 + K + Kr, 1, d))
        rows = torch.arange(n, device=q0.device)[:, None]
        for j in range(p["max_iterations"]):
            if bool(done.all()):
                break
            z = draws(j).to(self.prec.dtype)                  # [d, n, K, N]
            eps = self.prec.matmul(ops["L"], z.permute(1, 2, 3, 0))
            eps = eps * (sigma * decay ** j)                  # [n, K, N, d]
            cand = torch.cat([theta[:, None], theta[:, None] + eps, reuse],
                             dim=1)                           # [n, C, N, d]
            cand = torch.where(lim, torch.minimum(torch.maximum(
                cand, chain.lower), chain.upper), cand)
            full = torch.cat([ends[0], cand, ends[1]], dim=2)
            q_obs, ctrl, margin = self.costs(centers, full)
            S = w_obs * q_obs
            totals = S.sum(dim=2) + w_sm * ctrl.sum(dim=2)    # [n, C]
            togo = torch.flip(torch.cumsum(torch.flip(S[:, 1:], [2]), 2),
                              [2])[:, :, 1:-1]                # [n, K+Kr, N]
            P = probabilities(togo, p["pi2_h"])
            step = (P[..., None] * (cand[:, 1:] - theta[:, None])).sum(1)
            new_theta = project(theta + self.prec.matmul(ops["M"], step),
                                chain, ops["Rinv"],
                                DEFAULTS["joint_limit_iterations"], self.prec)
            keep = torch.argsort(totals[:, 1:], dim=1, stable=True)[:, :Kr]
            new_reuse = cand[rows, keep + 1]
            cf = margin[:, 0] > self.thr
            new_count = torch.where(cf, cf_count + 1, 0)
            better = cf & (totals[:, 0] < best_cost)
            run = ~done

            def sel(new, old):
                m = run.reshape((n,) + (1,) * (new.dim() - 1))
                return torch.where(m, new, old)

            best = sel(torch.where(better[:, None, None], theta, best), best)
            best_cost = sel(torch.where(better, totals[:, 0], best_cost),
                            best_cost)
            found = sel(found | cf, found)
            theta, reuse = sel(new_theta, theta), sel(new_reuse, reuse)
            cf_count = sel(new_count, cf_count)
            done = done | (run & ((j + 1 >= p["max_iterations"])
                                  | (new_count >= p[
                                      "max_iterations_after_collision_free"])))
        out = torch.where(found[:, None, None], best, theta)
        # the warm start near the goal, where it is collision free
        near = torch.linalg.vector_norm(q1 - goal, dim=1) < self.mpc[
            "goal_flush"]
        warm_full = torch.cat([q1[:, None], warm, goal[:, None]], dim=1)
        _, _, warm_margin = self.costs(centers, warm_full[:, None])
        flush = near & (warm_margin[:, 0] > self.thr)
        out = torch.where(flush[:, None, None], warm, out)
        # the executed segment q0 -> q1
        alphas = torch.arange(1, SEGMENT_SAMPLES + 1, dtype=q0.dtype,
                              device=q0.device) / SEGMENT_SAMPLES
        qs = q0[:, None] + alphas[None, :, None] * (q1 - q0)[:, None]
        world = World(self.boxes, self.prec.dtype, self.device, centers,
                      torch.full(centers.shape[:2], self.mpc["sphere_radius"],
                                 dtype=self.prec.dtype, device=self.device))
        seg = (world.distance(chain.bodies(qs)) - chain.body_radius).amin(
            dim=(1, 2))
        err = (q1 - goal).abs().amax(dim=1)

        def np64(x):
            return x.double().cpu().numpy()

        return {"q": np64(q1), "theta": np64(out),
                "sphere_center": np64(centers),
                "collided": np64(seg) <= 0.0,
                "reached": np.where(np64(err) < self.mpc["goal_eps"], 1, -1),
                "segment_margin": np64(seg), "goal_error": np64(err)}


def draws_from(state: torch.Tensor, shape: tuple, rows, device):
    """draws(j) for Tick.run: the j-th N(0, 1) float32 draw of `shape`
    [d, B, K, N] from a generator on `device` in `state`, cut to the
    scenarios `rows`. Draws are made once, in order, as asked."""
    gen = torch.Generator(device)
    gen.set_state(state)
    made = []
    idx = torch.as_tensor(np.asarray(rows), device=device)

    def draws(j: int) -> torch.Tensor:
        while len(made) <= j:
            z = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            made.append(z.index_select(1, idx))
        return made[j]

    return draws

"""A plain CHOMP replay: the first iterations of a batched CHOMP solve,
from its queries.

CHOMP (Ratliff et al., ICRA 2009; Zucker et al., IJRR 2013) moves the
trajectory theta [N, d] (the free waypoints between q0 and the goal) down
the functional gradient of U = w_obstacle · U_obs + w_smoothness · U_smooth:

1. the plan starts as the min-jerk path from q0 to the goal (continuous
   joints take the shorter turn);
2. each sphere body b on the arm sits at x_b(q) with the point Jacobian
   J_b = dx_b/dq (a revolute joint i moves it by w_i x (x_b - p_i), w_i
   and p_i the joint's world axis and origin; a prismatic one by w_i);
3. along the trajectory each body has the workspace velocity x' and
   acceleration x'' (central differences, one-sided at the ends), speed
   |x'|, unit tangent t = x'/|x'| and curvature k = (I - t t^T) x''/|x'|^2;
4. the obstacle term at every waypoint and body is the curvature-projected
   workspace gradient |x'| ((I - t t^T) c'(d) grad d - c(d) k) dt, where d
   is the body's clearance (the boxes' signed distance minus its radius
   and the collision clearance eps), c CHOMP's potential (-d + eps/2
   inside, (d - eps)^2 / (2 eps) up to eps, 0 beyond) and grad d the
   signed distance's gradient; it is mapped to the joints by
   J^T (J J^T + ridge·I)^-1 (the damped pseudo-inverse) and summed over
   bodies;
5. the smoothness term is R theta + R_bias [q0; goal], with R = sum of
   w_k A_k^T A_k over the weighted derivative operators (reference/
   costs.py) and R_bias = sum of w_k A_k^T B_k;
6. the update is -eta · R^-1 · grad U, scaled down so its largest joint
   step is at most chomp_joint_update_limit (the trust region, per
   scenario), then projected onto the joint limits (reference/stomp.py's
   Jacobi passes and clamp);
7. each iteration's new trajectory is costed (reference/costs.py
   total_cost: w_obstacle · the speed-weighted potential + w_smoothness ·
   the smoothness) and the scenario stops after
   max_iterations_after_collision_free collision-free iterations in a row,
   or at max_iterations.

Departures from the published method, each as this repo's planner
defines it (configs/config3_chomp.yaml and its defaults):
- the workspace terms go through the damped pseudo-inverse J^T (J J^T +
  ridge·I)^-1 (use_pseudo_inverse) where the papers take J^T;
- the speed and the curvature are regularised: t = x'/(|x'| + 1e-6),
  k = (I - t t^T) x''/(|x'|^2 + 1e-6);
- the gradient of a union of boxes is the gradient of the nearest box
  (the first on ties); inside a box it is a unit step out through the
  least-deep face (faces tied share it);
- the trust-region cap and the limit projection are the planner's, not
  the papers';
- the iterates are discrete: every derivative is a finite difference on
  the N + 2 waypoints.

Every matmul runs in the check's precision (reference/precision.py); the
rest in its dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.costs import (World, derivative_operator,
                                       potential, total_cost)
from benchmark.reference.kinematics import Chain
from benchmark.reference.precision import Precision
from benchmark.reference.stomp import min_jerk, project, wrap_goal

SPEED_EPS = 1e-6
CAP_EPS = 1e-12
PINV_RIDGE = 1e-4          # pseudo_inverse_ridge_factor's default


def smoothness_operators(planner: dict) -> dict:
    """R [N, N], R_bias [N, 2] and R^-1 of the weighted derivative
    operators, float64 numpy."""
    N = planner["num_timesteps"]
    dt = planner["duration"] / (N + 1)
    sm = planner["smoothness"]
    if sm.get("stencil", "fd3") != "fd3" or sm.get("ridge_factor", 0.0):
        raise NotImplementedError("the reference takes 3-point stencils "
                                  "and no ridge")
    R, Rb = np.zeros((N, N)), np.zeros((N, 2))
    for order, w in zip((1, 2, 3), (sm["weight_velocity"],
                                    sm["weight_acceleration"],
                                    sm["weight_jerk"])):
        if w:
            A, B = derivative_operator(N, dt, order)
            R += w * A.T @ A
            Rb += w * A.T @ B
    Rinv = np.linalg.inv(R)
    return {"R": R, "R_bias": Rb, "Rinv": 0.5 * (Rinv + Rinv.T), "dt": dt}


def bodies_and_jacobians(chain: Chain, q: torch.Tensor):
    """q [..., d] -> (x [..., nb, 3], J [..., nb, 3, d]): the bodies' world
    positions and point Jacobians."""
    batch = q.shape[:-1]
    mm = chain.prec.matmul
    p = chain.base_pos.expand(*batch, 3)
    R = chain.base_rot.expand(*batch, 3, 3)
    origins, axes, frames = [], [], []
    for j in range(chain.d):
        p = p + mm(R, chain.offset[j])
        w = mm(R, chain.axis[j])                         # the world axis
        origins.append(p)
        axes.append(w)
        if chain.prismatic[j]:
            p = p + w * q[..., j, None]
        else:
            R = mm(R, chain.rotation(j, q[..., j]))
        frames.append((p, R))
    xs, Js = [], []
    for b, k in enumerate(chain.body_link):
        x = frames[k][0] + mm(frames[k][1], chain.body_offset[b])
        cols = []
        for i in range(chain.d):
            if i > k:
                cols.append(torch.zeros_like(x))
            elif chain.prismatic[i]:
                cols.append(axes[i])
            else:
                cols.append(torch.linalg.cross(axes[i], x - origins[i],
                                               dim=-1))
        xs.append(x)
        Js.append(torch.stack(cols, dim=-1))            # [..., 3, d]
    return torch.stack(xs, dim=-2), torch.stack(Js, dim=-3)


def box_distance_and_gradient(world: World, x: torch.Tensor):
    """x [..., 3] -> (signed distance to the nearest box [...], its gradient
    [..., 3])."""
    rel = x[..., None, :] - world.box_center              # [..., X, 3]
    q = rel.abs() - world.box_half
    qp = q.clamp(min=0.0)
    outside = torch.linalg.vector_norm(qp, dim=-1)
    q_max = q.amax(dim=-1, keepdim=True)
    dist = outside + q_max[..., 0].clamp(max=0.0)
    sign = torch.sign(rel)
    g_out = qp * sign / torch.where(outside > 0.0, outside, 1.0)[..., None]
    face = (q == q_max).to(x.dtype)
    face = face / face.sum(dim=-1, keepdim=True)
    grad = torch.where((outside > 0.0)[..., None], g_out, face * sign)
    nearest = dist.argmin(dim=-1, keepdim=True)           # first on ties
    return (dist.gather(-1, nearest)[..., 0],
            grad.gather(-2, nearest[..., None].expand(
                nearest.shape[:-1] + (1, 3)))[..., 0, :])


def central(v: torch.Tensor, dt: float) -> torch.Tensor:
    """d/dt over the waypoint axis (-3) of v [..., T, nb, 3]: central
    differences, one-sided at the ends."""
    return torch.cat([(v[..., 1:2, :, :] - v[..., :1, :, :]) / dt,
                      (v[..., 2:, :, :] - v[..., :-2, :, :]) / (2 * dt),
                      (v[..., -1:, :, :] - v[..., -2:-1, :, :]) / dt],
                     dim=-3)


def potential_deriv(d: torch.Tensor, eps: float) -> torch.Tensor:
    """c'(d) of CHOMP's potential (reference/costs.py potential)."""
    return torch.where(d < 0.0, -torch.ones_like(d),
                       torch.where(d <= eps, (d - eps) / eps,
                                   torch.zeros_like(d)))


class Replay:
    """A configuration's CHOMP in precision `prec` ("reference": float64;
    "control": float32 with TF32 matmul operands)."""

    def __init__(self, config: dict, prec: str, device):
        p = self.planner = config["planner"]
        if p.get("mode") != "chomp" or not p.get("use_pseudo_inverse"):
            raise NotImplementedError("the reference replays CHOMP with the "
                                      "damped pseudo-inverse only")
        if p.get("chomp_gradient_mode", "functional") != "functional":
            raise NotImplementedError("the functional gradient only")
        if p.get("joint_limit_method", "jacobi") != "jacobi":
            raise NotImplementedError("the Jacobi limit projection only")
        w = p["weights"]
        if w.get("torque", 0.0) or p.get("constraints"):
            raise NotImplementedError("no torque or constraint terms")
        if torch.device(device).type == "cuda":
            # float32 matmuls of the control in float32 and not TF32, as
            # benchmark/run.py sets them; left alone on the CPU
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.prec = Precision(prec)
        self.device = device
        self.chain = Chain(config["robot"]["geometry"], self.prec, device)
        self.world = World(config["world"]["boxes"], self.prec.dtype, device)
        ops = smoothness_operators(p)
        self.dt = ops["dt"]
        self.ops = {k: self._t(v) for k, v in ops.items() if k != "dt"}
        self.ridge = p.get("pseudo_inverse_ridge_factor", PINV_RIDGE)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=self.prec.dtype, device=self.device)

    def gradient(self, theta, q0, goal) -> torch.Tensor:
        """grad U [n, N, d] of theta [n, N, d] between q0 and goal [n, d]."""
        p, mm, chain = self.planner, self.prec.matmul, self.chain
        eps, dt = p["collision_clearance"], self.dt
        full = torch.cat([q0[:, None], theta, goal[:, None]], dim=1)
        x, J = bodies_and_jacobians(chain, full)   # [n,T,nb,3], [..,3,d]
        vel = central(x, dt)
        acc = central(vel, dt)
        speed = torch.linalg.vector_norm(vel, dim=-1)
        dist, grad_d = box_distance_and_gradient(self.world, x)
        clear = dist - chain.body_radius - eps
        c, dc = potential(clear, eps), potential_deriv(clear, eps)
        t = vel / (speed[..., None] + SPEED_EPS)

        def across(v):               # (I - t t^T) v
            return v - t * (t * v).sum(dim=-1, keepdim=True)

        kappa = across(acc) / (speed[..., None] ** 2 + SPEED_EPS)
        ws = speed[..., None] * (across(dc[..., None] * grad_d)
                                 - c[..., None] * kappa) * dt
        eye = torch.eye(3, dtype=ws.dtype, device=ws.device)
        G = mm(J, J.transpose(-1, -2)) + self.ridge * eye
        ws = torch.linalg.solve(G, ws)
        g_obs = mm(J.transpose(-1, -2), ws[..., None])[..., 0].sum(dim=-2)
        ends = torch.stack([q0, goal], dim=1)            # [n, 2, d]
        g_sm = mm(self.ops["R"], theta) + mm(self.ops["R_bias"], ends)
        w = p["weights"]
        return w["obstacle"] * g_obs[:, 1:-1] + w["smoothness"] * g_sm

    def run(self, q0, qN, iterations: int) -> dict:
        """q0, qN [n, d] (the queries as handed over): the first
        `iterations` iterations, as float64 numpy: totals [n, iterations]
        (each iteration's new trajectory's total cost; NaN once the
        scenario has stopped), ran [n] (the iterations it ran of those)
        and theta [n, N, d] where it stopped."""
        p, chain = self.planner, self.chain
        q0, qN = self._t(q0), self._t(qN)
        n = q0.shape[0]
        goal = wrap_goal(q0, qN, chain.limited)
        theta = min_jerk(q0, goal, p["num_timesteps"])
        eta, cap = p["learning_rate"], p["chomp_joint_update_limit"]
        steps = p.get("joint_limit_iterations", 10)
        cf_count = torch.zeros(n, dtype=torch.int64, device=self.device)
        done = torch.zeros(n, dtype=torch.bool, device=self.device)
        totals = torch.full((n, iterations), math.nan, dtype=torch.float64,
                            device=self.device)
        ran = torch.zeros(n, dtype=torch.int64, device=self.device)
        for j in range(iterations):
            if bool(done.all()):
                break
            g = self.gradient(theta, q0, goal)
            delta = -eta * self.prec.matmul(self.ops["Rinv"], g)
            big = delta.abs().amax(dim=(1, 2), keepdim=True)
            delta = delta * (cap / (big + CAP_EPS)).clamp(max=1.0)
            new = project(theta + delta, chain, self.ops["Rinv"], steps,
                          self.prec)
            full = torch.cat([q0[:, None], new, goal[:, None]], dim=1)
            total, margin = total_cost(chain, self.world, full, p)
            run = ~done
            totals[run, j] = total[run].double()
            ran = ran + run.long()
            theta = torch.where(run[:, None, None], new, theta)
            cf_count = torch.where(margin > p.get("collision_threshold", 0.0),
                                   cf_count + 1, 0)
            done = done | (run & ((j + 1 >= p["max_iterations"]) | (
                cf_count >= p["max_iterations_after_collision_free"])))
        return {"totals": totals.cpu().numpy(), "ran": ran.cpu().numpy(),
                "theta": theta.double().cpu().numpy()}


def replay(config: dict, q0, qN, iterations: int, prec: str, device,
           block: int = 1024) -> dict:
    """Replay.run over the queries in blocks of rows, concatenated."""
    r = Replay(config, prec, device)
    outs = [r.run(q0[i:i + block], qN[i:i + block], iterations)
            for i in range(0, len(q0), block)]
    if not outs:                                  # no query was kept
        return {"totals": np.zeros((0, iterations)),
                "ran": np.zeros(0, int), "theta": np.zeros((0, 0, 0))}
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

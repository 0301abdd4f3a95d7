"""The checks that decide `correct`: each answer the timed path returned is
judged by what it says, against the plain costs of reference/costs.py.

A plan says: this trajectory goes from the query's start to its goal
inside the joint limits, costs this much, and (success) is collision
free. An MPC episode says: after its first tick each scenario's arm is here on
this plan (held against a float64 replay of that tick, reference/
stomp.py), and after `ticks` ticks each scenario's sphere is here, the arm
is here on this plan, and it did (not) collide and did (not) reach its
goal.

Each check returns {name: value}; the configuration file's "checks" give
each name its limit, and a run is correct when every value is at most its
limit. Counts of false claims use a slack of SLACK (rad or m) for float32
rounding, a hundred times the rounding of these magnitudes.

A check runs in the "reference" precision (float64) or the "control"'s
(reference/precision.py), the control being the reference put in the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import stomp
from benchmark.reference.costs import World, total_cost
from benchmark.reference.kinematics import Chain
from benchmark.reference.precision import Precision

SLACK = 1e-5


def wrap_goal(q0: np.ndarray, qN: np.ndarray, limited) -> np.ndarray:
    """The goal a continuous joint reaches (reference/stomp.wrap_goal), in
    float64."""
    return stomp.wrap_goal(torch.as_tensor(np.asarray(q0, np.float64)),
                           torch.as_tensor(np.asarray(qN, np.float64)),
                           torch.as_tensor(np.asarray(limited, bool))).numpy()


def _t(x, dtype, device):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                           device=device)


def plan_costs(config: dict, traj: np.ndarray, prec: str, device,
               block: int = 4096):
    """(total cost, margin) of full trajectories [M, T, d] in `prec`, in
    blocks of rows, as float64 numpy."""
    out_c, out_m = [], []
    prec = Precision(prec)
    chain = Chain(config["robot"]["geometry"], prec, device)
    world = World(config["world"]["boxes"], prec.dtype, device)
    for i in range(0, len(traj), block):
        c, m = total_cost(chain, world, _t(traj[i:i + block], prec.dtype,
                                           device), config["planner"])
        out_c.append(c.double().cpu().numpy())
        out_m.append(m.double().cpu().numpy())
    cat = np.concatenate
    return (cat(out_c), cat(out_m)) if out_c else (np.zeros(0), np.zeros(0))


def check_plans(config: dict, ans: dict, device) -> dict:
    """ans: trajectory [M, T, d], cost [M], success [M], iterations [M],
    q0 / qN [M, d] (the queries as handed over). Returns cost_gap (the
    widest relative gap between a returned cost and the reference cost of
    its trajectory) and false_claims (answers with the wrong endpoints,
    outside the limits, not finite, with an iteration count outside
    [1, max_iterations], or called successful while the reference finds a
    body inside an obstacle)."""
    geo = config["robot"]["geometry"]
    traj = np.asarray(ans["trajectory"], np.float64)
    cost = np.asarray(ans["cost"], np.float64)
    success = np.asarray(ans["success"], bool)
    its = np.asarray(ans["iterations"])
    finite = np.isfinite(traj).all(axis=(1, 2)) & np.isfinite(cost)
    traj = np.where(finite[:, None, None], traj, 0.0)
    ref_cost, ref_margin = plan_costs(config, traj, "reference", device)
    gap = np.abs(cost - ref_cost) / np.maximum(np.abs(ref_cost), 1e-6)
    lo = np.asarray(geo["joint_lower"], np.float32).astype(np.float64)
    hi = np.asarray(geo["joint_upper"], np.float32).astype(np.float64)
    limited = np.asarray(geo["joint_limited"], bool)
    goal = wrap_goal(np.asarray(ans["q0"], np.float64),
                     np.asarray(ans["qN"], np.float64), limited)
    off_ends = np.maximum(np.abs(traj[:, 0] - ans["q0"]).max(axis=1),
                          np.abs(traj[:, -1] - goal).max(axis=1))
    excess = np.where(limited, np.maximum(lo - traj, traj - hi), 0.0).max(
        axis=(1, 2))
    max_it = config["planner"]["max_iterations"]
    false = (~finite | (off_ends > SLACK) | (excess > SLACK)
             | (its < 1) | (its > max_it) | (success & (ref_margin < -SLACK)))
    return {"cost_gap": float(np.where(finite, gap, 0.0).max(initial=0.0)),
            "false_claims": int(false.sum())}


def control_plans(config: dict, ans: dict, device) -> dict:
    """The control's answers: the reference in the program's place, in the
    control precision: each trajectory's cost and success worked out in
    float32 with TF32 matmul operands."""
    cost, margin = plan_costs(config, np.asarray(ans["trajectory"]),
                              "control", device)
    return dict(ans, cost=cost, success=margin > 0.0)


def check_episodes(config: dict, episodes: list, device,
                   first_ticks: list | None = None) -> dict:
    """episodes: dicts of the inputs (q0, qN [B, d], c0, v [B, S, 3], the
    episode's ticks, and `first`: the rows sampled for the check, the
    generator state the episode started in and the shape of its draws, with
    the state the program returned after the first tick on those rows) and
    the returned final state (q, qN_final, theta, sphere_center, steps,
    collided, reached). first_ticks: the first ticks' states to judge, one
    per episode (the control's); None judges the program's.

    The first tick on the sampled rows is replayed in float64 from the
    inputs and the same draws (reference/stomp.py). Returns plan_gap (the
    median over the sampled scenarios of the widest distance between the
    returned plan after the first tick and the replay's), sphere_gap (the
    widest distance between a final sphere centre and c0 + ticks·v·dt),
    false_claims (first ticks whose executed configuration, sphere, step
    count, collision or goal mark disagrees with the replay's by more than
    rounding; final states that contradict themselves: steps not the
    episode's ticks, a goal reached at no possible tick or left unmarked
    though the arm ends within goal_eps of it, no collision marked though
    the arm ends inside an obstacle, a goal that is not the wrapped input
    goal, a plan outside the limits, anything not finite),
    collision_rate (the share of scenarios marked as having collided) and
    unreached_share (the share of the scenarios of episodes of the
    configuration's length never marked as having reached the goal)."""
    mpc = config["mpc"]
    geo = config["robot"]["geometry"]
    limited = np.asarray(geo["joint_limited"], bool)
    lo = np.asarray(geo["joint_lower"], np.float32).astype(np.float64)
    hi = np.asarray(geo["joint_upper"], np.float32).astype(np.float64)
    replay = stomp.Tick(config, "reference", device)
    gap, false, collided, unreached, n, n_full = 0.0, 0, 0, 0, 0, 0
    plan_gaps = []
    for i, ep in enumerate(episodes):
        ticks = ep["ticks"]
        first = ep["first"]
        got = first if first_ticks is None else first_ticks[i]
        rows = first["rows"]
        ref = replay.run(ep["q0"][rows], ep["qN"][rows], ep["c0"][rows],
                         ep["v"][rows], stomp.draws_from(
                             first["generator"], first["shape"], rows,
                             device))
        plan = np.asarray(got["theta"], np.float64)
        plan_gaps += list(np.where(np.isfinite(plan).all(axis=(1, 2)),
                                   np.abs(plan - ref["theta"]).max(
                                       axis=(1, 2)), np.inf))
        seg, err = ref["segment_margin"], ref["goal_error"]
        false += int((
            (np.abs(got["q"] - ref["q"]).max(axis=1) > SLACK)
            | (np.abs(got["sphere_center"] - ref["sphere_center"]).max(
                axis=(1, 2)) > SLACK)
            | (got["steps"] != 1)
            | ((got["collided"] != ref["collided"])
               & (np.abs(seg) > SLACK))
            | ((got["reached"] != ref["reached"])
               & (np.abs(err - mpc["goal_eps"]) > SLACK))).sum())

        final = (np.asarray(ep["c0"], np.float64) + ticks * mpc["world_dt"]
                 * np.asarray(ep["v"], np.float64))
        sc = np.asarray(ep["sphere_center"], np.float64)
        ok = np.isfinite(sc).all(axis=(1, 2))
        gap = max(gap, float(np.where(ok[:, None, None], np.abs(sc - final),
                                      0.0).max(initial=0.0)))
        q = np.asarray(ep["q"], np.float64)
        theta = np.asarray(ep["theta"], np.float64)
        goal = wrap_goal(np.asarray(ep["q0"], np.float64),
                         np.asarray(ep["qN"], np.float64), limited)
        finite = (ok & np.isfinite(q).all(axis=1)
                  & np.isfinite(theta).all(axis=(1, 2)))
        q = np.where(finite[:, None], q, 0.0)
        theta = np.where(finite[:, None, None], theta, 0.0)
        f64 = torch.float64
        chain = Chain(geo, Precision("reference"), device)
        radius = np.full(final.shape[:2], mpc["sphere_radius"])
        world = World(config["world"]["boxes"], f64, device,
                      _t(final, f64, device), _t(radius, f64, device))
        pos = chain.bodies(_t(q, f64, device))                # [B, nb, 3]
        margin = (world.distance(pos) - chain.body_radius).amin(
            dim=-1).double().cpu().numpy()
        err = np.abs(q - goal).max(axis=1)
        steps = np.asarray(ep["steps"])
        reached = np.asarray(ep["reached"])
        hit = np.asarray(ep["collided"], bool)
        excess = np.where(limited, np.maximum(lo - theta, theta - hi),
                          0.0).max(axis=(1, 2))
        bad = (~finite | (steps != ticks)
               | ((reached != -1) & ((reached < 1) | (reached > ticks)))
               | ((reached == -1) & (err < mpc["goal_eps"] - SLACK))
               | (~hit & (margin < -SLACK))
               | (np.abs(np.asarray(ep["qN_final"]) - goal).max(axis=1)
                  > SLACK)
               | (excess > SLACK))
        false += int(bad.sum())
        collided += int(hit.sum())
        n += len(hit)
        if ticks == mpc["ticks"]:
            unreached += int((reached == -1).sum())
            n_full += len(hit)
    return {"plan_gap": float(np.median(plan_gaps)) if plan_gaps else 0.0,
            "sphere_gap": gap, "false_claims": false,
            "collision_rate": collided / max(n, 1),
            "unreached_share": unreached / max(n_full, 1)}


def control_first_ticks(config: dict, episodes: list, device) -> list:
    """The control's answers: each episode's first tick on the sampled rows
    replayed by the reference in the control precision, from the same
    inputs and draws."""
    tick = stomp.Tick(config, "control", device)
    out = []
    for ep in episodes:
        first, rows = ep["first"], ep["first"]["rows"]
        got = tick.run(ep["q0"][rows], ep["qN"][rows], ep["c0"][rows],
                       ep["v"][rows], stomp.draws_from(
                           first["generator"], first["shape"], rows, device))
        out.append(dict(got, steps=np.ones(len(rows), int)))
    return out

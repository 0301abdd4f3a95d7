"""MPC episodes, back to back from one caller (closed loop): `init_mpc` then
`run_mpc_batch` over every scenario for the configuration's ticks.

Traffic keys:
  scenarios      scenarios an episode;
  jitter_rad     each scenario's start and goal are the configuration's,
                 every joint moved by a uniform draw in +-jitter_rad;
  sphere_lo/hi   its moving sphere starts uniformly in this box (m) and
                 moves at the configuration's speed in a direction drawn
                 uniformly from the seed (bench/mpc_bench.py's seeding);
  check_rows     scenarios of each episode whose first tick the check
                 replays (drawn from the seed);
  warmup_ticks   ticks of each of two set-up episodes (the first captures
                 the tick);
  trace          {"per_iteration_ticks"}: the traced run's short episode on
                 the per-iteration route; its window is one whole episode.

An episode runs as two calls of `run_mpc_batch` on the card's state: its
first tick, whose state on the sampled rows is copied to the host for the
check, then the other ticks. Inputs are host float32 arrays; each final
state is copied back to the host. Every scenario is new and drawn from the
seed; the noise comes from one CUDA generator seeded in set-up, whose state
at each episode's start the check keeps to replay the first tick's draws.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark.lib import trace
from benchmark.program.scene import Scene
from benchmark.reference import verify


class Scenarios:
    """A seeded stream of episodes' inputs (bench/mpc_bench.py's seeding)."""

    def __init__(self, seed: int, stream: int, config: dict, traffic: dict):
        self.rng = np.random.default_rng([seed, stream])
        self.q0 = np.asarray(config["q0"], np.float32)
        self.qN = np.asarray(config["qN"], np.float32)
        self.speed = float(config["mpc"]["sphere_speed"])
        self.B = int(traffic["scenarios"])
        self.jitter = float(traffic["jitter_rad"])
        self.lo = np.asarray(traffic["sphere_lo"], np.float64)
        self.hi = np.asarray(traffic["sphere_hi"], np.float64)

    def next(self) -> dict:
        r, B, d = self.rng, self.B, len(self.q0)
        q0 = self.q0 + r.uniform(-self.jitter, self.jitter, (B, d))
        qN = self.qN + r.uniform(-self.jitter, self.jitter, (B, d))
        c0 = r.uniform(self.lo, self.hi, (B, 3))[:, None, :]
        dirs = r.normal(size=(B, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
        f32 = np.float32
        return dict(q0=q0.astype(f32), qN=qN.astype(f32), c0=c0.astype(f32),
                    v=(-dirs * self.speed)[:, None, :].astype(f32))


class Runner:
    def __init__(self, ctx, traced: bool = False):
        self.ctx, self.dev = ctx, ctx.device
        cfg, tr = ctx.config, ctx.traffic
        self.scene = Scene(cfg, self.dev)
        self.cfg = self.scene.cfg
        self.mpc = cfg["mpc"]
        self.gen = torch.Generator(self.dev).manual_seed(ctx.seed)
        self.stream = Scenarios(ctx.seed, 0, cfg, tr)
        self.pick = np.random.default_rng([ctx.seed, 2])
        self.episodes, self.attempted, self.failed = [], 0, 0
        self.ticks_run = 0
        warm = Scenarios(ctx.seed, 1, cfg, tr)
        for _ in range(2):
            self._run(warm.next(), int(tr["warmup_ticks"]))
        if traced:
            from tpustomp_torch.engine import graph

            with graph.per_iteration():
                for _ in range(2):
                    self._run(warm.next(), int(tr["warmup_ticks"]))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _ticks(self, state, ticks: int):
        from tpustomp_torch.engine.mpc import run_mpc_batch

        return run_mpc_batch(
            self.scene.robot, self.cfg, state, [self.mpc["sphere_radius"]],
            ticks, self.mpc["world_dt"], static_world=self.scene.world,
            goal_eps=self.mpc["goal_eps"], goal_flush=self.mpc["goal_flush"],
            device=self.dev, generator=self.gen)

    def _run(self, inp: dict, ticks: int, rows=None):
        """One episode of `ticks` ticks: (the final state on the host, the
        first tick's state on `rows`, on the host)."""
        from tpustomp_torch.engine.mpc import init_mpc

        state = init_mpc(self.scene.robot, self.cfg, inp["q0"], inp["qN"],
                         inp["c0"], inp["v"])
        state = self._ticks(state, 1)
        first = None
        if rows is not None:
            idx = torch.as_tensor(rows, device=self.dev)
            first = {k: getattr(state, f).index_select(0, idx).cpu().numpy()
                     for k, f in (("q", "q"), ("theta", "theta"),
                                  ("sphere_center", "sphere_center"),
                                  ("steps", "steps"), ("collided", "collided"),
                                  ("reached", "reached_tick"))}
        if ticks > 1:
            state = self._ticks(state, ticks - 1)
        return state.to("cpu"), first

    def _episode(self, ticks: int | None = None):
        ticks = ticks or int(self.mpc["ticks"])
        inp = self.stream.next()
        B, d = inp["q0"].shape
        rows = np.sort(self.pick.choice(
            B, min(B, int(self.ctx.traffic["check_rows"])), replace=False))
        self.attempted += B * ticks
        start = self.gen.get_state()
        try:
            out, first = self._run(inp, ticks, rows)
        except Exception:                         # answers that never came
            self.ctx.log(f"episode raised: {traceback.format_exc()}")
            self.failed += B * ticks
            self.episodes.append(dict(inp, ticks=ticks, missing=B))
            return
        self.ticks_run += ticks
        finite = torch.isfinite(out.q).all(dim=1).numpy()
        self.failed += int((~finite).sum()) * ticks
        first.update(rows=rows, generator=start,
                     shape=(d, B, self.cfg.num_rollouts,
                            self.cfg.num_timesteps))
        self.episodes.append(dict(
            inp, ticks=ticks, missing=0, first=first, q=out.q.numpy(),
            qN_final=out.qN.numpy(), theta=out.theta.numpy(),
            sphere_center=out.sphere_center.numpy(),
            steps=out.steps.numpy(), collided=out.collided.numpy(),
            reached=out.reached_tick.numpy()))

    def window(self, seconds: float) -> dict:
        """Episodes back to back until `seconds` have passed; the episode
        under way then finishes and counts."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._episode()
        elapsed = time.perf_counter() - t0
        done = self.attempted - sum(e["missing"] * e["ticks"]
                                    for e in self.episodes)
        return {"replans_per_s": done / elapsed}

    def traced(self) -> dict:
        from tpustomp_torch.engine import graph

        tr = self.ctx.traffic["trace"]
        with graph.per_iteration(), trace.record("per_iteration") as pi:
            self._episode(int(tr["per_iteration_ticks"]))
        graph.reset_counts()
        self.ticks_run = 0
        with trace.record("window") as w:
            self._episode()
        B = int(self.ctx.traffic["scenarios"])
        per = 1 + self.cfg.num_rollouts + self.cfg.noise.num_rollouts_reused
        return dict(
            window=w["window"], per_iteration=pi["window"],
            counts=dict(ticks=self.ticks_run, graphs=dict(graph.GRAPHS)),
            evaluator=self.scene.evaluator(B * per, rows=B, ns=1))

    def summary(self) -> dict:
        eps = [e for e in self.episodes if not e["missing"]]
        reached = np.concatenate([e["reached"] for e in eps] or [[]])
        collided = np.concatenate([e["collided"] for e in eps] or [[]])
        return dict(attempted=self.attempted, failed=self.failed,
                    episodes=len(self.episodes),
                    collision_rate=float(np.mean(collided)) if len(
                        collided) else None,
                    reached_rate=float(np.mean(reached >= 0)) if len(
                        reached) else None)

    def release(self):
        self.scene.release()
        self.gen = None

    def check(self, precision: str = "reference") -> dict:
        eps = [e for e in self.episodes if not e["missing"]]
        firsts = None
        if precision == "control":
            firsts = verify.control_first_ticks(self.ctx.config, eps,
                                                self.ctx.device)
        out = verify.check_episodes(self.ctx.config, eps, self.ctx.device,
                                    firsts)
        out["false_claims"] += sum(e["missing"] for e in self.episodes)
        return out

"""Planning queries, back to back from one caller (closed loop).

Traffic keys:
  batch        queries a call: `plan_batch` over that many, or null for
               `plan`, one query a call;
  jitter_rad   each query is the configuration's start and goal with every
               joint moved by a uniform draw in [-jitter_rad, jitter_rad];
  sample_rows  answers of each batch call kept for the check (drawn from
               the seed; every unsolved row is kept as well);
  warmup_calls calls made in set-up (the first captures the solve);
  trace        {"calls", "per_iteration_calls"}: the traced run's windows.

Queries are handed over as host float32 arrays and every answer is copied
back to the host, as a caller holds it. Each query is new and drawn from
the seed; the noise comes from one CUDA generator seeded in set-up.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark.lib import stats, trace
from benchmark.program.scene import Scene
from benchmark.reference import verify


class Queries:
    """A seeded stream of jittered (start, goal) pairs."""

    def __init__(self, seed: int, stream: int, config: dict, batch, jitter):
        self.rng = np.random.default_rng([seed, stream])
        self.q0 = np.asarray(config["q0"], np.float32)
        self.qN = np.asarray(config["qN"], np.float32)
        self.batch, self.jitter = batch, jitter

    def next(self):
        n, d = self.batch or 1, len(self.q0)
        q0 = self.q0 + self.rng.uniform(-self.jitter, self.jitter, (n, d))
        qN = self.qN + self.rng.uniform(-self.jitter, self.jitter, (n, d))
        return q0.astype(np.float32), qN.astype(np.float32)


class Runner:
    def __init__(self, ctx, traced: bool = False):
        self.ctx, self.dev = ctx, ctx.device
        cfg, tr = ctx.config, ctx.traffic
        self.scene = Scene(cfg, self.dev)
        self.cfg = self.scene.cfg
        self.batch, self.jitter = tr["batch"], float(tr["jitter_rad"])
        self.gen = torch.Generator(self.dev).manual_seed(ctx.seed)
        self.queries = Queries(ctx.seed, 0, cfg, self.batch, self.jitter)
        self.pick = np.random.default_rng([ctx.seed, 2])
        self.answers = {k: [] for k in ("trajectory", "cost", "success",
                                        "iterations", "q0", "qN")}
        self.latencies, self.solved, self.attempted = [], 0, 0
        self.iterations, self.loop_iterations, self.missing = [], 0, 0
        warm = Queries(ctx.seed, 1, cfg, self.batch, self.jitter)
        for _ in range(int(tr["warmup_calls"])):
            self._solve(*warm.next())
        if traced:
            from tpustomp_torch.engine import graph

            with graph.per_iteration():
                for _ in range(int(tr["warmup_calls"])):
                    self._solve(*warm.next())
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _solve(self, q0, qN):
        """One call of the entry, its answer on the host."""
        from tpustomp_torch import ProblemSpec, plan, plan_batch

        entry = plan_batch if self.batch else plan
        prob = (ProblemSpec(q0=q0, qN=qN) if self.batch
                else ProblemSpec(q0=q0[0], qN=qN[0]))
        return entry(self.scene.robot, self.scene.world, prob, self.cfg,
                     device=self.dev, generator=self.gen).to("cpu")

    def _call(self):
        """One timed call: hand over the query, hold the answer."""
        q0, qN = self.queries.next()
        t = time.perf_counter()
        try:
            sol = self._solve(q0, qN)
        except Exception:                         # an answer that never came
            self.ctx.log(f"call raised: {traceback.format_exc()}")
            sol = None
        wall = time.perf_counter() - t
        n = len(q0)
        self.attempted += n
        if sol is None:
            self.missing += n
            self.latencies += [float("inf")] * n
            return
        success = sol.success.reshape(n).numpy()
        its = sol.iterations.reshape(n).numpy()
        self.solved += int(success.sum())
        self.iterations += its.tolist()
        self.loop_iterations += int(its.max())
        self.latencies += [wall if s else float("inf") for s in success]
        k = int(self.ctx.traffic["sample_rows"])
        rows = np.arange(n) if n <= k else np.union1d(
            self.pick.choice(n, k, replace=False), np.flatnonzero(~success))
        traj = sol.trajectory.reshape((n,) + sol.trajectory.shape[-2:])
        kept = dict(trajectory=traj.numpy(), cost=sol.cost.reshape(n).numpy(),
                    success=success, iterations=its, q0=q0, qN=qN)
        for key, v in kept.items():
            self.answers[key].append(v[rows])

    def window(self, seconds: float) -> dict:
        """Calls back to back until `seconds` have passed; the call under way
        then finishes and counts. Returns the end-to-end metrics."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call()
        elapsed = time.perf_counter() - t0
        out = {"solved_per_s": self.solved / elapsed}
        if not self.batch:
            cap = lambda v: 1e3 * (v if v != float("inf") else elapsed)
            out["plan_p50_ms"] = cap(stats.percentile(self.latencies, 0.50))
            out["plan_p95_ms"] = cap(stats.percentile(self.latencies, 0.95))
        return out

    def traced(self) -> dict:
        """The traced run's windows: the per-iteration route (kernels named
        right, one replay an iteration) and the cell's own route."""
        from tpustomp_torch.engine import graph

        tr = self.ctx.traffic["trace"]
        with graph.per_iteration(), trace.record("per_iteration") as pi:
            for _ in range(int(tr["per_iteration_calls"])):
                self._call()
        self.iterations, self.loop_iterations = [], 0
        graph.reset_counts()
        with trace.record("window") as w:
            for _ in range(int(tr["calls"])):
                self._call()
        K = self.cfg.num_rollouts
        C = (self.batch or 1) * (1 + K + self.cfg.noise.num_rollouts_reused)
        return dict(
            window=w["window"], per_iteration=pi["window"],
            counts=dict(calls=int(tr["calls"]),
                        loop_iterations=self.loop_iterations,
                        iterations_mean=float(np.mean(self.iterations)),
                        graphs=dict(graph.GRAPHS)),
            evaluator=self.scene.evaluator(C))

    def summary(self) -> dict:
        return dict(attempted=self.attempted,
                    failed=self.attempted - self.solved,
                    unsolved_share=1 - self.solved / max(self.attempted, 1),
                    iterations_mean=float(np.mean(self.iterations or [0])))

    def release(self):
        """Drop the program's objects before the check."""
        self.scene.release()
        self.gen = None

    def check(self, precision: str = "reference") -> dict:
        ans = {k: np.concatenate(v) if v else np.zeros(0)
               for k, v in self.answers.items()}
        if precision == "control":
            ans = verify.control_plans(self.ctx.config, ans,
                                       self.ctx.device)
        out = verify.check_plans(self.ctx.config, ans, self.ctx.device)
        out["false_claims"] += self.missing
        out["unsolved_share"] = self.summary()["unsolved_share"]
        return out

"""CHOMP planning queries, back to back from one caller (closed loop): the
plan driver (drivers/plan.py; the same traffic keys) for a configuration
whose planner is CHOMP, with a check that sees its gradient.

CHOMP draws nothing, so each returned answer's per-iteration totals
(`Solution.metrics`, recorded with `record_metrics`) can be replayed
exactly: for the sampled rows the driver keeps them, and the check
replays each sampled query's first `trace_iterations` iterations (a key
of the configuration) in float64 (reference/chomp.py). Besides the plan
driver's numbers it returns cost_trace_gap, the widest relative gap
between a kept total and the replay's. The evaluator's roofline counts
one trajectory a scenario (C = B); the traced run adds a window of spans
taken without the profiler.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark.drivers import plan
from benchmark.lib import trace
from benchmark.reference import chomp as reference


def trace_gap(got: np.ndarray, ref: dict, iterations: np.ndarray,
              k: int) -> float:
    """The widest relative gap between the totals got [M, >= k] and the
    replay's (ref["totals"] [M, k]) over each row's first min(k, its
    iterations, the replay's) iterations; a total that is not finite
    counts as infinitely far."""
    if not len(got):
        return 0.0
    n = np.minimum(np.minimum(iterations, ref["ran"]), k)
    mask = np.arange(k)[None, :] < n[:, None]
    a = np.asarray(got, np.float64)[:, :k]
    r = ref["totals"]
    gap = np.abs(a - r) / np.maximum(np.abs(r), 1e-6)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return float(np.where(mask, gap, 0.0).max(initial=0.0))


class Runner(plan.Runner):
    def __init__(self, ctx, traced: bool = False):
        self.traces = []
        super().__init__(ctx, traced)

    def _call(self):
        """One timed call (plan.Runner._call), the sampled rows' recorded
        totals kept as well."""
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
        totals = sol.metrics.total_cost
        self.traces.append(totals.reshape(n, totals.shape[-1]).numpy()[rows])

    def traced(self) -> dict:
        """plan.Runner's traced run, the evaluator at C = B, and "spans": a
        window of per_iteration_calls more calls on the per-iteration route
        with the program's spans on and no profiler, whose spans the
        span readers take: CUPTI slows a graph's launch, which a span's
        CUDA events bracket (30 % on chomp.grad under the profiler)."""
        from tpustomp_torch.engine import graph
        from tpustomp_torch.utils import tracing

        out = super().traced()
        out["evaluator"] = self.scene.evaluator(self.batch or 1)
        t0 = tracing.trace_us(time.time_ns())
        with graph.per_iteration(), tracing.spans():
            for _ in range(int(self.ctx.traffic["trace"][
                    "per_iteration_calls"])):
                self._call()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        out["spans"] = trace.Window(t0=t0,
                                    t1=tracing.trace_us(time.time_ns()))
        return out

    def check(self, precision: str = "reference") -> dict:
        """plan.Runner's numbers and cost_trace_gap: the kept totals (in
        the control's case, its own replay's, in the control precision)
        against the float64 replay of the same queries."""
        out = super().check(precision)
        config, dev = self.ctx.config, self.ctx.device
        k = int(config["trace_iterations"])
        q0 = np.concatenate(self.answers["q0"]) if self.traces else []
        qN = np.concatenate(self.answers["qN"]) if self.traces else []
        its = (np.concatenate(self.answers["iterations"]) if self.traces
               else np.zeros(0, int))
        ref = reference.replay(config, q0, qN, k, "reference", dev)
        if precision == "control":
            got = reference.replay(config, q0, qN, k, "control", dev)
            its, got = got["ran"], got["totals"]
        else:
            got = (np.concatenate(self.traces) if self.traces
                   else np.zeros((0, k)))
        out["cost_trace_gap"] = trace_gap(got, ref, its, k)
        return out

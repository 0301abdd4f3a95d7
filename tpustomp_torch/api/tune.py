"""Hyperparameter tuning as one batched solve (port of
``tpustomp/api/tune.py``).

    result = tune(robot, world, problems, cfg,
                  noise_scale=(0.7, 1.0, 1.5, 2.0),
                  h=(5.0, 10.0, 20.0), decay=(0.99, 1.0))
    best_cfg = result.best_config(cfg)     # PlannerConfig with winners baked
    result.table                           # per-cell success/iterations

The (noise_scale × h × decay) grid over n problems runs as ONE
``solver.solve_batch`` of G·n scenarios with per-scenario HyperParams;
every cell sees the same problems and the same per-problem noise, so cells
differ only in their hyperparameters. Selection: highest success rate, then
fewest mean iterations, then the lowest finite mean cost of the successful
rows.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from tpustomp_torch.api.config import PlannerConfig
from tpustomp_torch.api.plan import _prepare
from tpustomp_torch.api.problem import ProblemSpec
from tpustomp_torch.engine import solver
from tpustomp_torch.engine.sampling import GeneratorNoise, TiledNoise
from tpustomp_torch.robot.model import check_joint_static


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of a tune() grid. `table` maps cell label -> metrics dict;
    `best` is (noise_scale, h, decay) of the winning cell."""

    best: tuple
    table: dict

    def best_config(self, cfg: PlannerConfig) -> PlannerConfig:
        """cfg with the winning cell baked in. dataclasses.replace keeps
        every NoiseConfig field the cells inherited from cfg — the
        stddev_per_joint ratios (scaled with the cell), prng_impl,
        num_rollouts_reused — so the baked config reproduces the cell."""
        scale, h, decay = self.best
        noise = dataclasses.replace(
            cfg.noise,
            stddev=float(cfg.noise.stddev) * scale,
            stddev_per_joint=tuple(
                s * scale for s in cfg.noise.stddev_per_joint),
            decay=decay)
        return cfg.replace(noise=noise, pi2_h=h)


def tune(robot, world, problem: ProblemSpec,
         cfg: PlannerConfig = PlannerConfig(),
         noise_scale=(0.7, 1.0, 1.5, 2.0), h=(5.0, 10.0, 20.0),
         decay=(0.995, 1.0), *, device="cuda",
         generator: torch.Generator | None = None, noise_fn=None,
         constraints=None) -> TuneResult:
    """Grid-search STOMP's exploration hyperparameters over a problem batch
    (problem.q0/qN [n, d]; goal bands resolved as plan_batch resolves
    them). STOMP only: CHOMP's knobs are static by nature.

    Noise: by default one draw_z [d, n, K, N] per iteration from
    `generator` (seed 0 on the device if None), tiled over the G cells, so
    cell g's problem i sees what plan_batch on the n problems would draw
    from the same generator. noise_fn(iteration, active [G·n]) -> z [d,
    G·n, K, N] replaces it (scenario g·n + i is cell g's problem i).
    """
    if cfg.mode != "stomp":
        raise ValueError("tune() sweeps STOMP exploration knobs; "
                         f"mode={cfg.mode!r}")
    p = _prepare(check_joint_static(robot), world, problem, cfg, device,
                 constraints)
    n, d = p.q0.shape
    cells = list(itertools.product(noise_scale, h, decay))
    G = len(cells)

    def per_row(k):
        return torch.tensor([c[k] for c in cells], dtype=torch.float32,
                            device=p.device).repeat_interleave(n)

    hyper = solver.HyperParams(noise_scale=per_row(0), h=per_row(1),
                               decay=per_row(2))
    if noise_fn is None:
        gen = (torch.Generator(device=p.device).manual_seed(0)
               if generator is None else generator)
        noise_fn = TiledNoise(GeneratorNoise(
            gen, d, n, p.cfg.num_rollouts, p.cfg.num_timesteps, p.device),
            n, G)

    sol = solver.solve_batch(p.robot, p.world, p.cfg, p.ops,
                             p.q0.repeat(G, 1), p.qN.repeat(G, 1), noise_fn,
                             constraints=p.constraints, hyper=hyper)
    succ = sol.success.cpu().numpy().reshape(G, n)
    iters = sol.iterations.cpu().numpy().astype(np.float32).reshape(G, n)
    cost = sol.cost.cpu().numpy().reshape(G, n)

    table = {}
    scored = []
    for c, sc, it, co in zip(cells, succ, iters, cost):
        label = f"scale={c[0]:g}/h={c[1]:g}/decay={c[2]:g}"
        # the mean over successful rows with a FINITE cost only, so an
        # inf/NaN cost neither poisons the mean nor makes max() order-bound
        fin = sc & np.isfinite(co)
        mcost = float(co[fin].mean()) if fin.any() else float("inf")
        table[label] = {
            "success_rate": float(sc.mean()),
            "mean_iterations": float(it.mean()),
            "mean_cost_successful": mcost,
        }
        scored.append((float(sc.mean()), -float(it.mean()), -mcost, c))
    return TuneResult(best=max(scored)[3], table=table)

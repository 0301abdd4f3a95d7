#!/usr/bin/env python3
"""Faults planted underneath the timed path of a CHOMP cell, to see the
check catch them.

    python3 benchmark/tools/faults_chomp.py --fault NAME \
        --workload chomp7_tabletop.batch1024 --seconds S --seeds 1,2,3

As tools/faults.py (one fault installed before set-up, so the captured
graphs hold it; one line a seed), with the faults of a CHOMP step:

  obstacle_dropped  the gradient loses its obstacle term: the update is
                    -eta · R^-1 · w_smoothness (R theta + R_bias q) alone;
  rinv_bf16         the update's R^-1 product runs in bfloat16 (R^-1 and
                    the gradient rounded to it, the product back in
                    float32);
  answer_altered    a plan's returned trajectory turns joint 1 by 0.3 rad
                    (tools/faults.py's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.tools import faults  # noqa: E402

FAULTS = ("obstacle_dropped", "rinv_bf16", "answer_altered")


def install(name: str) -> None:
    from tpustomp_torch.costs.smoothness import smoothness_gradient
    from tpustomp_torch.engine import solver

    if name == "answer_altered":
        faults.install(name, "plan")
        return

    def make(s):
        lr, Rinv, w_sm = (s.cfg.learning_rate, s.ops.Rinv,
                          s.cfg.weights.smoothness)
        cap, _, grad_u, finish, project = solver._chomp_parts(s)

        def advance(state, draws=None):
            if name == "obstacle_dropped":
                grad = w_sm * smoothness_gradient(s.ops, state.theta, s.Q0,
                                                  s.QN)
                step = Rinv @ grad
            else:
                step = (Rinv.to(torch.bfloat16)
                        @ grad_u(state.theta).to(torch.bfloat16)).float()
            return finish(state, project(state.theta + cap(-lr * step)))

        return advance

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    solver._ADVANCE["chomp"] = make


def run(cell, fault: str, seeds: list, seconds: float, device=None):
    """[(seed, numbers, correct)] of the cell's traffic with `fault`."""
    from benchmark.lib import card
    from benchmark.lib import cell as cells
    from benchmark.run import Context

    dev = device if device is not None else card.require(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    install(fault)
    driver = cells.module("drivers", cell.traffic["driver"])
    out = []
    for seed in seeds:
        runner = driver.Runner(Context(cell, cell.config, cell.traffic, seed,
                                       dev))
        runner.window(seconds)
        runner.release()
        numbers = runner.check("reference")
        limits = cell.config["checks"]
        out.append((seed, numbers,
                    all(numbers[k] <= v for k, v in limits.items())))
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--fault", required=True, choices=FAULTS)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5)
    p.add_argument("--seeds", default="1,2,3")
    a = p.parse_args()
    from benchmark.lib import cell as cells

    cell = cells.load(a.workload)
    for seed, numbers, correct in run(cell, a.fault,
                                      [int(s) for s in a.seeds.split(",")],
                                      a.seconds):
        print(json.dumps(dict(fault=a.fault, cell=a.workload, seed=seed,
                              correct=correct, numbers=numbers,
                              limits=cell.config["checks"])), flush=True)


if __name__ == "__main__":
    main()

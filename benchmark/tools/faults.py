#!/usr/bin/env python3
"""Faults planted underneath the timed path, to see the check catch them.

    python3 benchmark/tools/faults.py --fault NAME --workload CELL \
        --seconds S --seeds 1,2,3

Installs one fault in the program (before set-up, so the captured graphs
hold it), then runs the cell's traffic for S seconds once per seed in this
process and prints each run's compared numbers, their limits and whether
the run came out correct. The faults:

  step_unchanged   the STOMP step returns its state unchanged (it only
                   counts the iteration, so the loop still ends);
  half_batch       the step leaves the second half of the batch's rows as
                   they were;
  answer_altered   the answer is altered where it is produced: a plan's
                   returned trajectory turns joint 1 by 0.3 rad, an MPC
                   tick writes its sphere centres 1 cm off;
  tick_unchanged   an MPC tick returns its state unchanged but for its
                   step count (the arm never moves).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def _counting(state, cfg, keep):
    """`state` with only its iteration counted (and done at the cap) on the
    rows `keep` selects."""
    it = torch.where(state.done | ~keep, state.iteration, state.iteration + 1)
    return dataclasses.replace(
        state, iteration=it,
        done=state.done | (keep & (it >= cfg.max_iterations)))


def install(name: str, driver: str) -> None:
    from tpustomp_torch.engine import mpc, solver

    real = solver._ADVANCE["stomp"]
    if name == "step_unchanged":
        def make(s):
            def advance(state, z):
                keep = torch.ones_like(state.done)
                return _counting(state, s.cfg, keep)
            return advance
        solver._ADVANCE["stomp"] = make
    elif name == "half_batch":
        def make(s):
            inner = real(s)

            def advance(state, z):
                new = inner(state, z)
                B = state.done.shape[0]
                left = torch.arange(B, device=state.done.device) >= B // 2
                old = _counting(state, s.cfg, left)
                return dataclasses.replace(new, **{
                    f.name: torch.where(left.reshape((B,) + (1,) * (
                        getattr(new, f.name).dim() - 1)),
                        getattr(old, f.name), getattr(new, f.name))
                    for f in dataclasses.fields(new)
                    if getattr(new, f.name).shape[:1] == (B,)})
            return advance
        solver._ADVANCE["stomp"] = make
    elif name == "answer_altered" and driver == "plan":
        finalize = solver.finalize

        def altered(*a, **k):
            sol = finalize(*a, **k)
            turn = torch.zeros_like(sol.trajectory)
            turn[..., 1] = 0.3
            return dataclasses.replace(sol, trajectory=sol.trajectory + turn)

        solver.finalize = altered
    elif name == "answer_altered" and driver == "mpc":
        tick_out = mpc._tick_out

        def altered(*a, **k):
            state = tick_out(*a, **k)
            return dataclasses.replace(
                state, sphere_center=state.sphere_center + 0.01)

        mpc._tick_out = altered
    elif name == "tick_unchanged" and driver == "mpc":
        def unchanged(robot, cfg, ops, state, *a, **k):
            return dataclasses.replace(state, steps=state.steps + 1)

        mpc._tick_out = unchanged
    else:
        raise ValueError(f"unknown fault {name!r} for {driver!r}")


def run(cell, fault: str, seeds: list, seconds: float, device=None):
    """[(seed, numbers, correct)] of the cell's traffic with `fault`."""
    from benchmark.lib import card
    from benchmark.lib import cell as cells
    from benchmark.run import Context

    dev = device if device is not None else card.require(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    install(fault, cell.traffic["driver"])
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
    p.add_argument("--fault", required=True)
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

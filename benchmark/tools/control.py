#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's, and the
control's (the reference put in the program's place in the next precision
below the configuration's: float32 with TF32 matmuls).

    python3 benchmark/tools/control.py --workload CELL --seconds S \
        --seeds 1,2,...

For each seed, in this one process (set-up is paid once; later seeds
replay the cached graphs), the cell's traffic runs for S seconds; then its
answers are checked as a run checks them (the lower reading) and checked
again with the control's answers in their place (the upper reading). One
JSON line a seed.
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


def readings(cell, seeds: list, seconds: float, device=None):
    """[(seed, program's numbers, control's numbers)]."""
    from benchmark.lib import card
    from benchmark.lib import cell as cells
    from benchmark.run import Context

    dev = device if device is not None else card.require(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    driver = cells.module("drivers", cell.traffic["driver"])
    out = []
    for seed in seeds:
        runner = driver.Runner(Context(cell, cell.config, cell.traffic, seed,
                                       dev))
        runner.window(seconds)
        runner.release()
        out.append((seed, runner.check("reference"),
                    runner.check("control")))
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5)
    p.add_argument("--seeds", default="1,2,3")
    a = p.parse_args()
    from benchmark.lib import cell as cells

    cell = cells.load(a.workload)
    for seed, prog, ctrl in readings(cell, [int(s) for s in
                                            a.seeds.split(",")], a.seconds):
        print(json.dumps(dict(cell=a.workload, seed=seed, program=prog,
                              control=ctrl, limits=cell.config["checks"])),
              flush=True)


if __name__ == "__main__":
    main()

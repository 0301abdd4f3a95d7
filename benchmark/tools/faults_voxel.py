#!/usr/bin/env python3
"""Faults planted underneath the timed path of a cell over a voxelized
field, to see the check catch them.

    python3 benchmark/tools/faults_voxel.py --fault NAME \
        --workload stomp7_voxel.batch1024 --seconds S --seeds 1,2,3

As tools/faults.py (one fault installed before set-up, so the field and
the captured graphs hold it; one line a seed), with the faults of a
field:

  grid_bf16       the field is held in bfloat16: the signed EDT's values
                  (and so its corner table) rounded to bfloat16;
  grid_shifted    the field's origin moved by one voxel along x;
  nearest_voxel   the field is read at the nearest voxel in place of the
                  trilinear sample (the evaluator then runs as plain
                  torch on the device, the kernel having no such route);
  step_unchanged  the STOMP step returns its state unchanged
                  (tools/faults.py's);
  answer_altered  a plan's returned trajectory turns joint 1 by 0.3 rad
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

FAULTS = ("grid_bf16", "grid_shifted", "nearest_voxel", "step_unchanged",
          "answer_altered")


def _nearest_sdf(world, p):
    """The field at the voxel nearest each point (grid coordinates clipped
    as the trilinear sample clips them)."""
    from tpustomp_torch.world import sdf

    if not isinstance(world, sdf.GridSDF):
        return sdf.sdf(world, p)
    shape = tuple(world.grid.shape)
    hi, _ = sdf._grid_bounds(shape, p.device)
    g = torch.minimum(((p - world.origin) / world.resolution).clamp(min=0.0),
                      hi)
    i = torch.round(g).to(torch.int64)
    _, Y, Z = shape
    return world.grid.reshape(-1)[(i[..., 0] * Y + i[..., 1]) * Z
                                  + i[..., 2]]


def install(name: str) -> None:
    from tpustomp_torch.costs import obstacle
    from tpustomp_torch.engine import solver
    from tpustomp_torch.kernels import rollout
    from tpustomp_torch.world import edt
    from tpustomp_torch.world.sdf import GridSDF

    if name in ("step_unchanged", "answer_altered"):
        faults.install(name, "plan")
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name == "nearest_voxel":
        obstacle.sdf = _nearest_sdf

        def plain(robot, world, fulls, dt, clearance, row_active=None,
                  time_major=False, cands_per_row=None, constraints=None):
            return rollout.obstacle_cost_batch_plain(
                robot, world, fulls, dt, clearance, time_major=time_major,
                cands_per_row=cands_per_row, constraints=constraints)

        solver.obstacle_cost_batch = plain
        return
    real = edt.signed_edt

    def planted(occ, resolution, origin):
        field = real(occ, resolution, origin)
        grid, origin = field.grid, field.origin.clone()
        if name == "grid_bf16":
            grid = grid.to(torch.bfloat16).float()
        else:
            origin[0] += field.resolution
        return GridSDF.make(grid.numpy(), origin.numpy(),
                            float(field.resolution))

    edt.signed_edt = planted


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

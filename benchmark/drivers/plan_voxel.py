"""Planning queries over a voxelized world, back to back from one caller
(closed loop): the plan driver (drivers/plan.py; the same traffic keys)
for a configuration whose world is of kind "voxel" (worlds/voxel.py),
with the check of reference/voxel.py: the returned answers against the
float64 field made from the same boxes, and box_intrusion against the
exact boxes.

The traced run adds "spans": the field built once more, on the device,
with the program's spans on and no profiler (the `world.sdf` span's host
time is what a deployment pays at each scene change).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import plan
from benchmark.lib import trace
from benchmark.reference import voxel


class Runner(plan.Runner):
    def __init__(self, ctx, traced: bool = False):
        super().__init__(ctx, traced)
        # the field the timed path reads, kept past release() for the check
        world = self.scene.world
        self.field = (world.grid, world.packed)

    def traced(self) -> dict:
        """plan.Runner's traced run and the build's spans window."""
        from tpustomp_torch.utils import tracing

        out = super().traced()
        tracing.clear_spans()      # the profiler's windows' spans go
        t0 = tracing.trace_us(time.time_ns())
        with tracing.spans():
            field = self.scene.kind.program(self.ctx.config["world"],
                                            self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        out["spans"] = trace.Window(t0=t0,
                                    t1=tracing.trace_us(time.time_ns()))
        del field
        return out

    def check(self, precision: str = "reference") -> dict:
        """cost_gap, false_claims, box_intrusion and field_gap of the kept
        answers and the field (in the control's case, its own answers and
        field in the control precision) against reference/voxel.py, and
        the window's unsolved_share."""
        ans = {k: np.concatenate(v) if v else np.zeros(0)
               for k, v in self.answers.items()}
        config, dev = self.ctx.config, self.ctx.device
        field = self.field
        if precision == "control":
            ans, field = voxel.control_plans(config, ans, dev)
        out = voxel.check_plans(config, ans, dev, field)
        out["false_claims"] += self.missing
        out["unsolved_share"] = self.summary()["unsolved_share"]
        return out

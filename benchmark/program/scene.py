"""The program's side of a configuration, shared by the traffic drivers:
its planner, robot and world, and the evaluator's kernel and shapes for the
roofline. The world's kind (world["kind"] in the configuration file) names
benchmark/worlds/<kind>.py, which builds the program's world and names its
evaluator kernel."""

from __future__ import annotations

from benchmark.lib import cell as cells


class Scene:
    def __init__(self, config: dict, device):
        from tpustomp_torch.api.config import from_dict
        from tpustomp_torch.robot import model

        self.config = config
        self.kind = cells.module("worlds", config["world"]["kind"])
        self.cfg = from_dict(config["planner"])
        self.robot = getattr(model, config["robot"]["builtin"])().to(device)
        self.world = self.kind.program(config["world"], device)

    def evaluator(self, C: int, rows: int = 0, ns: int = 0) -> dict:
        """The evaluator launch the roofline reads: its kernel's name, C
        candidates of T waypoints, rows worlds of ns moving spheres each."""
        geo = self.config["robot"]["geometry"]
        return dict(match=self.kind.KERNEL, C=C, T=self.cfg.num_timesteps + 2,
                    d=len(geo["joint_axis"]), nb=len(geo["body_link"]),
                    ns=ns, rows=rows, geometry=geo,
                    **self.kind.shape(self.config["world"]))

    def release(self) -> None:
        """Drop the program's objects before the check."""
        self.robot = self.world = None

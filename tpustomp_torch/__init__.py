"""tpustomp_torch — the PyTorch/CUDA port of tpustomp (STOMP trajectory
optimization), for NVIDIA Hopper GPUs.

A second package beside the JAX reference ``tpustomp``; it imports torch
and numpy only. The batched STOMP path (``plan`` / ``plan_batch`` over
analytic, voxel-grid and grid+overlay worlds) runs end to end; its fused
FK→SDF→cost evaluator is a hand-written CUDA kernel per world kind
(kernels/rollout.py, csrc/rollout_analytic.cu, csrc/rollout_grid.cu).
"""

from tpustomp_torch.api.config import (
    CostWeights,
    NoiseConfig,
    PlannerConfig,
    SmoothnessConfig,
)
from tpustomp_torch.api.plan import plan, plan_batch
from tpustomp_torch.api.problem import ProblemSpec, Solution

__all__ = [
    "PlannerConfig",
    "NoiseConfig",
    "CostWeights",
    "SmoothnessConfig",
    "ProblemSpec",
    "Solution",
    "plan",
    "plan_batch",
]

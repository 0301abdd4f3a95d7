"""Problem and solution types (port of ``tpustomp/api/problem.py``).

Frozen dataclasses of tensors. Batched problems carry a leading scenario
axis on every field; so does the Solution that ``plan_batch`` returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpustomp_torch._tensors import to_device, to_host
from tpustomp_torch.utils import tracing


@dataclass(frozen=True)
class ProblemSpec:
    """One planning query (or a batch of them): go from q0 to qN.

    q0, qN: [d] joint values, or [B, d] for a batch. Any array-like works;
    the planner converts to float32 tensors on its device.

    goal_tolerance_below / goal_tolerance_above: the reference's per-joint
    goal band, [d] or [B, d] (None: exact); any endpoint in
    [qN − below, qN + above] satisfies the goal, and the planner picks one
    (api/plan.resolve_goal_tolerance).
    """

    q0: torch.Tensor
    qN: torch.Tensor
    goal_tolerance_below: torch.Tensor | None = None
    goal_tolerance_above: torch.Tensor | None = None


@dataclass(frozen=True)
class IterationMetrics:
    """Per-iteration observability tensors ([..., max_iterations]).

    Entries past the converged iteration hold zeros (the frozen values)."""

    total_cost: torch.Tensor
    obstacle_cost: torch.Tensor
    smoothness_cost: torch.Tensor
    constraint_cost: torch.Tensor
    collision_free: torch.Tensor


@dataclass(frozen=True)
class Solution:
    """Planner output; fields carry a leading batch axis from plan_batch.

    trajectory: [..., N+2, d] — all true waypoints including the endpoints.
    """

    trajectory: torch.Tensor
    times: torch.Tensor           # [..., N+2] uniform dt timestamps
    success: torch.Tensor         # bool — collision-free at termination
    cost: torch.Tensor            # total cost of the returned trajectory
    iterations: torch.Tensor      # iterations actually used
    metrics: IterationMetrics | None = None

    def to(self, device) -> "Solution":
        """This solution on `device`; to the host from the card through
        page-locked memory when it is large (_tensors.to_host: a batch's
        answer), so those tensors are pinned."""
        with tracing.request("solution.copy", to=device):
            if torch.device(device).type == "cpu":
                return to_host(self)
            return to_device(self, device)

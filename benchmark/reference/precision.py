"""The precision a check runs in: "reference" (float64) or "control"
(float32 whose every matmul takes its operands rounded to TF32, a 10-bit
mantissa, as TF32 tensor cores do: the next precision below the float32,
TF32 off, that the configurations state). The control rounds the operands
itself, so it does not depend on whether a matmul library picks a TF32
kernel for a given shape."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("reference", "control"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "reference" else torch.float32

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "control":
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)

"""The card a run measures: present, enough of them, described."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for: the run ends with no
    result. Nothing falls back to the CPU."""


def require(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "measures a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def describe() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"

"""Kernels a solver-loop iteration in the traced window: kernel launches on
the device (counted inside IF-node bodies too) over the loop iterations."""


def read(t):
    n = t["counts"].get("loop_iterations")
    return len(t["window"].kernels) / n if n else None

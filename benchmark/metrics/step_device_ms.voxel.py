"""Device ms a solver-loop iteration over the voxelized field: kernel time
of the traced window (chunk route, solve-in and solve-out included) over
the loop iterations it ran (each call runs as many as its slowest
query)."""


def read(t):
    n = t["counts"].get("loop_iterations")
    if not n or not t["window"].kernels:
        return None
    return 1e3 * t["window"].kernel_seconds() / n

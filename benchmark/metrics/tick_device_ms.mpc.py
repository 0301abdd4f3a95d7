"""Device ms an MPC tick: kernel time of the traced episode over its
ticks: engine.mpc."""


def read(t):
    n = t["counts"].get("ticks")
    if not n or not t["window"].kernels:
        return None
    return 1e3 * t["window"].kernel_seconds() / n

"""The least time the chip could take for one evaluator launch, from its
shapes, against the published peaks of one H100 SXM.

The operation counts follow the evaluator source (the FK chain, then per
body its placement, speed, potential, sum and margin, and its distance to
each primitive); the bytes are the candidates read once and the costs and
margins written once. The chain's axis codes come from the robot's own
arrays (0, +1, -1, or OTHER for a value read at run time), as the kernel
folds them.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: float32 outside the tensor
# cores, and HBM3.
PEAK_FP32_OPS, PEAK_BYTES = 67e12, 3.35e12
OPS_BODY, OPS_SPHERE, OPS_BOX, OPS_GRID = 40, 11, 25, 51
OPS_CONE, OPS_POSITION = 28, 32
OTHER = 2          # an axis component neither 0 nor +-1


def axis_codes(geometry: dict) -> list:
    """Per joint (x, y, z) codes of its axis: the value itself when it is
    0, +1 or -1, else OTHER."""
    def code(a):
        return int(a) if a in (0.0, 1.0, -1.0) else OTHER

    return [tuple(code(float(a)) for a in axis)
            for axis in geometry["joint_axis"]]


def fk_ops(geometry: dict, static: bool = True) -> int:
    """Float operations of one waypoint's FK: per joint the origin (18) and
    R·RotFixed (45) unless every fixed rotation is the identity; a revolute
    joint's sincos (2) and 1 - cos (1), the live terms of G (a run-time
    coefficient costs its product and the term's multiply; +1 and -1 fold
    to nothing), and R·G over G's live entries; a prismatic joint's axis
    projection and translation. static=False folds nothing (the runtime
    chain): every component is OTHER."""
    d = len(geometry["joint_axis"])
    codes = axis_codes(geometry) if static else [(OTHER,) * 3] * d
    identity = bool(geometry.get("rot_fixed_identity", True))

    def mul(a, b):
        return 0 if 0 in (a, b) else OTHER if OTHER in (a, b) else a * b

    ops = 0
    for prismatic, (x, y, z) in zip(geometry["joint_prismatic"], codes):
        ops += 18 + (0 if identity else 45)
        if prismatic:
            n = sum(k != 0 for k in (x, y, z))
            per_row = sum(k == OTHER for k in (x, y, z)) + max(n - 1, 0)
            ops += 3 * (per_row + 2) if n else 0
            continue
        ops += 3
        live = []
        for a, b, k_s in ((x, x, None), (x, y, z), (x, z, y),
                          (y, x, z), (y, y, None), (y, z, x),
                          (z, x, y), (z, y, x), (z, z, None)):
            k_oc = mul(a, b)
            terms = [(k_oc != 0, 2 if k_oc == OTHER else 0),
                     (True, 0) if k_s is None
                     else (k_s != 0, 1 if k_s == OTHER else 0)]
            n = sum(lv for lv, _ in terms)
            live.append(n > 0)
            ops += sum(c for lv, c in terms if lv) + max(n - 1, 0)
        for col in range(3):
            ops += 3 * (2 * sum(live[col + 3 * k] for k in range(3)) - 1)
    return ops


def bound(C, T, d, fk, nb, ns, nx, grid_voxels=0, rows=0, ee=False,
          con_ops=None):
    """(bound_ms, bound_by) of one evaluator launch over C candidates of T
    waypoints: the larger of its float operations (fk per waypoint; con_ops
    per waypoint on the constraint route) over the fp32 peak and the bytes
    it must move (the candidates, the grid and per-row primitives read
    once; q_obs, margin, ee and q_con written once) over the memory
    rate."""
    per_body = OPS_BODY + OPS_SPHERE * ns + OPS_BOX * nx + (
        OPS_GRID if grid_voxels else 0)
    ops = C * T * (fk + nb * per_body + (con_ops or 0))
    nbytes = 4 * (C * T * d + C * T + C + (12 * C * T if ee else 0)
                  + (C * T if con_ops is not None else 0)
                  + grid_voxels + rows * (4 * ns + 6 * nx))
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def evaluator_pct(traced: dict) -> float | None:
    """The evaluator's share of its roofline in the traced run: bound_ms at
    the cell's full shape over the mean device time of the launches that
    open each run of step launches in the per-iteration window (the step's
    launches have the largest grid; the first of a solve or a tick has every
    candidate active, which the bound counts). None without such launches."""
    ev = traced["evaluator"]
    window = traced.get("per_iteration")
    launches = [e for e in (window.kernels if window else [])
                if ev["match"] in e.name]
    if not launches:
        return None

    def size(e):
        n = 1
        for g in e.grid:
            n *= int(g)
        return n

    top = max(size(e) for e in launches)
    first, prev = [], False
    for e in launches:
        if size(e) == top and not prev:
            first.append(e)
        prev = size(e) == top
    ms = sum(e.dur for e in first) / len(first) / 1e3
    bound_ms, _ = bound(ev["C"], ev["T"], ev["d"], fk_ops(ev["geometry"]),
                        ev["nb"], ev["ns"], ev["nx"], rows=ev["rows"])
    return 100.0 * bound_ms / ms

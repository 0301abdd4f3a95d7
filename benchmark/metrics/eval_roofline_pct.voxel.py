"""The grid evaluator's share of its roofline (K5, rollout_grid) at the
cell's shape, the grid counted: lib.roofline.evaluator_pct's launches and
time, against bound(..., grid_voxels=X·Y·Z), whose operations take
OPS_GRID a body and waypoint and whose bytes take the grid once."""

from benchmark.lib.roofline import bound, evaluator_pct, fk_ops


def read(t):
    pct = evaluator_pct(t)
    ev = t["evaluator"]
    if pct is None or not ev.get("grid_voxels"):
        return None
    args = (ev["C"], ev["T"], ev["d"], fk_ops(ev["geometry"]), ev["nb"],
            ev["ns"], ev["nx"])
    without, _ = bound(*args, rows=ev["rows"])
    with_grid, _ = bound(*args, grid_voxels=ev["grid_voxels"],
                         rows=ev["rows"])
    # evaluator_pct is 100 · without / ms over the same launches
    return pct * with_grid / without

"""Occupancy grid → analytic boxes (port of ``tpustomp/world/decompose.py``).

A static voxel scene compiles to an `AnalyticWorld` of disjoint boxes, which
the fused analytic evaluator (csrc/rollout_analytic.cu) runs without any
gather. A voxelized tabletop is exactly 2 boxes.

Accuracy contract (as the reference's):
  - Boxes span the hull of voxel CENTERS (half-extent (n−1)/2·res),
    matching `signed_edt`'s voxel-center seeds; pass `inflate=res/2` for the
    voxel-extent reading (conservative by half a voxel).
  - Inside the solid the union of per-box distances reports the distance to
    the nearest box face, which may be an interior seam: shallower than the
    true EDT, but inside is still inside.
"""

from __future__ import annotations

import numpy as np

from tpustomp_torch.world.sdf import AnalyticWorld


def boxes_from_occupancy(occ: np.ndarray) -> list[tuple]:
    """Greedy maximal-cuboid cover of a boolean occupancy grid.

    Returns ((x0, y0, z0), (x1, y1, z1)) inclusive voxel-index ranges whose
    union is exactly the occupied set (the boxes are disjoint). Growth order
    x, then y, then z from the lexicographically first uncovered voxel.
    """
    occ = np.asarray(occ, bool)
    uncovered = occ.copy()
    boxes = []
    X, Y, Z = occ.shape
    while True:
        idx = np.argwhere(uncovered)
        if idx.size == 0:
            break
        x0, y0, z0 = idx[0]
        x1 = x0
        while x1 + 1 < X and uncovered[x1 + 1, y0, z0]:
            x1 += 1
        y1 = y0
        while y1 + 1 < Y and uncovered[x0:x1 + 1, y1 + 1, z0].all():
            y1 += 1
        z1 = z0
        while z1 + 1 < Z and uncovered[x0:x1 + 1, y0:y1 + 1, z1 + 1].all():
            z1 += 1
        uncovered[x0:x1 + 1, y0:y1 + 1, z0:z1 + 1] = False
        boxes.append(((int(x0), int(y0), int(z0)),
                      (int(x1), int(y1), int(z1))))
    return boxes


def analytic_from_occupancy(occ: np.ndarray, resolution: float, origin,
                            inflate: float = 0.0,
                            max_boxes: int | None = None) -> AnalyticWorld:
    """Compile an occupancy grid into an AnalyticWorld of boxes. Raises if
    the cover needs more than `max_boxes` boxes (when given); nothing is
    truncated."""
    origin = np.asarray(origin, np.float64)
    boxes = boxes_from_occupancy(occ)
    if max_boxes is not None and len(boxes) > max_boxes:
        raise ValueError(
            f"occupancy decomposes into {len(boxes)} boxes > max_boxes="
            f"{max_boxes}; use the GridSDF path for this scene")
    specs = []
    for (x0, y0, z0), (x1, y1, z1) in boxes:
        lo = origin + resolution * np.asarray([x0, y0, z0], np.float64)
        hi = origin + resolution * np.asarray([x1, y1, z1], np.float64)
        specs.append((tuple((lo + hi) / 2.0),
                      tuple((hi - lo) / 2.0 + inflate)))
    return AnalyticWorld.make(boxes=specs)

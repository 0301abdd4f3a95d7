"""A voxelized world: the configuration's world["boxes"] (each a [centre,
half-size] pair in metres) voxelized over world["grid"] (origin, shape,
resolution) into a signed EDT. The program builds it through its own API,
occupancy_from_analytic then signed_edt (with the packed corner table),
and holds it as a GridSDF on the device; its evaluator is the grid
kernel (K5)."""

KERNEL = "rollout_grid_kernel"


def program(world: dict, device):
    """The program's field on `device`."""
    from tpustomp_torch.world import edt
    from tpustomp_torch.world.sdf import AnalyticWorld

    g = world["grid"]
    boxes = AnalyticWorld.make(boxes=[(tuple(c), tuple(h))
                                      for c, h in world["boxes"]])
    occ = edt.occupancy_from_analytic(boxes, g["origin"], g["shape"],
                                      g["resolution"])
    return edt.signed_edt(occ, g["resolution"], g["origin"]).to(device)


def shape(world: dict) -> dict:
    """The world's part of the evaluator's roofline (lib/roofline.bound):
    no primitives, the grid's voxels."""
    X, Y, Z = world["grid"]["shape"]
    return {"nx": 0, "grid_voxels": int(X) * int(Y) * int(Z)}

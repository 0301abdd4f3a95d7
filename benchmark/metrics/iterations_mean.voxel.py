"""Mean solver iterations a query ran over the voxelized field, over the
traced window's queries (Solution.iterations): engine.solver."""


def read(t):
    return t["counts"].get("iterations_mean")

"""A world of boxes: the configuration's world["boxes"], each a [centre,
half-size] pair in metres. The program holds it as an AnalyticWorld; its
evaluator is the analytic kernel (K3 for one world, K3-pcw for a world a
scenario)."""

KERNEL = "rollout_analytic_kernel"


def program(world: dict, device):
    """The program's world on `device`."""
    from tpustomp_torch.world.sdf import AnalyticWorld

    return AnalyticWorld.make(boxes=[(tuple(c), tuple(h))
                                     for c, h in world["boxes"]]).to(device)


def shape(world: dict) -> dict:
    """The world's part of the evaluator's roofline (lib/roofline.bound)."""
    return {"nx": len(world["boxes"])}

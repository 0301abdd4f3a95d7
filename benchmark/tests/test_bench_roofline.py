"""The copied roofline arithmetic reproduces the kernel table's bounds."""

import json

import pytest

from benchmark.lib import roofline
from benchmark.lib.cell import BENCH
from benchmark.lib.trace import Event, Window

GEO = json.loads((BENCH / "configs" / "stomp7_tabletop.json").read_text())[
    "robot"]["geometry"]


def test_fk_ops_match_the_programs_chain():
    from tpustomp_torch.kernels import rollout
    from tpustomp_torch.robot.model import arm_7dof

    chain = rollout.chain_of(arm_7dof())
    codes = [tuple(chain[2 + 5 * j:5 + 5 * j]) for j in range(7)]
    assert roofline.axis_codes(GEO) == codes
    assert roofline.fk_ops(GEO) == 301
    assert roofline.fk_ops(GEO, static=False) == 693


CONE = roofline.OPS_CONE


@pytest.mark.parametrize("C, T, ns, nx, kw, ms, by", [
    (57_344, 102, 0, 2, {}, 0.121, "operations"),              # K3
    (210_000, 52, 1, 2, dict(rows=10_000), 0.247, "operations"),  # K3-pcw
    (57_344, 102, 0, 2, dict(ee=True), 0.140, "bytes"),        # K3-ee
    (57_344, 102, 0, 2, dict(con_ops=CONE), 0.123, "operations"),  # K3:con
    (210_000, 52, 1, 2, dict(rows=10_000, con_ops=CONE), 0.251,
     "operations"),                                             # pcw:con
    (57_344, 102, 0, 0, dict(grid_voxels=64 * 80 * 48), 0.122,
     "operations"),                                             # K5
    (210_000, 52, 1, 0, dict(grid_voxels=64 * 80 * 48, rows=10_000), 0.249,
     "operations"),                                             # K5-pco
])
def test_bound_reproduces_the_kernel_table(C, T, ns, nx, kw, ms, by):
    got, got_by = roofline.bound(C, T, 7, roofline.fk_ops(GEO), 12, ns, nx,
                                 **kw)
    assert round(got, 3) == ms and got_by == by


def test_evaluator_share_takes_each_runs_first_full_launch():
    big, small = (448, 1, 1), (8, 1, 1)
    k = "rollout_analytic_kernel<x>"
    w = Window(t0=0, t1=100, kernels=[
        Event(k, 0, 2.0, big), Event(k, 3, 1.0, big), Event(k, 5, 0.5, small),
        Event("other", 6, 9.0, big), Event(k, 20, 4.0, big),
        Event(k, 30, 1.0, big)])
    ev = dict(match="rollout_analytic_kernel", C=57_344, T=102, d=7, nb=12,
              ns=0, nx=2, rows=0, geometry=GEO)
    bound_ms, _ = roofline.bound(57_344, 102, 7, 301, 12, 0, 2)
    got = roofline.evaluator_pct(dict(evaluator=ev, per_iteration=w))
    assert got == pytest.approx(100 * bound_ms / ((2.0 + 4.0) / 2 / 1e3))
    assert roofline.evaluator_pct(dict(evaluator=ev,
                                       per_iteration=Window())) is None

"""The plain reference of a voxelized world (benchmark/reference/voxel.py)
against the port's own field: the signed EDT (world/edt.py signed_edt),
the trilinear lookup (world/sdf.py sdf on a GridSDF, packed and dense), a
plan made on the field judged by the reference's check, and the spans of a
field's build.

Tolerances: the fields are equal (the reference's float64 field rounded to
float32 against the port's grid, bit for bit: both are exact squared
distances, the same square root and the same product with the
resolution); lookups rtol = atol = 1e-6 (the port samples in float32, the
reference in float64; measured max |Δ| 4.1e-7 at distances up to 3 m).
This file imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import voxel
from tpustomp_torch import ProblemSpec, plan_batch
from tpustomp_torch.api.config import from_dict
from tpustomp_torch.robot.model import arm_7dof
from tpustomp_torch.utils import tracing
from tpustomp_torch.world import edt
from tpustomp_torch.world.sdf import AnalyticWorld, GridSDF, sdf

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmark" / "configs" / "stomp7_voxel.json")
                 .read_text())
# the configuration's 3 x 3 x 4 m field at 8 cm
COARSE = dict(CFG["world"]["grid"], shape=[38, 38, 50], resolution=0.08)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs on one CPU thread (restored after), with an empty
    span buffer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear_spans()
    yield
    tracing.clear_spans()
    torch.set_num_threads(n)


def _tabletop(grid=COARSE) -> np.ndarray:
    boxes = AnalyticWorld.make(boxes=[(tuple(c), tuple(h))
                                      for c, h in CFG["world"]["boxes"]])
    return edt.occupancy_from_analytic(boxes, grid["origin"], grid["shape"],
                                       grid["resolution"])


def _occupancy(case: str, shape, seed: int) -> np.ndarray:
    if case == "tabletop":
        return _tabletop()
    occ = np.zeros(shape, bool)
    if case == "one_voxel":
        occ[tuple(np.random.default_rng(seed).integers(0, shape))] = True
    elif case == "random":
        occ = np.random.default_rng(seed).random(shape) < 0.08
    return occ


def test_the_reference_loads_no_jax_nor_either_package():
    code = ("import sys; import benchmark.reference.voxel; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"tpustomp_torch", "tpustomp", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("case, shape, seed", [
    ("random", (12, 10, 9), 0), ("random", (12, 10, 9), 1),
    ("random", (7, 13, 5), 2), ("random", (2, 3, 17), 3),
    ("all_free", (6, 5, 4), 0), ("one_voxel", (9, 8, 7), 4),
    ("tabletop", tuple(COARSE["shape"]), 0)])
def test_the_reference_field_is_the_ports_signed_edt(case, shape, seed):
    occ = _occupancy(case, shape, seed)
    port = edt.signed_edt(occ, 0.08, (0.1, -0.2, 0.3))
    ref = voxel.signed_edt(torch.as_tensor(occ), 0.08, torch.float64)
    assert ref.dtype == torch.float64
    assert torch.equal(ref.float(), port.grid)
    # every corner of the table the port's sampler reads
    assert voxel.field_gap(ref, port.grid, port.packed) <= 1e-7 * float(
        ref.abs().max())
    if case == "all_free":
        assert (ref == voxel.BIG).all()


def test_the_reference_occupancy_is_the_ports():
    ref = voxel.occupancy(CFG["world"]["boxes"], COARSE["origin"],
                          COARSE["shape"], COARSE["resolution"], CPU)
    occ = _tabletop()
    assert occ.any() and np.array_equal(ref.numpy(), occ)


@pytest.mark.parametrize("pack", [True, False])
def test_the_reference_lookup_is_the_ports_sample(pack):
    world = dict(CFG["world"], grid=COARSE)
    ref = voxel.VoxelWorld(world, torch.float64, CPU)
    port = edt.signed_edt(_tabletop(), COARSE["resolution"],
                          COARSE["origin"])
    if not pack:
        port = GridSDF(port.grid, port.origin, port.resolution)
    rng = np.random.default_rng(7)
    lo = np.asarray(COARSE["origin"])
    hi = lo + COARSE["resolution"] * (np.asarray(COARSE["shape"]) - 1)
    p = np.concatenate([rng.uniform(lo, hi, (300, 3)),
                        rng.uniform(lo - 0.5, hi + 0.5, (300, 3)), [hi]])
    p = torch.as_tensor(p, dtype=torch.float32)
    got = sdf(port, p).double()
    want = ref.distance(p.double())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (want < 0).any() and (want > 0).any()


def test_a_plan_on_the_coarse_field_passes_the_check():
    config = json.loads(json.dumps(CFG))
    config["world"]["grid"] = COARSE
    config["planner"].update(num_timesteps=20, max_iterations=30)
    field = edt.signed_edt(_tabletop(), COARSE["resolution"],
                           COARSE["origin"])
    rng = np.random.default_rng(3)
    q0 = np.asarray(CFG["q0"]) + rng.uniform(-0.03, 0.03, (3, 7))
    qN = np.asarray(CFG["qN"]) + rng.uniform(-0.03, 0.03, (3, 7))
    q0, qN = q0.astype(np.float32), qN.astype(np.float32)
    sol = plan_batch(arm_7dof(), field, ProblemSpec(q0=q0, qN=qN),
                     from_dict(config["planner"]), device="cpu",
                     generator=torch.Generator().manual_seed(5))
    ans = dict(trajectory=sol.trajectory.numpy(), cost=sol.cost.numpy(),
               success=sol.success.numpy(), iterations=sol.iterations.numpy(),
               q0=q0, qN=qN)
    out = voxel.check_plans(config, ans, CPU, (field.grid, field.packed))
    assert out["false_claims"] == 0, out
    assert 0.0 < out["cost_gap"] < 1e-4, out
    assert out["field_gap"] < 1e-6, out
    # the reference's field of boxes one voxel further along x: the cost
    # shows the answers were not made on it
    moved = dict(config["world"], boxes=[
        [[c[0] + COARSE["resolution"], *c[1:]], h]
        for c, h in config["world"]["boxes"]])
    out = voxel.check_plans(dict(config, world=moved), ans, CPU)
    assert out["cost_gap"] > 1e-2, out


def test_the_builds_spans_and_the_same_grid_without_them():
    occ = _tabletop()
    off = edt.signed_edt(occ, COARSE["resolution"], COARSE["origin"])
    assert not tracing.recorded().spans
    with tracing.spans():
        on = edt.signed_edt(occ, COARSE["resolution"], COARSE["origin"])
        on.to("cpu")
    spans = {s.name: s for s in tracing.recorded().spans}
    assert set(spans) == {"world.sdf", "world.edt", "world.pack",
                          "world.copy"}
    build = spans["world.sdf"]
    assert build.parent is None and build.attrs == dict(
        voxels=occ.size, occupied=int(occ.sum()), packed=True)
    for child in ("world.edt", "world.pack"):
        assert spans[child].parent == build.id
        assert build.start_ns <= spans[child].start_ns
        assert spans[child].end_ns <= build.end_ns
    assert spans["world.pack"].attrs == {"rows": occ.size}
    assert spans["world.copy"].parent is None
    assert spans["world.copy"].attrs == {
        "to": "cpu", "bytes": 4 * occ.size * (1 + 8)}
    assert torch.equal(on.grid, off.grid)
    assert torch.equal(on.packed, off.packed)

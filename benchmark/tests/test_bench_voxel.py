"""The voxel cell (stomp7_voxel.batch1024) at a tiny size on the CPU: its
files, its world's part of the roofline, its five readers on synthetic
traces, and its check against the sound program and planted faults."""

import contextlib
import io
import json
import types

import pytest
import torch

from benchmark import run as harness
from benchmark.lib import cell as cells
from benchmark.lib.roofline import OPS_GRID, bound, evaluator_pct, fk_ops
from benchmark.lib.trace import Event, Window
from benchmark.tools import faults_voxel

CPU = torch.device("cpu")
NAME = "stomp7_voxel.batch1024"
READERS = ("iterations_mean.voxel", "step_device_ms.voxel",
           "eval_roofline_pct.voxel", "device_idle_pct.voxel",
           "sdf_build_ms.voxel")
VOXELS = 150 * 150 * 200


def tiny():
    """The cell at a size the CPU holds in seconds: 8 queries a call, at
    most 20 iterations, the field at 8 cm (38 x 38 x 50), where a sound
    plan enters the exact boxes by up to a third of a voxel, so the
    intrusion's limit is one voxel."""
    cell = cells.load(NAME)
    cell.traffic["batch"] = 8
    cell.config["planner"]["max_iterations"] = 20
    cell.config["world"]["grid"].update(shape=[38, 38, 50], resolution=0.08)
    cell.config["checks"]["box_intrusion"] = 0.08
    return cell


@pytest.fixture
def sound_program():
    """Undo what a fault installs in the program's modules."""
    from tpustomp_torch.costs import obstacle
    from tpustomp_torch.engine import solver
    from tpustomp_torch.world import edt

    saved = (dict(solver._ADVANCE), solver.finalize,
             solver.obstacle_cost_batch, obstacle.sdf, edt.signed_edt)
    yield
    solver._ADVANCE.clear()
    solver._ADVANCE.update(saved[0])
    (solver.finalize, solver.obstacle_cost_batch, obstacle.sdf,
     edt.signed_edt) = saved[1:]


def tiny_run(trace: int):
    args = harness.parse(["--workload", NAME, "--seed", str(2**33 + 7),
                          "--seconds", "0.1", "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(args, tiny(), device=CPU)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_cell_names_its_files():
    cell = cells.load(NAME)
    assert cell.chips == 1 and cell.traffic["driver"] == "plan_voxel"
    assert cell.traffic["batch"] == 1024
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert [m["name"] for m in cell.end_to_end] == ["solved_per_s",
                                                    "setup_s"]
    limits = cell.config["checks"]
    assert set(limits) == {"cost_gap", "false_claims", "unsolved_share",
                           "box_intrusion", "field_gap"}
    assert set(cell.config["checks_why"]) == set(limits)
    world = cell.config["world"]
    assert world["kind"] == "voxel" and world["grid"] == {
        "origin": [-1.5, -1.5, -2.0], "shape": [150, 150, 200],
        "resolution": 0.02}
    tabletop = cells.load("stomp7_tabletop.batch1024").config
    for key in ("planner", "robot", "q0", "qN"):
        assert cell.config[key] == tabletop[key], key
    assert world["boxes"] == tabletop["world"]["boxes"]
    assert cell.config["reduced"] == []


def test_the_world_gives_the_grids_voxels():
    cell = cells.load(NAME)
    kind = cells.module("worlds", cell.config["world"]["kind"])
    assert kind.KERNEL == "rollout_grid_kernel"
    assert kind.shape(cell.config["world"]) == {"nx": 0,
                                                "grid_voxels": VOXELS}


def _traced():
    """A synthetic traced run: two calls of 12 loop iterations; three K5
    launches at C = 57,344 in the per-iteration window; a spans window."""
    cell = cells.load(NAME)
    geo = cell.config["robot"]["geometry"]
    k5 = "void rollout_grid_kernel<GridWorld<0, 0>>"
    grid = (8192, 1, 1)
    per_it = Window(t0=0.0, t1=1000.0, kernels=[
        Event(k5, 10.0, 900.0, grid), Event("gemm", 60.0, 20.0),
        Event(k5, 1000.0, 800.0, (4, 1, 1)), Event(k5, 2000.0, 700.0,
                                                   grid)])
    window = Window(t0=0.0, t1=1000.0, kernels=[
        Event("gemm", 0.0, 300.0), Event(k5, 400.0, 300.0)])
    return dict(window=window, per_iteration=per_it,
                spans=Window(t0=0.0, t1=1000.0),
                counts=dict(calls=2, loop_iterations=24,
                            iterations_mean=11.5, graphs={}),
                evaluator=dict(match="rollout_grid_kernel", C=57344, T=102,
                               d=7, nb=12, ns=0, rows=0, geometry=geo,
                               nx=0, grid_voxels=VOXELS))


def _span(name, ts, end):
    return types.SimpleNamespace(name=name, id=1, parent=None, ts=ts,
                                 end=end, end_ns=1, device_ms=None)


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    t = _traced()
    read = {name: cells.module("metrics", name) for name in READERS}
    spans = [_span("world.sdf", 5.0, 2005.0), _span("world.edt", 6.0, 900.0),
             _span("world.sdf", 5000.0, 9000.0)]            # outside
    monkeypatch.setattr(read["sdf_build_ms.voxel"], "recorded",
                        lambda: spans)
    assert read["iterations_mean.voxel"].read(t) == 11.5
    assert read["step_device_ms.voxel"].read(t) == pytest.approx(
        1e3 * 600e-6 / 24)
    assert read["device_idle_pct.voxel"].read(t) == pytest.approx(40.0)
    assert read["sdf_build_ms.voxel"].read(t) == pytest.approx(2.0)
    # the runs of full-size launches open at 900 and 700 µs: 0.8 ms
    ms, by = bound(57344, 102, 7, fk_ops(t["evaluator"]["geometry"]), 12, 0,
                   0, grid_voxels=VOXELS)
    pct = read["eval_roofline_pct.voxel"].read(t)
    assert pct == pytest.approx(100 * ms / 0.8)
    assert 0.0 < pct < 100.0 and by == "operations"
    # the grid counted: OPS_GRID a body and waypoint above the box-free
    # bound (evaluator_pct's), and its bytes
    bare, _ = bound(57344, 102, 7, fk_ops(t["evaluator"]["geometry"]), 12,
                    0, 0)
    assert ms - bare == pytest.approx(
        1e3 * 57344 * 102 * 12 * OPS_GRID / 67e12)
    assert pct / evaluator_pct(t) == pytest.approx(ms / bare)


def test_the_readers_give_nothing_where_there_is_nothing(monkeypatch):
    t = _traced()
    t["window"].kernels, t["per_iteration"].kernels = [], []
    t["counts"] = {}
    del t["spans"]                         # a driver without the window
    for name in READERS:
        mod = cells.module("metrics", name)
        if hasattr(mod, "recorded"):       # a program without the span
            monkeypatch.setattr(mod, "recorded", lambda: None)
        assert mod.read(t) is None, name


@pytest.mark.parametrize("trace", [0, 1])
def test_the_sound_program_comes_out_correct(trace, sound_program):
    rc, out = tiny_run(trace)
    assert rc == 0 and out["correct"], out["checks"]
    assert out["checks"]["cost_gap"]["value"] > 0.0        # it compared
    if trace:        # on the CPU the counter and the build's span
        assert set(out["metrics"]) == {"iterations_mean.voxel",
                                       "sdf_build_ms.voxel"}
    else:
        assert set(out["metrics"]) == {"solved_per_s", "setup_s"}


@pytest.mark.parametrize("fault, number", [("grid_shifted", "cost_gap"),
                                           ("nearest_voxel", "cost_gap"),
                                           ("grid_bf16", "field_gap")])
def test_a_fault_underneath_fails_its_number(fault, number, sound_program):
    faults_voxel.install(fault)
    rc, out = tiny_run(0)
    c = out["checks"][number]
    assert rc == 0 and out["correct"] is False and c["value"] > c["limit"], \
        out["checks"]

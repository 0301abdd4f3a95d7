"""The CHOMP cell (chomp7_tabletop.batch1024) at a tiny size on the CPU:
its driver through the harness's own run(), its five readers on synthetic
traces, and its check against the control and each planted fault."""

import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch

from benchmark import run as harness
from benchmark.drivers import chomp as driver
from benchmark.lib import cell as cells
from benchmark.lib.roofline import bound, fk_ops
from benchmark.lib.trace import Event, Window
from benchmark.tools import control, faults_chomp

CPU = torch.device("cpu")
NAME = "chomp7_tabletop.batch1024"
READERS = ("iterations_mean.chomp", "step_device_ms.chomp",
           "grad_device_ms.chomp", "eval_roofline_pct.chomp",
           "device_idle_pct.chomp")


def tiny():
    """The cell at a size the CPU holds in seconds: 8 queries a call, at
    most 40 iterations (sound rows stop after 10)."""
    cell = cells.load(NAME)
    cell.traffic["batch"] = 8
    cell.config["planner"]["max_iterations"] = 40
    return cell


@pytest.fixture
def sound_program():
    """Undo what a fault installs in the program's modules."""
    from tpustomp_torch.engine import solver

    saved = (dict(solver._ADVANCE), solver.finalize)
    yield
    solver._ADVANCE.clear()
    solver._ADVANCE.update(saved[0])
    solver.finalize = saved[1]


def tiny_run(trace: int):
    args = harness.parse(["--workload", NAME, "--seed", str(2**33 + 5),
                          "--seconds", "0.1", "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(args, tiny(), device=CPU)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_cell_names_its_files():
    cell = cells.load(NAME)
    assert cell.traffic["driver"] == "chomp"
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert [m["name"] for m in cell.end_to_end] == ["solved_per_s",
                                                    "setup_s"]
    limits = cell.config["checks"]
    assert set(limits) == {"cost_gap", "cost_trace_gap", "false_claims",
                           "unsolved_share"}
    assert set(cell.config["checks_why"]) == set(limits)
    assert cell.config["planner"]["mode"] == "chomp"


@pytest.mark.parametrize("trace", [0, 1])
def test_the_sound_program_comes_out_correct(trace, sound_program):
    rc, out = tiny_run(trace)
    assert rc == 0 and out["correct"], out["checks"]
    assert out["checks"]["cost_trace_gap"]["value"] > 0.0   # it compared
    if trace:        # on the CPU only the counter has something to read
        assert set(out["metrics"]) == {"iterations_mean.chomp"}
    else:
        assert set(out["metrics"]) == {"solved_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults_chomp.FAULTS)
def test_a_fault_underneath_comes_out_not_correct(fault, sound_program):
    faults_chomp.install(fault)
    rc, out = tiny_run(0)
    assert rc == 0 and out["correct"] is False, out["checks"]
    if fault != "answer_altered":         # the trace sees the gradient
        c = out["checks"]["cost_trace_gap"]
        assert c["value"] > c["limit"], c


def test_the_control_comes_out_not_correct(sound_program):
    cell = tiny()
    limits = cell.config["checks"]
    for seed, prog, ctrl in control.readings(cell, [11, 12], 0.1,
                                             device=CPU):
        assert all(prog[k] <= v for k, v in limits.items()), (seed, prog)
        assert ctrl["cost_trace_gap"] > limits["cost_trace_gap"], ctrl


def test_trace_gap_compares_only_the_iterations_both_ran():
    ref = {"totals": np.array([[2.0, 1.0, np.nan], [4.0, np.nan, np.nan]]),
           "ran": np.array([2, 1])}
    got = np.array([[2.0, 1.1, 0.0, 0.0], [4.2, 0.0, 0.0, 0.0]])
    assert driver.trace_gap(got, ref, np.array([3, 1]), 3) == \
        pytest.approx(0.1)
    assert driver.trace_gap(got, ref, np.array([1, 1]), 3) == \
        pytest.approx(0.05)
    got[0, 0] = np.nan
    assert driver.trace_gap(got, ref, np.array([2, 1]), 3) == np.inf


def _span(name, ts, end, ms):
    return types.SimpleNamespace(name=name, id=1, parent=None, ts=ts,
                                 end=end, end_ns=1, device_ms=ms)


def _traced():
    """A synthetic traced run: two calls of 12 loop iterations; three
    evaluator launches at C = 1,024 in the per-iteration window; the
    spans window of the driver's untraced calls."""
    geo = cells.load(NAME).config["robot"]["geometry"]
    k3 = "rollout_analytic_kernel<Shared>"
    per_it = Window(t0=0.0, t1=1000.0, kernels=[
        Event(k3, 10.0, 40.0, (147, 1, 1)), Event("gemm", 60.0, 20.0),
        Event(k3, 100.0, 30.0, (147, 1, 1)), Event(k3, 150.0, 30.0,
                                                   (147, 1, 1))])
    window = Window(t0=0.0, t1=1000.0, kernels=[
        Event("gemm", 0.0, 300.0), Event(k3, 400.0, 300.0)])
    return dict(window=window, per_iteration=per_it,
                spans=Window(t0=0.0, t1=1000.0),
                counts=dict(calls=2, loop_iterations=24,
                            iterations_mean=11.5, graphs={}),
                evaluator=dict(match="rollout_analytic_kernel", C=1024,
                               T=102, d=7, nb=12, ns=0, rows=0,
                               geometry=geo, nx=2))


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    t = _traced()
    read = {name: cells.module("metrics", name) for name in READERS}
    spans = [_span("chomp.grad", 5.0, 9.0, 0.5),
             _span("chomp.grad", 95.0, 99.0, 0.7),
             _span("graph.replay", 1.0, 2.0, None),
             _span("chomp.grad", 2000.0, 2001.0, 9.0)]    # outside
    monkeypatch.setattr(read["grad_device_ms.chomp"], "recorded",
                        lambda: spans)
    assert read["iterations_mean.chomp"].read(t) == 11.5
    assert read["step_device_ms.chomp"].read(t) == pytest.approx(
        1e3 * 600e-6 / 24)
    assert read["grad_device_ms.chomp"].read(t) == pytest.approx(0.6)
    assert read["device_idle_pct.chomp"].read(t) == pytest.approx(40.0)
    ms, _ = bound(1024, 102, 7, fk_ops(t["evaluator"]["geometry"]), 12, 0, 2)
    # the first launch of the run of full-size launches: 40 µs
    assert read["eval_roofline_pct.chomp"].read(t) == pytest.approx(
        100 * ms / 0.040)


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

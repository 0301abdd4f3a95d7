"""Runs of the harness: without a card it fails with no result; the rest of
a run, driven on the CPU at a tiny size, comes out correct on the sound
program and not correct with each fault planted underneath the timed path
or with the control in the program's place."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.lib import cell as cells
from benchmark.lib import guard
from benchmark.lib.cell import ROOT
from benchmark.tools import control, faults

CPU = torch.device("cpu")


def run_cli(cwd, env=None):
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "stomp7_tabletop.single", "--seed", str(2**31 + 7), "--seconds",
           "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def no_result(p):
    last = (p.stdout.strip().splitlines() or [""])[-1]
    try:
        return "correct" not in json.loads(last)
    except (json.JSONDecodeError, TypeError):
        return True


def test_a_run_without_a_card_fails_with_no_result():
    p = run_cli(ROOT)
    assert p.returncode != 0 and no_result(p)
    assert "CUDA" in p.stderr or "cuda" in p.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_cli(tmp_path, env={"PYTHONPATH": ""})
    assert p.returncode != 0 and no_result(p)


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["tpustomp_torch.engine", "torch",
                                   "numpy.linalg"]) == []
    assert guard.forbidden_loaded(["tpustomp.api", "jax._src",
                                   "flaxx"]) == ["jax", "tpustomp"]


def tiny(name):
    """The cell at a size the CPU holds in seconds."""
    cell = cells.load(name)
    if "mpc" in cell.config:
        cell.config["planner"].update(num_timesteps=25)
        cell.config["mpc"]["ticks"] = 30
        cell.traffic["scenarios"] = 16
    else:
        cell.config["planner"].update(num_rollouts=16)
        if cell.traffic["batch"]:
            cell.traffic["batch"] = 8
    return cell


@pytest.fixture
def sound_program():
    """Undo what a fault installs in the program's modules."""
    from tpustomp_torch.engine import mpc, solver

    saved = (dict(solver._ADVANCE), solver.finalize, mpc._tick_out)
    yield
    solver._ADVANCE.clear()
    solver._ADVANCE.update(saved[0])
    solver.finalize, mpc._tick_out = saved[1], saved[2]


def tiny_run(name, seconds=0.1):
    """One run of the tiny cell through the harness's own run(), the look
    for a card skipped; (exit code, result line)."""
    import contextlib
    import io

    from benchmark import run as harness

    cell = tiny(name)
    args = harness.parse(["--workload", name, "--seed", "5", "--seconds",
                          str(seconds), "--trace", "0"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(args, cell, device=CPU)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["stomp7_tabletop.batch1024",
                                  "stomp7_mpc.fleet10k"])
def test_the_sound_program_comes_out_correct(name, sound_program):
    rc, out = tiny_run(name)
    checks = out["checks"]
    assert rc == 0 and checks["false_claims"]["value"] == 0
    if "cost_gap" in checks:
        assert out["correct"]
    else:          # a tiny MPC plan collides more often than the cell's
        for key in ("plan_gap", "sphere_gap"):
            assert checks[key]["value"] <= checks[key]["limit"]


@pytest.mark.parametrize("name, fault", [
    ("stomp7_tabletop.batch1024", "step_unchanged"),
    ("stomp7_tabletop.batch1024", "half_batch"),
    ("stomp7_tabletop.batch1024", "answer_altered"),
    ("stomp7_tabletop.single", "step_unchanged"),
    ("stomp7_tabletop.single", "answer_altered"),
    ("stomp7_mpc.fleet10k", "step_unchanged"),
    ("stomp7_mpc.fleet10k", "half_batch"),
    ("stomp7_mpc.fleet10k", "answer_altered"),
    ("stomp7_mpc.fleet10k", "tick_unchanged"),
])
def test_a_fault_underneath_comes_out_not_correct(name, fault,
                                                  sound_program):
    faults.install(fault, cells.load(name).traffic["driver"])
    rc, out = tiny_run(name)
    assert rc == 0 and out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", ["stomp7_tabletop.batch1024",
                                  "stomp7_tabletop.single",
                                  "stomp7_mpc.fleet10k"])
def test_the_control_comes_out_not_correct(name, sound_program):
    """At a size a test run holds: the reference put in the program's place
    in TF32 (reference/precision.py) fails a limit the program meets, on
    three seeds."""
    cell = tiny(name)
    limits = cell.config["checks"]
    gap = "cost_gap" if "cost_gap" in limits else "plan_gap"
    for seed, prog, ctrl in control.readings(cell, [11, 12, 13], 0.1,
                                             device=CPU):
        assert prog["false_claims"] == 0
        assert prog[gap] <= limits[gap] < ctrl[gap], (seed, prog, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_the_control_fails_on_the_card(name):
    """At the cell's own size, on the card, three seeds: the program keeps
    every limit and the control (the reference in TF32 in its place) fails
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell runs on the card)")
    cell = cells.load(name)
    limits = cell.config["checks"]
    for seed, prog, ctrl in control.readings(cell, [31, 32, 33], 3.0):
        assert all(prog[k] <= v for k, v in limits.items()), (seed, prog)
        assert any(ctrl[k] > v for k, v in limits.items()), (seed, ctrl)

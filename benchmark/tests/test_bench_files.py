"""BENCHMARK.json and the files it names: each loads, names only known
drivers and metrics, and keeps to the benchmark's contract."""

import json
import re

import numpy as np
import pytest
import yaml

from benchmark.lib import cell as cells
from benchmark.lib.cell import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert (runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200) <= 43200
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + CONFIGS
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_with_its_files(name):
    cell = cells.load(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported   # it moves what its cells report
        assert callable(cells.module("metrics", m["name"]).read)
    driver = cells.module("drivers", cell.traffic["driver"])
    assert hasattr(driver, "Runner")
    assert set(cell.config["checks"]) == set(cell.config["checks_why"])


def test_every_metric_reader_and_driver_is_named():
    readers = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]}
    drivers = {json.loads(p.read_text())["driver"]
               for p in (BENCH / "traffic").glob("*.json")}
    assert drivers == {p.stem for p in (BENCH / "drivers").glob("*.py")}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_geometry_is_the_programs_robot(name):
    from tpustomp_torch.robot import model

    cfg = cells._load_json(ROOT / next(
        c["file"] for c in SPEC["configs"] if c["name"] == name))
    geo = cfg["robot"]["geometry"]
    robot = getattr(model, cfg["robot"]["builtin"])()
    f32 = lambda k: np.asarray(geo[k], np.float32)     # noqa: E731
    for key in ("joint_axis", "joint_offset", "joint_lower", "joint_upper",
                "base_pos", "base_rot", "body_offset", "body_radius"):
        np.testing.assert_array_equal(getattr(robot, key).numpy(), f32(key))
    assert robot.body_link.tolist() == geo["body_link"]
    assert robot.joint_limited.tolist() == geo["joint_limited"]
    assert robot.joint_type.tolist() == geo["joint_prismatic"]
    assert robot.rot_fixed_identity == geo["rot_fixed_identity"]


@pytest.mark.parametrize("name, yaml_file", [
    ("stomp7_tabletop", "config4_batch.yaml"),
    ("stomp7_mpc", "config5_mpc.yaml")])
def test_planner_is_the_baseline_configs(name, yaml_file):
    from tpustomp_torch.api.config import from_dict

    cfg = cells._load_json(BENCH / "configs" / f"{name}.json")
    doc = yaml.safe_load((ROOT / "configs" / yaml_file).read_text())
    assert from_dict(cfg["planner"]) == from_dict(doc["planner"])
    scene = yaml.safe_load((ROOT / "configs" / "config2_tabletop.yaml")
                           .read_text())["scene"]
    assert cfg["q0"] == scene["q0"] and cfg["qN"] == scene["qN"]
    assert cfg["world"]["boxes"] == [[b["center"], b["half"]]
                                     for b in scene["boxes"]]
    if "mpc" in cfg:
        from tpustomp_torch.engine import mpc

        assert cfg["mpc"]["goal_eps"] == mpc.GOAL_EPS
        assert cfg["mpc"]["goal_flush"] == mpc.GOAL_FLUSH
        assert cfg["mpc"]["ticks"] == doc["mpc"]["ticks"]
        assert cfg["mpc"]["world_dt"] == doc["mpc"]["world_dt"]
        assert cfg["mpc"]["sphere_speed"] == doc["mpc"]["obstacle_speed"]

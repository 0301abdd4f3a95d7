"""A cell of BENCHMARK.json and everything it names, found by name:

- its configuration: the `file` of its `configs` entry;
- its traffic mix: benchmark/traffic/<traffic>.json, whose "driver" names
  the generator benchmark/drivers/<driver>.py;
- its metrics: the end-to-end metrics that list it (or list no cells) and
  the per-layer metrics that list it, each read by
  benchmark/metrics/<name>.py.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json entries
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, spec: dict | None = None) -> Cell:
    spec = spec if spec is not None else _load_json(ROOT / "BENCHMARK.json")
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    w = cells[0]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    per = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load_json(ROOT / entry["file"]),
                traffic=_load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per)


def module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

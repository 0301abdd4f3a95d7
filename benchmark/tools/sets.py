#!/usr/bin/env python3
"""Runs of benchmark cells, each a new process, one after another, and the
spread of their metrics.

    python3 benchmark/tools/sets.py --out DIR --seconds S \
        RUN [RUN ...]                   # RUN: cell:trace:seed
    python3 benchmark/tools/sets.py --spread DIR/runs.jsonl

Each run's result line (or its failure) is appended to DIR/runs.jsonl with
the cell, seed, trace flag, exit code and wall seconds, and its standard
error to DIR/<cell>.<trace>.<seed>.err. --spread prints, per cell, trace
flag and set (a run's "set" is its position among the runs of the same
cell, seed and flag), every metric's median and spread ((Q3 - Q1) /
median, statistics.quantiles), and the spread of each metric over all
runs of a cell.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib.stats import spread  # noqa: E402


def run_all(out: str, seconds: float, runs: list, timeout: float) -> None:
    os.makedirs(out, exist_ok=True)
    for spec in runs:
        cell, trace, seed = spec.split(":")
        cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
               "--workload", cell, "--seed", seed, "--seconds", str(seconds),
               "--trace", trace]
        t = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=timeout)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.perf_counter() - t
        with open(os.path.join(out, f"{cell}.{trace}.{seed}.err"), "w") as f:
            f.write(stderr)
        lines = stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if rc == 0 and lines else None
        except json.JSONDecodeError:
            result = None
        row = dict(cell=cell, trace=int(trace), seed=int(seed), rc=rc,
                   wall_s=wall, result=result)
        with open(os.path.join(out, "runs.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        brief = (None if result is None else
                 dict(correct=result["correct"],
                      metrics={k: v["value"]
                               for k, v in result["metrics"].items()},
                      checks={k: v["value"]
                              for k, v in result["checks"].items()}))
        print(json.dumps(dict(cell=cell, trace=int(trace), seed=int(seed),
                              rc=rc, wall_s=round(wall, 1), **(brief or {
                                  "tail": stderr[-1500:]}))), flush=True)


def spreads(path: str) -> None:
    rows = [json.loads(line) for line in open(path)]
    seen = defaultdict(int)
    sets = defaultdict(lambda: defaultdict(list))
    for r in rows:
        key = (r["cell"], r["trace"], r["seed"])
        k = seen[key]
        seen[key] += 1
        if r["result"] is None:
            continue
        for m, v in r["result"]["metrics"].items():
            sets[(r["cell"], r["trace"], m)][k].append(v["value"])
    for (cell, trace, m), by_set in sorted(sets.items()):
        every = [v for vals in by_set.values() for v in vals]
        parts = []
        for k, vals in sorted(by_set.items()):
            med = sorted(vals)[len(vals) // 2]
            parts.append(f"set{k}: n={len(vals)} median={med:.6g} "
                         f"spread={spread(vals) if len(vals) > 1 else 0:.4%}")
        print(f"{cell} trace={trace} {m}: " + "; ".join(parts)
              + f"; all: spread={spread(every) if len(every) > 1 else 0:.4%}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    p.add_argument("--seconds", type=float, default=40)
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--spread")
    p.add_argument("runs", nargs="*")
    a = p.parse_args()
    if a.spread:
        spreads(a.spread)
    else:
        run_all(a.out, a.seconds, a.runs, a.timeout)
        spreads(os.path.join(a.out, "runs.jsonl"))


if __name__ == "__main__":
    main()

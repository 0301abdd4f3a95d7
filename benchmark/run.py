#!/usr/bin/env python3
"""Benchmark of tpustomp_torch (the PyTorch/CUDA port) on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json once, from the root of a checkout, on the
card(s) of the machine it is started on. Set-up (imports, the kernels'
libraries, the cell's inputs and warm-up calls, whose first captures the
solve) is timed from the start of this file to the first timed call. With
--trace 0 the cell's traffic then runs for --seconds and the cell's
end-to-end metrics are printed; with --trace 1 the traffic runs under the
profiler instead (a short window on the per-iteration route, whose kernels
the profiler names right, then the cell's own route) and the cell's
per-layer metrics are printed, each read by benchmark/metrics/<name>.py.

Afterwards the answers the timed path returned are checked against the
plain reference (benchmark/reference/), and the last line on standard
output is one JSON object: correct, attempted, failed, metrics, device
and, with --trace 1, breakdown; the numbers compared and their limits come
last there and as the last lines on standard error. The run fails with no
result without a CUDA card (nothing falls back to the CPU) and when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import card, cell as cells, guard  # noqa: E402


@dataclass
class Context:
    """What a traffic driver gets: the cell's files, its seed and the device
    the program runs on (the reference checks on it too)."""

    cell: object
    config: dict
    traffic: dict
    seed: int
    device: torch.device

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, cell, device=None) -> int:
    """One run of `cell`. device=None looks for the cell's cards (and fails
    without them); a test passes the CPU to drive the rest of a run."""
    try:
        dev = device if device is not None else card.require(cell.chips)
    except card.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seed = args.seed % 2**63
    ctx = Context(cell, cell.config, cell.traffic, seed, dev)
    on_card = dev.type == "cuda"
    if on_card:
        ctx.log(f"card: {card.describe()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    driver = cells.module("drivers", cell.traffic["driver"])
    runner = driver.Runner(ctx, traced=bool(args.trace))
    setup_s = time.perf_counter() - T_START
    from tpustomp_torch.engine import graph
    graph.reset_counts()
    metrics, device_out, breakdown = {}, {}, None
    if args.trace:
        traced = runner.traced()
        for m in cell.per_layer:
            value = cells.module("metrics", m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        w = traced["window"]
        device_out = {"busy_s": w.busy_seconds(), "window_s": w.seconds}
        breakdown = {"device_ops": traced["per_iteration"].kernel_totals(),
                     "idle_gaps": w.idle_by_host()}
        graphs = traced["counts"]["graphs"]
    else:
        e2e = runner.window(args.seconds)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
        graphs = dict(graph.GRAPHS)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = runner.summary()
    # the timed path's route, for the reader: the chunk route, no capture
    # and no eager iteration inside the window
    ctx.log("guard: graphs in the window (captured regions, loop routes, "
            "eager:<reason> iterations) " + json.dumps(graphs, sort_keys=True))
    ctx.log("summary: " + json.dumps(summary, sort_keys=True))
    runner.release()
    numbers = runner.check("reference")
    limits = cell.config["checks"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    bad = guard.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device_out = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(dev) if on_card
                  else "cpu", "count": cell.chips,
                  "memory_peak_bytes": int(peak), **device_out}
    out = {"correct": bool(correct), "attempted": int(summary["attempted"]),
           "failed": int(summary["failed"]), "metrics": metrics,
           "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    return run(args, cells.load(args.workload))


if __name__ == "__main__":
    sys.exit(main())

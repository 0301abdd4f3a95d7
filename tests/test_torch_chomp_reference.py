"""The port's CHOMP (BASELINE config 3's planner) against the benchmark's
plain float64 CHOMP reference (benchmark/reference/chomp.py), and the
`chomp.grad` span.

At a small CPU shape (arm_7dof, B = 3, N = 20, jittered queries, the
configuration's planner with max_iterations cut to 6): θ after each of the
first iterations and the totals `plan_batch` records (record_metrics) are
the reference's within float32 rounding. Under `tracing.spans()` the eager
loop and the per-iteration route record one `chomp.grad` span an
iteration, the chunk route none, and every route's results are bitwise
those with spans off.

The reference is imported only after a fresh interpreter has shown that
importing it loads no JAX and no `tpustomp` (this file imports neither).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tracing import emulated  # noqa: F401  (a fixture)
from tpustomp_torch import ProblemSpec, plan_batch
from tpustomp_torch.api.config import from_dict
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import graph, solver
from tpustomp_torch.robot.model import arm_7dof
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import AnalyticWorld

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = {"jax", "jaxlib", "flax", "tpustomp", "tpustomp_torch"}


def _guarded_reference():
    """benchmark.reference.chomp, once a fresh interpreter has imported it
    and loaded none of the forbidden top-level modules."""
    code = ("import sys; import benchmark.reference.chomp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & _FORBIDDEN, loaded & _FORBIDDEN
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.reference import chomp
    return chomp


_CONFIG = json.loads((ROOT / "benchmark" / "configs"
                      / "chomp7_tabletop.json").read_text())
_N, _B, _ITERATIONS = 20, 3, 6
_SMALL = dict(_CONFIG, planner=dict(_CONFIG["planner"], num_timesteps=_N,
                                    max_iterations=_ITERATIONS))
# float32 against float64 at N = 20: θ differs by at most 7.3e-7 rad and a
# total by 1.4e-6 of itself over 4 seeds and 6 iterations; the bounds give
# about 7× room for float32 rounding of R, R⁻¹ and the FK chain, and are
# far below what one wrong term of the gradient moves (1e-3 and more)
_THETA_ATOL = 5e-6
_TOTAL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear_spans()
    yield
    tracing.clear_spans()
    torch.set_num_threads(n)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-0.03, 0.03, (2, _B, 7))
    q0 = (np.asarray(_CONFIG["q0"]) + jitter[0]).astype(np.float32)
    qN = (np.asarray(_CONFIG["qN"]) + jitter[1]).astype(np.float32)
    world = AnalyticWorld.make(boxes=[(tuple(c), tuple(h)) for c, h in
                                      _CONFIG["world"]["boxes"]])
    return arm_7dof(), world, q0, qN, from_dict(_SMALL["planner"])


@pytest.mark.parametrize("seed", [0, 1])
def test_chomp_iterates_and_totals_match_the_reference(seed):
    ref_mod = _guarded_reference()
    robot, world, q0, qN, cfg = _scene(seed)
    Q0, QN = torch.as_tensor(q0), torch.as_tensor(qN)
    QNw, state = solver._init_batch(robot, cfg, Q0, QN)
    ops = device_ops(_N, cfg.dt, cfg.smoothness, "cpu")
    step = solver.make_step(robot, world, cfg, ops, Q0, QNw, None)
    cpu = torch.device("cpu")
    for j in range(1, _ITERATIONS + 1):
        state = step(state, j - 1)
        ref = ref_mod.replay(_SMALL, q0, qN, j, "reference", cpu)
        np.testing.assert_allclose(state.theta.double().numpy(),
                                   ref["theta"], rtol=0, atol=_THETA_ATOL,
                                   err_msg=f"iteration {j}")
    sol = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                     device="cpu")
    ref = ref_mod.replay(_SMALL, q0, qN, _ITERATIONS, "reference", cpu)
    assert sol.iterations.tolist() == ref["ran"].tolist()
    np.testing.assert_allclose(sol.metrics.total_cost.double().numpy(),
                               ref["totals"], rtol=_TOTAL_RTOL)
    # the control (float32, TF32 matmul operands) is far off: the check's
    # other side
    ctrl = ref_mod.replay(_SMALL, q0, qN, _ITERATIONS, "control", cpu)
    gap = np.abs(ctrl["totals"] - ref["totals"]) / np.abs(ref["totals"])
    assert np.nanmax(gap) > 100 * _TOTAL_RTOL


def _solve(robot, world, q0, qN, cfg, route):
    prob = ProblemSpec(q0=q0, qN=qN)
    if route == "per_iteration":
        with graph.per_iteration():
            return plan_batch(robot, world, prob, cfg, device="cpu")
    return plan_batch(robot, world, prob, cfg, device="cpu")


def _assert_bitwise(a, b):
    for f in ("trajectory", "cost", "success", "iterations"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.metrics.total_cost, b.metrics.total_cost)


def test_chomp_grad_span_in_the_eager_loop():
    robot, world, q0, qN, cfg = _scene()
    off = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                     device="cpu")
    with tracing.spans():
        on = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                        device="cpu")
    spans = [s for s in tracing.recorded().spans if s.name == "chomp.grad"]
    assert len(spans) == int(on.iterations.max())      # one an iteration
    assert all(s.end_ns >= s.start_ns and s.device_ms is None for s in spans)
    _assert_bitwise(on, off)


@pytest.mark.parametrize("route", ["per_iteration", "chunk"])
def test_chomp_grad_span_on_the_graph_routes(emulated, route):  # noqa: F811
    """The per-iteration route replays the gradient as a region of its own
    under a `chomp.grad` span (a miss runs its first iteration eagerly,
    with no span; a hit spans every iteration); the chunk route keeps the
    whole iteration in its bodies and records none. Spans on or off, the
    results are bitwise the eager loop's."""
    robot, world, q0, qN, cfg = _scene()
    with graph.eager():
        ref = _solve(robot, world, q0, qN, cfg, "eager")
    for call in ("miss", "hit"):
        with tracing.spans():
            got = _solve(robot, world, q0, qN, cfg, route)
        spans = [s for s in tracing.recorded().spans
                 if s.name == "chomp.grad"]
        tracing.clear_spans()
        _assert_bitwise(got, ref)
        its = int(got.iterations.max())
        if route == "chunk":
            assert spans == []
        else:
            assert len(spans) == (its - 1 if call == "miss" else its)
            assert all(s.parent is not None for s in spans)    # in graph.loop
        _assert_bitwise(_solve(robot, world, q0, qN, cfg, route), ref)
    (g,) = graph._CACHE.values()
    assert ("grad" in g.info()["regions"]) == (route == "per_iteration")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (graphed CHOMP solves, CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chomp_routes_and_grad_span_on_the_card(cuda_device):
    """B = 256 of the configuration's planner at its own N = 100: the chunk
    route and the per-iteration route (the gradient as a region of its
    own) bitwise the eager loop; with spans on, one `chomp.grad` span an
    iteration of a cached per-iteration entry, each with device ms, and
    the results still bitwise."""
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(5)
    jitter = rng.uniform(-0.03, 0.03, (2, 256, 7))
    q0 = (np.asarray(_CONFIG["q0"]) + jitter[0]).astype(np.float32)
    qN = (np.asarray(_CONFIG["qN"]) + jitter[1]).astype(np.float32)
    robot = arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(boxes=[(tuple(c), tuple(h)) for c, h in
                                      _CONFIG["world"]["boxes"]]).to(
        cuda_device)
    cfg = from_dict(_CONFIG["planner"])
    prob = ProblemSpec(q0=q0, qN=qN)

    def solve(route):
        if route == "eager":
            with graph.eager():
                return plan_batch(robot, world, prob, cfg).to("cpu")
        if route == "per_iteration":
            with graph.per_iteration():
                return plan_batch(robot, world, prob, cfg).to("cpu")
        return plan_batch(robot, world, prob, cfg).to("cpu")

    ref = solve("eager")
    for route in ("chunk", "per_iteration"):
        for _ in range(2):                   # a miss, then a hit
            _assert_bitwise(solve(route), ref)
    with tracing.spans():
        got = solve("per_iteration")
        torch.cuda.synchronize()
    spans = [s for s in tracing.recorded().spans if s.name == "chomp.grad"]
    _assert_bitwise(got, ref)
    assert len(spans) == int(ref.iterations.max())
    assert all(s.device_ms is not None and s.device_ms > 0 for s in spans)

"""The plain reference at a tiny size: against itself, against the port's
plain CPU costs, and on answers altered by hand."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.lib.cell import BENCH, ROOT
from benchmark.reference import stomp, verify
from benchmark.reference.kinematics import Chain
from benchmark.reference.precision import Precision, tf32

CFG = json.loads((BENCH / "configs" / "stomp7_tabletop.json").read_text())
MPC = json.loads((BENCH / "configs" / "stomp7_mpc.json").read_text())
CPU = torch.device("cpu")


def trajectories(M=6, T=22, seed=0):
    """Min-jerk paths between jittered config-2 endpoints plus a wiggle;
    the even rows lift the arm over the bottle (joint 1 up mid-path)."""
    rng = np.random.default_rng(seed)
    q0 = np.asarray(CFG["q0"]) + rng.uniform(-0.03, 0.03, (M, 7))
    qN = np.asarray(CFG["qN"]) + rng.uniform(-0.03, 0.03, (M, 7))
    u = np.linspace(0, 1, T)[None, :, None]
    s = 10 * u**3 - 15 * u**4 + 6 * u**5
    wig = 0.05 * np.sin(7 * u) * rng.normal(size=(M, 1, 7))
    wig[::2, :, 1] -= 0.8 * np.sin(np.pi * u[0, :, 0])
    wig[:, [0, -1]] = 0
    return (q0[:, None] + s * (qN - q0)[:, None] + wig).astype(np.float32)


def planner(T):
    return dict(CFG["planner"], num_timesteps=T - 2)


def test_reference_against_itself():
    traj = trajectories()
    cfg = dict(CFG, planner=planner(traj.shape[1]))
    c64, m64 = verify.plan_costs(cfg, traj, "reference", CPU)
    # blocks of rows give the same numbers
    cb, mb = verify.plan_costs(cfg, traj, "reference", CPU, block=4)
    np.testing.assert_array_equal(cb, c64)
    np.testing.assert_array_equal(mb, m64)
    assert (m64 < 0).any() and (m64 > 0).any()     # both kinds of rows
    # the control's TF32 operands move the costs far beyond float32's
    # rounding
    ctrl, _ = verify.plan_costs(cfg, traj, "control", CPU)
    assert (np.abs(ctrl - c64) / c64).max() > 1e-3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-12, -3.0 - 2**-9,
                      408.0408])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, -3.0 - 2**-9, 408.0]


def test_reference_agrees_with_the_ports_plain_costs():
    """At a tiny size on the CPU, the port's own evaluation of a trajectory
    (solver._evaluate: the plain evaluator and the smoothness rows) and the
    reference's cost and margin agree to float32 rounding."""
    from tpustomp_torch.api.config import from_dict
    from tpustomp_torch.dynamics.device import device_ops
    from tpustomp_torch.engine import solver
    from tpustomp_torch.robot.model import arm_7dof
    from tpustomp_torch.world.sdf import AnalyticWorld

    traj = trajectories()
    T = traj.shape[1]
    cfg = from_dict(planner(T))
    world = AnalyticWorld.make(boxes=[tuple(map(tuple, b))
                                      for b in CFG["world"]["boxes"]])
    t = torch.as_tensor(traj)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, CPU)
    _, total, margin, _ = solver._evaluate(arm_7dof(), world, (), cfg, ops,
                                           t[:, 0], t[:, -1], t[:, 1:-1])
    ref_c, ref_m = verify.plan_costs(dict(CFG, planner=planner(T)), traj,
                                     "reference", CPU)
    np.testing.assert_allclose(total.numpy(), ref_c, rtol=2e-5)
    np.testing.assert_allclose(margin.numpy(), ref_m, atol=2e-6)


def answers(traj):
    cfg = dict(CFG, planner=planner(traj.shape[1]))
    c, m = verify.plan_costs(cfg, traj, "reference", CPU)
    return cfg, dict(trajectory=traj, cost=c.astype(np.float32),
                     success=m > 0, iterations=np.full(len(traj), 3),
                     q0=traj[:, 0].copy(), qN=traj[:, -1].copy())


def test_plan_check_passes_true_answers_and_catches_false_ones():
    cfg, ans = answers(trajectories())
    ok = verify.check_plans(cfg, ans, CPU)
    assert ok["false_claims"] == 0 and ok["cost_gap"] < 1e-6
    moved = dict(ans, trajectory=ans["trajectory"] + np.float32(1e-3))
    assert verify.check_plans(cfg, moved, CPU)["false_claims"] == len(
        ans["cost"])                                        # endpoints off
    liar = dict(ans, success=np.ones_like(ans["success"]))
    assert verify.check_plans(cfg, liar, CPU)["false_claims"] == int(
        (~ans["success"]).sum()) > 0                   # collision called free
    dear = dict(ans, cost=ans["cost"] * np.float32(1.01))
    assert verify.check_plans(cfg, dear, CPU)["cost_gap"] == pytest.approx(
        0.01, rel=1e-3)
    late = dict(ans, iterations=ans["iterations"] + 100)
    assert verify.check_plans(cfg, late, CPU)["false_claims"] == len(
        ans["cost"])


def inputs(B=6, seed=2, N=20):
    """An MPC configuration with N waypoints and B scenarios' inputs, as
    the fleet cells draw them."""
    from benchmark.drivers.mpc import Scenarios

    cfg = json.loads(json.dumps(MPC))
    cfg["planner"]["num_timesteps"] = N
    traffic = json.loads((BENCH / "traffic" / "fleet10k.json").read_text())
    inp = Scenarios(seed, 0, cfg, dict(traffic, scenarios=B)).next()
    gen = torch.Generator(CPU).manual_seed(seed)
    shape = (7, B, cfg["planner"]["num_rollouts"], N)
    return cfg, inp, gen, shape


def test_first_tick_replay_agrees_with_the_ports_cpu_tick():
    """The float64 replay of an episode's first tick and the port's own
    tick on the CPU (its plain evaluator), from the same inputs and
    generator, agree to float32 rounding; the control's TF32 operands move
    the plans far beyond it."""
    from tpustomp_torch.api.config import from_dict
    from tpustomp_torch.engine.mpc import init_mpc, run_mpc_batch
    from tpustomp_torch.robot.model import arm_7dof
    from tpustomp_torch.world.sdf import AnalyticWorld

    cfg, inp, gen, shape = inputs()
    start = gen.get_state()
    planner, m = from_dict(cfg["planner"]), cfg["mpc"]
    world = AnalyticWorld.make(boxes=[tuple(map(tuple, b))
                                      for b in cfg["world"]["boxes"]])
    state = init_mpc(arm_7dof(), planner, inp["q0"], inp["qN"], inp["c0"],
                     inp["v"])
    got = run_mpc_batch(arm_7dof(), planner, state, [m["sphere_radius"]], 1,
                        m["world_dt"], static_world=world,
                        goal_eps=m["goal_eps"], goal_flush=m["goal_flush"],
                        device="cpu", generator=gen)
    rows = np.arange(shape[1])
    gaps = {}
    for prec in ("reference", "control"):
        ref = stomp.Tick(cfg, prec, CPU).run(
            inp["q0"], inp["qN"], inp["c0"], inp["v"],
            stomp.draws_from(start, shape, rows, CPU))
        gaps[prec] = np.abs(got.theta.double().numpy() - ref["theta"]).max(
            axis=(1, 2))
        if prec == "reference":
            np.testing.assert_allclose(got.q.numpy(), ref["q"], atol=1e-6)
            np.testing.assert_allclose(got.sphere_center.numpy(),
                                       ref["sphere_center"], atol=1e-6)
            assert (got.collided.numpy() == ref["collided"]).all()
            assert (got.reached_tick.numpy() == ref["reached"]).all()
    assert np.median(gaps["reference"]) < 1e-5
    assert np.median(gaps["control"]) > 1e-4


def episode(ticks=100, B=4, seed=2):
    """A made-up episode that says only true things: its first tick as the
    float64 replay gives it, its final state at rest."""
    cfg, inp, gen, shape = inputs(B, seed)
    rows = np.arange(B)
    first = stomp.Tick(cfg, "reference", CPU).run(
        inp["q0"], inp["qN"], inp["c0"], inp["v"],
        stomp.draws_from(gen.get_state(), shape, rows, CPU))
    first = dict(first, steps=np.ones(B, int), rows=rows,
                 generator=gen.get_state(), shape=shape)
    rng = np.random.default_rng(seed)
    q = np.asarray(MPC["qN"]) + rng.uniform(-0.2, 0.2, (B, 7))
    q = np.where(np.asarray(MPC["robot"]["geometry"]["joint_limited"]), q,
                 inp["qN"])
    qN = verify.wrap_goal(inp["q0"].astype(np.float64),
                          inp["qN"].astype(np.float64),
                          MPC["robot"]["geometry"]["joint_limited"])
    return cfg, dict(inp, ticks=ticks, first=first, q=q, qN_final=qN,
                     theta=np.tile(q[:, None], (1, 5, 1)),
                     sphere_center=inp["c0"] + np.float32(ticks * 0.1)
                     * inp["v"], steps=np.full(B, ticks),
                     collided=np.zeros(B, bool), reached=np.full(B, -1))


def test_episode_check_passes_true_states_and_catches_false_ones():
    cfg, ep = episode()
    ok = verify.check_episodes(cfg, [ep], CPU)
    assert ok == {"plan_gap": pytest.approx(0, abs=1e-9),
                  "sphere_gap": pytest.approx(0, abs=1e-6),
                  "false_claims": 0, "collision_rate": 0.0,
                  "unreached_share": 1.0}
    stuck = dict(ep, sphere_center=ep["c0"], steps=np.zeros(4, int))
    bad = verify.check_episodes(cfg, [stuck], CPU)
    assert bad["false_claims"] == 4 and bad["sphere_gap"] > 0.05
    at_goal = dict(ep, q=ep["qN_final"])
    assert verify.check_episodes(cfg, [at_goal], CPU)["false_claims"] == 4
    late = dict(ep, reached=np.full(4, 101))
    assert verify.check_episodes(cfg, [late], CPU)["false_claims"] == 4
    hit = dict(ep, collided=np.ones(4, bool))
    assert verify.check_episodes(cfg, [hit], CPU)["collision_rate"] == 1.0
    home = dict(ep, reached=np.full(4, 2), q=ep["qN_final"])
    assert verify.check_episodes(cfg, [home], CPU)["unreached_share"] == 0.0
    # a short episode (a traced run's) does not count toward the share
    _, short = episode(ticks=3)
    assert verify.check_episodes(cfg, [home, short], CPU)[
        "unreached_share"] == 0.0
    # the first tick: a plan moved, an arm that did not step
    moved = dict(ep, first=dict(ep["first"],
                                theta=ep["first"]["theta"] + 1e-3))
    assert verify.check_episodes(cfg, [moved], CPU)["plan_gap"] == (
        pytest.approx(1e-3))
    still = dict(ep, first=dict(ep["first"], q=ep["q0"],
                                steps=np.zeros(4, int)))
    assert verify.check_episodes(cfg, [still], CPU)["false_claims"] == 4
    # the control's first ticks, judged in the program's place
    ctrl = verify.control_first_ticks(cfg, [ep], CPU)
    assert verify.check_episodes(cfg, [ep], CPU, ctrl)["plan_gap"] > 1e-5


def test_chain_bodies_ride_their_links():
    chain = Chain(CFG["robot"]["geometry"], Precision("reference"), CPU)
    x = chain.bodies(torch.zeros(7, dtype=torch.float64))
    # at q = 0 the arm points along +x from the shoulder at (0.1, 0, 0.8)
    np.testing.assert_allclose(x[:, 1:].numpy(), [[0, 0.8]] * 12, atol=1e-7)
    np.testing.assert_allclose(x[3, 0].item(), 0.5, atol=1e-7)
    np.testing.assert_allclose(x[11, 0].item(), 0.1 + 0.4 + 0.32 + 0.16,
                               atol=1e-7)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (BENCH / "reference").glob("*.py")) + sorted((BENCH / "lib").glob(
        "*.py")), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_the_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"tpustomp_torch", "tpustomp", "jax", "jaxlib",
                       "flax"}, tops


def test_the_reference_loads_no_module_of_the_program():
    code = ("import sys; import benchmark.reference.verify; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"tpustomp_torch", "tpustomp", "jax", "jaxlib", "flax"}

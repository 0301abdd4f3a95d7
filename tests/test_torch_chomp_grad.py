"""CHOMP's functional gradient kernel (kernels/chomp_grad.py,
csrc/chomp_grad.cu).

On the CPU: engine/chomp.py chomp_gradient against what it computed
before the kernel (w_o · obstacle_functional_gradient + w_s ·
smoothness_gradient, written out below as the specification), bitwise,
over curvature and pseudo-inverse on and off and the three world kinds,
launching nothing, and a CHOMP plan_batch too; the exact mode keeps its
autograd path; the wrapper's argument checks (on the "meta" device, which
stands in for the card), CPU tensors among the refusals; the nvcc
definitions a world's library is built with; the launch counter in
engine/graph.py's counters and rollout.reset_launches().

On the card (``cuda`` marker; skips without one): the kernel against the
plain route at B 1, 3 and 1,024, N 20 and 100, on arm_7dof and a chain
with a prismatic joint and fixed rotations, over analytic spheres and
boxes, a dense grid, a packed grid and a composite, curvature and
pseudo-inverse each on and off, from config 3's queries jittered ± 0.03
rad (a perturbed path, and θ from the middle of a solve): within 1e-4 of
each row's largest |∇U| wherever the float32 plain route is within 1e-5
of the float64 one, and elsewhere (a slow body's curvature term, a
rank-deficient J Jᵀ) within 1e-4 of the float64 route, or within twice
the float32 plain route's distance to it, over them all and at each
waypoint (there against four times the largest of nine float32
readings, the inputs moved by an ulp); the plain route's ties counted
and printed, as the waypoints where float32 is off and the one nearest
its limit; a chain with a rank-deficient Jacobian; replays of a captured graph bitwise an eager
launch; one launch an iteration on the eager, per-iteration and chunk
routes (and one a gradient of HMC's leapfrog); the float64 CHOMP
reference (tests/test_torch_chomp_reference.py) through the kernel at
that test's bounds.

Imports no JAX:

    python -m pytest tests/test_torch_chomp_grad.py -m cuda --noconftest
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tpustomp_torch import PlannerConfig, ProblemSpec, plan_batch
from tpustomp_torch.api.config import from_dict
from tpustomp_torch.costs.smoothness import smoothness_gradient
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import chomp as tchomp
from tpustomp_torch.engine import graph, solver
from tpustomp_torch.engine.trajectory import full_trajectory
from tpustomp_torch.kernels import chomp_grad as cg
from tpustomp_torch.kernels import rollout
from tpustomp_torch.robot import fk as tfk
from tpustomp_torch.robot import model
from tpustomp_torch.world.sdf import (AnalyticWorld, CompositeWorld, GridSDF,
                                      sdf)

_Q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
_QN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
          ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]
_SPHERE = ((0.35, 0.3, 0.55), 0.12)
_CLEARANCE, _W_OBS, _W_SMOOTH, _RIDGE = 0.05, 20.0, 0.1, 1e-4
_WORLDS = ("analytic", "dense", "packed", "composite")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]


def _prismatic_arm(rank_deficient=False):
    """A 4-joint chain with a prismatic (telescoping) third joint, fixed
    rotations and a rotated base: every body on the third joint or later,
    so each point Jacobian has three or more columns (J Jᵀ of full rank);
    `rank_deficient` adds a body on the first joint, whose one column
    leaves J Jᵀ + ridge·I a condition number near 1e4."""
    link = [2, 2, 3, 3] + ([0] if rank_deficient else [])
    return model._spec(
        joint_axis=[[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0.6, 0.8]],
        joint_offset=[[0, 0, 0.5], [0.1, 0, 0.1], [0.3, 0, 0],
                      [0.25, 0, 0]],
        joint_rot=np.stack([_rz(0.2), _rz(-0.3), np.eye(3), _rz(0.5)]),
        lower=[-3, -1.5, 0.0, -3], upper=[3, 1.5, 0.4, 3],
        limited=[True] * 4, joint_type=[0, 0, 1, 0], body_link=link,
        body_offset=[[0.1, 0, 0], [0.25, 0, 0], [0.05, 0.02, 0],
                     [0.15, 0, 0.03], [0.2, 0, 0.03]][:len(link)],
        body_radius=[0.06, 0.06, 0.05, 0.05, 0.07][:len(link)],
        base_pos=[0.1, -0.1, 0.0], base_rot=_rz(0.4))


def _world(kind):
    """The tabletop's two boxes (with a sphere, analytic), or a grid of
    their exact SDF at 4 cm (dense or packed), or that grid with the
    sphere as a composite's overlay; CPU tensors."""
    boxes = AnalyticWorld.make(boxes=_BOXES)
    if kind == "analytic":
        return AnalyticWorld.make(spheres=[_SPHERE], boxes=_BOXES)
    origin = np.array([-0.3, -1.0, -0.1], np.float32)
    axes = [origin[i] + 0.04 * np.arange(n) for i, n in
            enumerate((45, 50, 36))]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(np.float32)
    g = sdf(boxes, torch.from_numpy(pts)).numpy()
    grid = GridSDF.make(g, origin, 0.04, pack=kind != "dense")
    if kind == "composite":
        return CompositeWorld.make(grid, spheres=[_SPHERE])
    return grid


def _queries(robot, B, N, seed):
    """(theta [B, N, d], q0, qN): config 3's start and goal ± 0.03 rad
    joined by a perturbed path lifted over the table (arm_7dof), or a
    perturbed path between random ends (other robots)."""
    rng = np.random.default_rng(seed)
    d = robot.num_joints
    if d == 7:
        q0 = _Q0 + rng.uniform(-0.03, 0.03, (B, d))
        qN = _QN + rng.uniform(-0.03, 0.03, (B, d))
    else:
        q0 = rng.uniform(-0.4, 0.4, (B, d)) + [0, 0, 0.2, 0]
        qN = rng.uniform(-0.4, 0.4, (B, d)) + [0, 0, 0.2, 0]
    u = np.linspace(0, 1, N + 2)[1:-1, None]
    s = 10 * u ** 3 - 15 * u ** 4 + 6 * u ** 5
    theta = q0[:, None] + s * (qN - q0)[:, None]
    theta = theta + rng.normal(0, 0.1, (B, N, d))
    if d == 7:
        theta[..., 1] += 0.35 * np.sin(np.pi * u[:, 0])
    return tuple(torch.as_tensor(np.asarray(a, np.float32))
                 for a in (theta, q0, qN))


def _args(robot, world, theta, q0, qN, curvature, pinv):
    N = theta.shape[1]
    cfg = PlannerConfig(num_timesteps=N)
    ops = device_ops(N, cfg.dt, cfg.smoothness, theta.device)
    smooth = smoothness_gradient(ops, theta, q0, qN)
    return (robot, world, theta, q0, qN, smooth, cfg.dt, _CLEARANCE,
            _W_OBS, _W_SMOOTH, curvature, pinv, _RIDGE)


def _former(robot, world, theta, q0, qN, smooth, dt, clearance, w_o, w_s,
            curvature, pinv, ridge):
    """engine/chomp.py chomp_gradient's functional mode before the kernel."""
    g_obs = tchomp.obstacle_functional_gradient(
        robot, world, full_trajectory(theta, q0, qN), dt, clearance,
        curvature, pinv, ridge)
    return w_o * g_obs + w_s * smooth


# --- the CPU ---------------------------------------------------------------


def _refuse(*a, **k):
    raise AssertionError("the kernel wrapper was called")


@pytest.mark.parametrize("world", _WORLDS)
@pytest.mark.parametrize("curvature", [True, False])
@pytest.mark.parametrize("pinv", [True, False])
def test_plain_route_is_the_former_gradient(monkeypatch, world, curvature,
                                            pinv):
    """chomp_gradient on CPU tensors is bitwise its former functional mode
    and never reaches the kernel wrapper."""
    theta, q0, qN = _queries(model.arm_7dof(), 3, 20, 0)
    args = _args(model.arm_7dof(), _world(world), theta, q0, qN, curvature,
                 pinv)
    want = _former(*args)
    before = dict(cg.LAUNCHES)
    monkeypatch.setattr(cg, "functional_gradient", _refuse)
    robot, w, th, a, c, _, dt, clr, w_o, w_s, curv, pi, ridge = args
    ops = device_ops(th.shape[1], dt, PlannerConfig().smoothness, "cpu")
    g = tchomp.chomp_gradient(ops, robot, w, th, a, c, dt, clr, w_o, w_s,
                              curv, pi, ridge)
    assert torch.equal(g, want)
    assert cg.LAUNCHES == before


def _former_chomp_gradient(ops, robot, world, theta, q0, qN, dt, clearance,
                           w_obstacle, w_smoothness, use_curvature=True,
                           use_pseudo_inverse=False, pinv_ridge=1e-4,
                           gradient_mode="functional", constraints=None,
                           w_constraint=0.0, w_torque=0.0):
    """engine/chomp.py chomp_gradient before the kernel, for a functional
    gradient without constraints or torque."""
    assert gradient_mode == "functional" and w_torque == 0.0
    assert not constraints or w_constraint == 0.0
    return _former(robot, world, theta, q0, qN,
                   smoothness_gradient(ops, theta, q0, qN), dt, clearance,
                   w_obstacle, w_smoothness, use_curvature,
                   use_pseudo_inverse, pinv_ridge)


def test_cpu_plan_batch_is_the_former_gradients(monkeypatch):
    """A CHOMP plan_batch on the CPU never reaches the kernel wrapper,
    launches nothing and is bitwise the plan with the former
    chomp_gradient in the solver."""
    robot, world = model.arm_7dof(), AnalyticWorld.make(boxes=_BOXES)
    rng = np.random.default_rng(1)
    q0 = (_Q0 + rng.uniform(-0.03, 0.03, (2, 7))).astype(np.float32)
    qN = (_QN + rng.uniform(-0.03, 0.03, (2, 7))).astype(np.float32)
    cfg = PlannerConfig(mode="chomp", num_timesteps=20, max_iterations=4,
                        use_pseudo_inverse=True, learning_rate=0.6)
    rollout.reset_launches()
    monkeypatch.setattr(cg, "functional_gradient", _refuse)
    got = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                     device="cpu")
    assert cg.LAUNCHES == {"chomp_grad": 0, "chomp_grad:runtime": 0}
    monkeypatch.setattr(solver, "chomp_gradient", _former_chomp_gradient)
    want = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg,
                      device="cpu")
    for f in ("trajectory", "cost", "success", "iterations"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_exact_mode_keeps_autograd(monkeypatch):
    monkeypatch.setattr(cg, "functional_gradient", _refuse)
    robot, world = model.arm_7dof(), AnalyticWorld.make(boxes=_BOXES)
    theta, q0, qN = _queries(robot, 2, 20, 2)
    cfg = PlannerConfig(num_timesteps=20)
    ops = device_ops(20, cfg.dt, cfg.smoothness, "cpu")
    g = tchomp.chomp_gradient(ops, robot, world, theta, q0, qN, cfg.dt,
                              _CLEARANCE, _W_OBS, _W_SMOOTH,
                              gradient_mode="exact")
    want = (_W_OBS * tchomp.exact_obstacle_gradient(
        robot, world, theta, q0, qN, cfg.dt, _CLEARANCE)
        + _W_SMOOTH * smoothness_gradient(ops, theta, q0, qN))
    assert torch.equal(g, want)


def _meta(robot, world, B=3, N=5):
    """Valid arguments on the "meta" device: the wrapper's checks run, as
    for CUDA tensors, before anything is built or launched."""
    dev = torch.device("meta")
    d = robot.num_joints
    theta = torch.empty(B, N, d, device=dev)
    q = torch.empty(B, d, device=dev)
    return dict(robot=robot.to(dev), world=world.to(dev), theta=theta,
                q0=q, qN=q.clone(), smooth=torch.empty(B, N, d, device=dev))


def _bad(name):
    robot = model.arm_7dof()
    a = _meta(robot, AnalyticWorld.make(boxes=_BOXES))
    meta = torch.device("meta")
    if name == "device":
        a["q0"] = torch.zeros(3, 7)
    elif name == "robot_device":
        a["robot"] = robot
    elif name == "world_device":
        a["world"] = AnalyticWorld.make(boxes=_BOXES)
    elif name == "dtype":
        a["smooth"] = a["smooth"].double()
    elif name == "theta_rank":
        a["theta"] = a["theta"][0]
    elif name == "q_shape":
        a["qN"] = torch.empty(3, 6, device=meta)
    elif name == "smooth_shape":
        a["smooth"] = torch.empty(3, 4, 7, device=meta)
    elif name == "joints":
        a["robot"] = model.planar_2r().to(meta)
    elif name == "row_world":
        a["world"] = AnalyticWorld(
            sphere_center=torch.zeros(3, 1, 3), sphere_radius=torch.ones(3, 1),
            box_center=torch.zeros(3, 0, 3),
            box_half=torch.zeros(3, 0, 3)).to(meta)
    elif name == "world_kind":
        a["world"] = object()
    elif name == "cpu":
        theta, q0, qN = _queries(robot, 3, 5, 0)
        a = dict(robot=robot, world=AnalyticWorld.make(boxes=_BOXES),
                 theta=theta, q0=q0, qN=qN, smooth=torch.zeros_like(theta))
    elif name == "runtime_joints":
        arm = model.arm_7dof()
        d = 33
        big = dataclasses.replace(
            arm, joint_static=None,
            joint_type=torch.zeros(d, dtype=torch.int32),
            joint_axis=torch.zeros(d, 3))
        a["robot"] = big
        a["theta"] = torch.empty(3, 5, d, device=meta)
    return a


_REFUSALS = {"cpu": (ValueError, "CUDA tensors"),
             "device": (ValueError, "on cpu"),
             "robot_device": (ValueError, "robot tensors"),
             "world_device": (ValueError, "world tensors"),
             "dtype": (TypeError, "float32"),
             "theta_rank": (ValueError, r"\[B, N, d\]"),
             "q_shape": (ValueError, "qN must be"),
             "smooth_shape": (ValueError, "smooth must be"),
             "joints": (ValueError, "joints"),
             "row_world": (NotImplementedError, "row axis"),
             "world_kind": (NotImplementedError, "AnalyticWorld"),
             "runtime_joints": (ValueError, "runtime chain")}


@pytest.mark.parametrize("bad", sorted(_REFUSALS))
def test_checks_refuse(bad):
    err, match = _REFUSALS[bad]
    a = _bad(bad)
    args = (a["robot"], a["world"], a["theta"], a["q0"], a["qN"],
            a["smooth"], 0.05, _CLEARANCE, _W_OBS, _W_SMOOTH)
    with pytest.raises(err, match=match):
        cg.functional_gradient(*args)


@pytest.mark.parametrize("world", ["analytic", "packed", "composite"])
def test_checks_take_good_arguments(world):
    a = _meta(model.arm_7dof(), _world(world))
    kind = cg._checked(a["robot"], a["world"], a["theta"], a["q0"],
                       a["qN"], a["smooth"])
    assert kind == {"analytic": 0, "packed": 1, "composite": 2}[world]


@pytest.mark.parametrize("world, want", [
    ("analytic", (0, 1, 2)), ("dense", (1, 0, 0)), ("packed", (1, 0, 0)),
    ("composite", (1, 1, 0)), ("many_spheres", (0, -1, -1)),
    ("boxed_overlay", (1, -1, -1)), ("empty", (0, 0, 0))])
def test_a_library_holds_one_world_kind_and_its_counts(world, want):
    """The nvcc definitions of a world's library: its kind, and its sphere
    and box counts where they fit the kernel's budget (16 floats of
    analytic primitives, 4 of a grid's overlay; 4 a sphere, 6 a box),
    else -1; each set of definitions is a library of its own, built after
    the chain's."""
    worlds = {
        "many_spheres": AnalyticWorld.make(spheres=[_SPHERE] * 5),
        "boxed_overlay": CompositeWorld.make(_world("dense"),
                                             boxes=_BOXES[:1]),
        "empty": AnalyticWorld.make()}
    w = worlds[world] if world in worlds else _world(world)
    got = cg._definitions(w)
    assert got == tuple(f"-DCHOMP_GRAD_{k}={v}"
                        for k, v in zip(("GRID", "NS", "NX"), want))
    chain = rollout.chain_of(model.arm_7dof())
    assert rollout._nvcc_flags(chain, got)[-3:] == got
    assert rollout._nvcc_flags(chain, got)[:-3] == rollout._nvcc_flags(chain)
    other = cg._definitions(_world("analytic" if world != "analytic"
                                   else "dense"))
    assert (rollout._lib_path("chomp_grad", chain, got)
            != rollout._lib_path("chomp_grad", chain, other))


def test_counter_moves_with_graphs_and_resets():
    assert any(c is cg.LAUNCHES for c in graph._COUNTERS)
    cg.LAUNCHES["chomp_grad"] += 3
    cg.LAUNCHES["chomp_grad:runtime"] += 1
    rollout.reset_launches()
    assert cg.LAUNCHES == {"chomp_grad": 0, "chomp_grad:runtime": 0}


def test_constants_are_torch_scalar_roundings():
    """The kernel's constants are the float32 values torch rounds the
    plain version's Python scalars to; a clearance of 0 makes the
    potential's denominators 1 (costs/obstacle.py)."""
    got = cg._constants(5.0 / 101, 0.05, 1e-4, 20.0, 0.1)
    want = [np.float32(v) for v in (5.0 / 101, 10.0 / 101, 0.05, 0.025, 0.05,
                                    0.1, 1e-4, 20.0, 0.1)]
    assert [np.float32(g) for g in got] == want
    assert cg._constants(0.1, 0.0, 1e-4, 1.0, 1.0)[4:6] == (1.0, 1.0)


# --- the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    """The card, with the libraries of the robots' chains built at once,
    and the test worlds on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the chomp_grad kernel)")
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    robots = {"arm_7dof": model.arm_7dof(), "prismatic": _prismatic_arm()}
    chains = tuple(rollout.chain_of(r) for r in robots.values())
    defs = {cg._definitions(_world(k)) for k in _WORLDS}
    with ThreadPoolExecutor(len(defs)) as pool:
        for job in [pool.submit(rollout.build, ("chomp_grad",), chains, d)
                    for d in defs]:
            job.result()
    worlds = {k: _world(k).to(dev) for k in _WORLDS}
    return dev, {k: r.to(dev) for k, r in robots.items()}, worlds


def _ties(robot, world, full):
    """[B, T] True where the plain route's SDF gradient is within 1e-6 of
    a switch at some body: two primitives (or the grid and the overlay)
    equally near, two faces of the nearest box equally deep from inside,
    d_sig at 0 or the clearance, or (grids) a sample within 1e-5 of a
    cell face, where the trilinear gradient jumps."""
    x, _ = tfk.body_pos_jac_traj(robot, full)              # [B, T, nb, 3]
    tol = 1e-6
    tie = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    prims = world.overlay if isinstance(world, CompositeWorld) else world
    grid = world.grid if isinstance(world, CompositeWorld) else (
        world if isinstance(world, GridSDF) else None)
    dists = []
    if isinstance(prims, AnalyticWorld):
        rel = x[..., None, :] - prims.sphere_center
        dists.append(rel.norm(dim=-1) - prims.sphere_radius)
        if prims.box_half.shape[0]:
            q = (x[..., None, :] - prims.box_center).abs() - prims.box_half
            out = q.clamp(min=0).norm(dim=-1)
            db = out + q.amax(dim=-1).clamp(max=0)
            dists.append(db)
            # two faces of the nearest box equally deep, from inside
            top2 = q.topk(2, dim=-1).values
            inside_tie = (out == 0) & (top2[..., 0] - top2[..., 1] < tol)
            nearest = db == db.amin(dim=-1, keepdim=True)
            tie |= (inside_tie & nearest).any(dim=-1)
    if grid is not None:
        g = (x - grid.origin) / grid.resolution
        tie |= ((g - g.round()).abs() < 1e-5).any(dim=-1)
        dists.append(sdf(grid, x)[..., None])
    d_all = torch.cat(dists, dim=-1)
    if d_all.shape[-1] > 1:
        top2 = d_all.topk(2, dim=-1, largest=False).values
        tie |= top2[..., 1] - top2[..., 0] < tol
    d_sig = d_all.amin(dim=-1) - robot.body_radius - _CLEARANCE
    tie |= ((d_sig.abs() < tol) | ((d_sig - _CLEARANCE).abs() < tol))
    return tie.any(dim=-1)


def _compare(args, label):
    """The kernel against the plain route on the card, both beside the plain
    route in float64. At each waypoint where the float32 plain route is
    within 1e-5 of its row's largest |∇U| of the float64 one, there and
    at the two waypoints on either side, the kernel is within 1e-4 of
    that scale of the float32 plain route. Where float32 itself is
    farther off (the curvature term divides second differences of body
    positions by speed² + 1e-6, which at a slow body magnifies every
    rounding of its position; a rank-deficient J Jᵀ + ridge·I magnifies
    it 1e4-fold), the kernel is held to the float64 route instead: its
    largest error there within 1e-4, or within twice the float32 plain
    route's largest error there where that is larger; and at each such
    waypoint within 1e-4, or within four times the largest error of
    nine float32 readings (:func:`_float32_errors`) at that waypoint and
    its two neighbours on either side. Four, not two: one float32 reading
    of an ill-conditioned waypoint is itself more than twice the largest
    of eight others at some waypoints of a batch, which the test prints
    (the plain route's own ratio). Waypoints at a tie (:func:`_ties`) only
    need finite values. Both kinds are counted and printed, and the
    waypoint nearest its limit."""
    before = sum(cg.LAUNCHES.values())
    got = cg.functional_gradient(*args)
    want = _former(*args)
    exact = _former(*_double(args))
    torch.cuda.synchronize()
    assert sum(cg.LAUNCHES.values()) == before + 1
    assert bool(torch.isfinite(got).all())
    robot, world, theta, q0, qN = args[:5]
    tie = _ties(robot, world, full_trajectory(theta, q0, qN))[:, 1:-1]
    scale = exact.abs().amax(dim=(1, 2), keepdim=True)

    def err(a, b):                                   # [B, N]
        return ((a.double() - b.double()).abs() / scale).amax(dim=-1)

    e_plain, e_kernel = err(want, exact), err(got, exact)
    # float32's error at a waypoint and its neighbours: what it is there
    # is partly luck, how large it gets nearby is the conditioning
    near = torch.nn.functional.max_pool1d(e_plain[:, None], 5, 1, 2)[:, 0]
    off = (near > 1e-5) & ~tie
    good = ~off & ~tie
    worst = float(err(got, want)[good].max()) if good.any() else 0.0
    k_off = float(e_kernel[off].max()) if off.any() else 0.0
    p_off = float(e_plain[off].max()) if off.any() else 0.0
    # each waypoint where float32 is off, against its own limit: four times
    # the largest of nine float32 readings nearby; and, printed, the first
    # reading against twice the largest of the other eight
    others = (_float32_errors(args, scale) if off.any()
              else torch.zeros_like(e_plain))

    def pooled(e):
        return torch.nn.functional.max_pool1d(e[:, None], 5, 1, 2)[:, 0]

    near_k = pooled(torch.maximum(e_plain, others))
    def against(e, near_e, factor):
        return torch.where(off, e / (factor * near_e).clamp(min=1e-4), 0.0)

    ratio = against(e_kernel, near_k, 4.0)
    twice = float(against(e_kernel, near_k, 2.0).max())
    null = float(against(e_plain, pooled(others), 2.0).max())
    b, n = divmod(int(ratio.argmax()), ratio.shape[1])
    print(f"[chomp_grad:{label}] max rel {worst:.3e}, ties {int(tie.sum())}"
          f" of {tie.numel()} waypoints; float32 off by > 1e-5 at "
          f"{int(off.sum())}: kernel {k_off:.3e}, plain {p_off:.3e} from "
          f"float64; nearest its limit ({b}, {n}): kernel "
          f"{float(e_kernel[b, n]):.3e}, plain {float(e_plain[b, n]):.3e}, "
          f"near {float(near[b, n]):.3e}, nine readings' near "
          f"{float(near_k[b, n]):.3e}, {float(ratio[b, n]):.3f} of the limit;"
          f" at twice that near the kernel reads {twice:.3f}, the plain "
          f"route's first reading against the other eight {null:.3f}")
    assert int(tie.sum()) <= 0.01 * tie.numel() + 2, int(tie.sum())
    assert worst <= 1e-4, (label, worst)
    assert k_off <= max(1e-4, 2.0 * p_off), (label, k_off, p_off)
    assert float(ratio.max()) <= 1.0, (label, b, n, float(ratio.max()))
    return got


def _float32_errors(args, scale, readings=8):
    """[B, N]: the float32 plain route's largest error from the float64
    one, relative to `scale`, over `readings` readings with θ, q0 and qN
    each moved one ulp up or down at random, each against float64 at its
    own inputs. Where the curvature term or J Jᵀ is ill-conditioned one
    reading of float32's rounding is luck; the largest of several is the
    conditioning."""
    robot, world, theta, q0, qN = args[:5]
    gen = torch.Generator(device=theta.device).manual_seed(0)

    def ulp(t):
        up = torch.randint(0, 2, t.shape, generator=gen, device=t.device)
        return torch.nextafter(t, torch.where(
            up.bool(), torch.full_like(t, float("inf")),
            torch.full_like(t, float("-inf"))))

    worst = torch.zeros(theta.shape[:2], dtype=torch.float64,
                        device=theta.device)
    for _ in range(readings):
        moved = (robot, world, ulp(theta), ulp(q0), ulp(qN), *args[5:])
        e = ((_former(*moved).double() - _former(*_double(moved))).abs()
             / scale).amax(dim=-1)
        worst = torch.maximum(worst, e)
    return worst


_SHAPES = [(1, 20), (1, 100), (3, 20), (3, 100), (1024, 20), (1024, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("B, N", _SHAPES)
@pytest.mark.parametrize("robot_name", ["arm_7dof", "prismatic"])
@pytest.mark.parametrize("world", _WORLDS)
def test_kernel_is_plain_on_the_card(card, B, N, robot_name, world):
    dev, robots, worlds = card
    robot = robots[robot_name]
    theta, q0, qN = (t.to(dev) for t in _queries(robot, B, N, B + N))
    for curvature in (True, False):
        for pinv in (True, False):
            _compare(_args(robot, worlds[world], theta, q0, qN, curvature,
                           pinv),
                     f"{robot_name}:{world}:B{B}:N{N}:c{curvature:d}"
                     f":p{pinv:d}")


@pytest.mark.cuda
@pytest.mark.parametrize("B, N", [(3, 20), (1024, 100)])
@pytest.mark.parametrize("world", ["analytic", "packed"])
def test_kernel_from_the_middle_of_a_solve(card, B, N, world):
    """θ after 3 CHOMP iterations of config 3's planner from its queries
    (the step's own inputs), and a world of run-time primitive counts."""
    dev, robots, worlds = card
    robot = robots["arm_7dof"]
    _, q0, qN = _queries(robot, B, N, 7)
    cfg = PlannerConfig(mode="chomp", num_timesteps=N, max_iterations=3,
                        learning_rate=0.6, use_pseudo_inverse=True,
                        chomp_joint_update_limit=0.1)
    sol = plan_batch(robot, worlds[world], ProblemSpec(q0=q0, qN=qN), cfg)
    theta = sol.trajectory[:, 1:-1].contiguous()
    q0, qN = q0.to(dev), qN.to(dev)
    many = AnalyticWorld.make(
        spheres=[_SPHERE, ((1.0, -0.4, 0.5), 0.3), ((0.3, 0.6, 0.9), 0.1)],
        boxes=_BOXES + [((0.2, 0.7, 0.4), (0.1, 0.1, 0.4))]).to(dev)
    for w, label in ((worlds[world], world), (many, "runtime_counts")):
        for curvature, pinv in ((True, True), (False, False)):
            _compare(_args(robot, w, theta, q0, qN, curvature, pinv),
                     f"mid_solve:{label}:B{B}:N{N}:c{curvature:d}:p{pinv:d}")


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["analytic", "packed"])
def test_rank_deficient_chain(card, world):
    """A body whose Jacobian has one column leaves J Jᵀ + ridge·I near
    singular (condition ≈ 1e4): where that magnifies the float32 plain
    route's rounding, _compare holds the kernel to float64."""
    dev, _, worlds = card
    robot = _prismatic_arm(rank_deficient=True).to(dev)
    theta, q0, qN = (t.to(dev) for t in _queries(robot, 256, 50, 3))
    for curvature in (True, False):
        _compare(_args(robot, worlds[world], theta, q0, qN, curvature, True),
                 f"rank_deficient:{world}:c{curvature:d}")


def _double(args):
    def dbl(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).double()
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
            and getattr(obj, f.name).is_floating_point()})
    robot, world, *rest = args
    return (dbl(robot), dbl(world),
            *(a.double() if isinstance(a, torch.Tensor) else a
              for a in rest))


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["analytic", "composite"])
def test_kernel_replayed_from_a_graph(card, world):
    """A captured launch replayed on new θ is bitwise an eager launch on
    it, and a replay is bitwise the one before (no atomics)."""
    dev, robots, worlds = card
    robot = robots["arm_7dof"]
    static = [t.to(dev) for t in _queries(robot, 1024, 100, 0)]
    args = _args(robot, worlds[world], *static, True, True)
    cg.load(robot, worlds[world], static[0])
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        cg.functional_gradient(*args)               # warm the parameters
        with torch.cuda.graph(g, stream=stream):
            out = cg.functional_gradient(*args)
    torch.cuda.current_stream(dev).wait_stream(stream)
    for seed in (1, 2):
        new = [t.to(dev) for t in _queries(robot, 1024, 100, seed)]
        for s, n in zip(static, new):
            s.copy_(n)
        args[5].copy_(_args(robot, worlds[world], *new, True, True)[5])
        g.replay()
        first = out.clone()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
        assert torch.equal(first, cg.functional_gradient(*args))


def _chomp_cfg(**kw):
    base = dict(mode="chomp", num_timesteps=100, learning_rate=0.6,
                chomp_joint_update_limit=0.1, use_pseudo_inverse=True,
                max_iterations=40)
    base.update(kw)
    return PlannerConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["eager", "per_iteration", "chunk"])
def test_one_launch_an_iteration(card, route):
    dev, robots, worlds = card
    robot, world = robots["arm_7dof"], worlds["analytic"]
    _, q0, qN = _queries(robot, 64, 100, 4)
    prob = ProblemSpec(q0=q0, qN=qN)
    cfg = _chomp_cfg()
    for _ in range(2):                  # a cache miss, then a hit
        rollout.reset_launches()
        if route == "eager":
            with graph.eager():
                sol = plan_batch(robot, world, prob, cfg)
        elif route == "per_iteration":
            with graph.per_iteration():
                sol = plan_batch(robot, world, prob, cfg)
        else:
            sol = plan_batch(robot, world, prob, cfg)
        torch.cuda.synchronize()
        assert cg.LAUNCHES == {"chomp_grad": int(sol.iterations.max()),
                               "chomp_grad:runtime": 0}


@pytest.mark.cuda
def test_hmc_launches_one_a_gradient(card):
    """HMC's leapfrog force goes through the kernel: L + 1 gradients an
    iteration."""
    dev, robots, worlds = card
    _, q0, qN = _queries(robots["arm_7dof"], 16, 100, 5)
    cfg = _chomp_cfg(use_hamiltonian_monte_carlo=True, max_iterations=6)
    rollout.reset_launches()
    with graph.eager():
        sol = plan_batch(robots["arm_7dof"], worlds["analytic"],
                         ProblemSpec(q0=q0, qN=qN), cfg)
    torch.cuda.synchronize()
    assert cg.LAUNCHES["chomp_grad"] == (int(sol.iterations.max())
                                         * (cfg.hmc_leapfrog_steps + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_chomp_matches_the_float64_reference_on_the_card(card, seed):
    """tests/test_torch_chomp_reference.py's comparison with the solver on
    the card, so every gradient is the kernel's: θ after each of the first
    iterations within that test's atol, the recorded totals within its
    rtol."""
    from tests import test_torch_chomp_reference as ref_test

    dev = card[0]
    ref_mod = ref_test._guarded_reference()
    robot, world, q0, qN, cfg = ref_test._scene(seed)
    robot, world = robot.to(dev), world.to(dev)
    n, iterations = ref_test._N, ref_test._ITERATIONS
    Q0, QN = torch.as_tensor(q0, device=dev), torch.as_tensor(qN, device=dev)
    from tpustomp_torch.engine import solver
    QNw, state = solver._init_batch(robot, cfg, Q0, QN)
    ops = device_ops(n, cfg.dt, cfg.smoothness, dev)
    step = solver.make_step(robot, world, cfg, ops, Q0, QNw, None)
    cpu = torch.device("cpu")
    rollout.reset_launches()
    for j in range(1, iterations + 1):
        state = step(state, j - 1)
        ref = ref_mod.replay(ref_test._SMALL, q0, qN, j, "reference", cpu)
        np.testing.assert_allclose(state.theta.double().cpu().numpy(),
                                   ref["theta"], rtol=0,
                                   atol=ref_test._THETA_ATOL,
                                   err_msg=f"iteration {j}")
    assert cg.LAUNCHES["chomp_grad"] == iterations
    cfg_full = from_dict(ref_test._SMALL["planner"])
    sol = plan_batch(robot, world, ProblemSpec(q0=q0, qN=qN), cfg_full)
    ref = ref_mod.replay(ref_test._SMALL, q0, qN, iterations, "reference",
                         cpu)
    assert sol.iterations.cpu().tolist() == ref["ran"].tolist()
    np.testing.assert_allclose(
        sol.metrics.total_cost.double().cpu().numpy(), ref["totals"],
        rtol=ref_test._TOTAL_RTOL)

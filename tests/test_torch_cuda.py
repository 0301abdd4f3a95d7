"""On the card: the CUDA evaluator kernels (rollout_analytic, rollout_grid,
their per-row-world variants rollout_analytic:per_cand_world and
rollout_grid:per_cand_overlay, and the ``:ee`` and ``:con`` (constraint
route) forms of all four, on a
robot's static chain and on the runtime chain) against their plain PyTorch
version and each other (mirrors the kernel phases of chip_smoke.py),
including the edges of the skeleton's lane plan (waypoint counts around
the 30 owned lanes of a window, ragged candidate tiles, rows of 1/3/21
candidates, masked candidates, shared and per-row worlds within and above
the kernels' register budget, robots and worlds above the parameter
block),
the grid's packed corner table against its dense grid (bitwise) and a
planar 2-joint robot; and the batched slice
(STOMP, constrained STOMP, CHOMP, HMC) and batched MPC on CUDA against the
CPU run under the same noise, over analytic and voxel worlds.

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Every test skips without a CUDA device. Tolerances: q_obs atol 1e-5 /
rtol 1e-5, margin atol 1e-6 (FMA contraction and summation order move the
float32 FK chain by about 1 ULP per joint; measured on an H100 at the
config-4 shape: max |Δ| 1.3e-6 for q_obs at |q_obs| up to 3.7, 1.5e-7 for
margin).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpustomp_torch import (CostWeights, NoiseConfig, OrientationConstraint,
                            PlannerConfig, ProblemSpec, plan_batch)
from tpustomp_torch.engine import mpc as tmpc
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.kernels import rollout as tr
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.edt import occupancy_from_analytic, signed_edt
from tpustomp_torch.world.sdf import AnalyticWorld, CompositeWorld

from tests.test_torch_param_routes import NO_KERNEL_OPS, device_ops

Q_TOL = dict(atol=1e-5, rtol=1e-5)
M_ATOL = 1e-6

_WORLDS = {
    "spheres_boxes": dict(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))],
                          spheres=[((0.3, 0.3, 0.9), 0.1),
                                   ((1.2, -0.4, 0.0), 0.3)]),
    "boxes": dict(boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25)),
                         ((0.68, -0.05, 0.62), (0.06, 0.06, 0.18))]),
    "empty": dict(),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA evaluator kernel)")
    return torch.device("cuda")


def _cands(robot, C, T, seed, device):
    lo, hi = robot.joint_lower.cpu().numpy(), robot.joint_upper.cpu().numpy()
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(lo, hi, (C, T, len(lo))).astype(
        np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("world_name", sorted(_WORLDS))
@pytest.mark.parametrize("C,T", [(1, 2), (300, 17), (4000, 102)])
def test_kernel_matches_plain(cuda_device, world_name, C, T):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS[world_name]).to(cuda_device)
    cand = _cands(robot, C, T, C + T, cuda_device)
    before = tr.LAUNCHES["rollout_analytic"]
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 5.0 / 101, 0.05)
    assert tr.LAUNCHES["rollout_analytic"] == before + 1
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 5.0 / 101,
                                            0.05)
    torch.cuda.synchronize()
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_prismatic_rotated_chain(cuda_device):
    """A prismatic joint and non-identity fixed rotations (the kernel's
    general joint path; the built-in arms are all revolute)."""
    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    robot = tmodel._spec(
        joint_axis=[[0, 0, 1], [1, 0, 0], [0, 1, 0]],
        joint_offset=[[0, 0, 0.3], [0.4, 0, 0], [0.3, 0, 0]],
        joint_rot=np.stack([rz(0.3), rz(-0.5), rz(0.2)]),
        lower=[-3.0, 0.0, -3.0], upper=[3.0, 0.6, 3.0],
        limited=[True, True, True], joint_type=[0, 1, 0],
        body_link=[0, 1, 2, 2],
        body_offset=[[0.2, 0, 0], [0.1, 0, 0], [0.15, 0, 0], [0.3, 0, 0]],
        body_radius=[0.06, 0.05, 0.05, 0.04]).to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["spheres_boxes"]).to(cuda_device)
    cand = _cands(robot, 500, 30, 9, cuda_device)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.05, 0.08)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.08)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_row_active(cuda_device):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    C, T = 1000, 102
    cand = _cands(robot, C, T, 0, cuda_device)
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[128:256] = False
    active[::3] = False
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.05, 0.05,
                                      row_active=active)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q_k[active], q_p[active], **Q_TOL)
    torch.testing.assert_close(m_k[active], m_p[active], atol=M_ATOL, rtol=0)
    assert bool((q_k[~active] == 0).all()) and bool((m_k[~active] == 0).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    cand = _cands(robot, 8, 10, 0, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tr.obstacle_cost_batch(robot, world, cand.double(), 0.05, 0.05)
    with pytest.raises(ValueError, match="on cpu"):
        tr.obstacle_cost_batch(tmodel.arm_7dof(), world, cand, 0.05, 0.05)
    with pytest.raises(ValueError, match="xla"):
        tsolver._obstacle_rows(robot, world,
                               PlannerConfig(obstacle_backend="xla"), cand)


def _voxel_world(kind):
    """The config-2 tabletop voxelized at its own grid (64x80x48 at 2.5 cm)
    through the port's signed EDT; "composite" adds an overlay sphere."""
    origin, shape, res = (-0.2, -1.0, 0.0), (64, 80, 48), 0.025
    occ = occupancy_from_analytic(AnalyticWorld.make(**_WORLDS["boxes"]),
                                  origin, shape, res)
    grid = signed_edt(occ, res, origin)
    if kind == "grid":
        return grid
    return CompositeWorld.make(grid, spheres=[((0.35, 0.3, 0.55), 0.12)])


def _shuffled(robot, seed):
    """robot with its bodies in a random order and no body_counts."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        robot.num_bodies))
    return dataclasses.replace(
        robot, body_link=robot.body_link[perm],
        body_offset=robot.body_offset[perm],
        body_radius=robot.body_radius[perm], body_counts=None)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "composite"])
@pytest.mark.parametrize("C,T", [(1, 2), (300, 17), (4000, 102)])
def test_grid_kernel_matches_plain(cuda_device, kind, C, T):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = _voxel_world(kind).to(cuda_device)
    cand = _cands(robot, C, T, C + T, cuda_device)
    before = dict(tr.LAUNCHES)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 5.0 / 101, 0.05)
    assert tr.LAUNCHES["rollout_grid"] == before["rollout_grid"] + 1
    assert tr.LAUNCHES["rollout_analytic"] == before["rollout_analytic"]
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 5.0 / 101,
                                            0.05)
    torch.cuda.synchronize()
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "composite"])
def test_grid_kernel_row_active(cuda_device, kind):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = _voxel_world(kind).to(cuda_device)
    C, T = 1000, 102
    cand = _cands(robot, C, T, 0, cuda_device)
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[128:256] = False
    active[::3] = False
    q_k, m_k = tr.obstacle_cost_batch(
        robot, world, cand.permute(2, 1, 0).contiguous(), 0.05, 0.05,
        row_active=active, time_major=True)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q_k[active], q_p[active], **Q_TOL)
    torch.testing.assert_close(m_k[active], m_p[active], atol=M_ATOL, rtol=0)
    assert bool((q_k[~active] == 0).all()) and bool((m_k[~active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "grid"])
def test_kernels_take_unsorted_bodies(cuda_device, kind):
    """Robots with body_counts=None and bodies out of link order (the TPU's
    rolled kernels K1/K2): the wrapper sorts them on the device, and the
    launch is counted as one of unsorted bodies (BODY_ORDER)."""
    robot = _shuffled(tmodel.arm_7dof(), 1).to(cuda_device)
    world = (AnalyticWorld.make(**_WORLDS["boxes"]) if kind == "analytic"
             else _voxel_world("grid")).to(cuda_device)
    cand = _cands(robot, 2000, 102, 4, cuda_device)
    tr.reset_launches()
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.05, 0.05)
    assert tr.BODY_ORDER == {"sorted": 0, "unsorted": 1}
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
def test_grid_kernel_refusals(cuda_device):
    robot = tmodel.arm_7dof().to(cuda_device)
    cand = _cands(robot, 8, 10, 0, cuda_device)
    grid = _voxel_world("grid")
    with pytest.raises(ValueError, match="grid tensors are on cpu"):
        tr.obstacle_cost_batch(robot, grid, cand, 0.05, 0.05)
    flat = dataclasses.replace(grid, grid=grid.grid[:, :1], packed=None)
    with pytest.raises(ValueError, match=">= 2"):
        tr.obstacle_cost_batch(robot, flat.to(cuda_device), cand, 0.05, 0.05)
    over = AnalyticWorld(
        sphere_center=torch.zeros(5, 1, 3), sphere_radius=torch.ones(5, 1),
        box_center=torch.zeros(5, 0, 3), box_half=torch.zeros(5, 0, 3))
    with pytest.raises(ValueError, match="5 rows"):     # 5 rows, 8 candidates
        tr.obstacle_cost_batch(
            robot, CompositeWorld(grid, over).to(cuda_device), cand, 0.05,
            0.05)


class _NoiseBank:
    """noise_fn serving a fixed numpy z block per iteration on `device`, so
    runs on two devices see the same noise."""

    def __init__(self, d, B, K, N, iters, device, seed=0):
        rng = np.random.default_rng(seed)
        self.z = rng.standard_normal((iters, d, B, K, N)).astype(np.float32)
        self.device = device

    def __call__(self, iteration, active):
        return torch.from_numpy(self.z[iteration]).to(self.device)


@pytest.mark.cuda
def test_plan_batch_cuda_matches_cpu(cuda_device):
    """The whole slice on the card (CUDA evaluator) against the CPU run
    (plain evaluator) under the same noise: success and iterations equal,
    trajectory atol 1e-4, cost rtol 1e-4."""
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8, pi2_h=20.0,
                        noise=NoiseConfig(stddev=0.25, decay=1.0,
                                          num_rollouts_reused=2),
                        max_iterations=8)
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    rng = np.random.default_rng(3)
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    B = 4
    prob = ProblemSpec(q0=(q0 + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32), qN=(qN + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32))
    shape = (7, B, cfg.num_rollouts, cfg.num_timesteps, cfg.max_iterations)
    cpu = plan_batch(robot, world, prob, cfg, device="cpu",
                     noise_fn=_NoiseBank(*shape, "cpu"))
    before = tr.LAUNCHES["rollout_analytic"]
    gpu = plan_batch(robot, world, prob, cfg, device=cuda_device,
                     noise_fn=_NoiseBank(*shape, cuda_device)).to("cpu")
    assert (tr.LAUNCHES["rollout_analytic"] - before
            >= int(cpu.iterations.max()))
    assert torch.equal(gpu.success, cpu.success)
    assert torch.equal(gpu.iterations, cpu.iterations)
    torch.testing.assert_close(gpu.trajectory, cpu.trajectory, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(gpu.cost, cpu.cost, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_plan_batch_grid_cuda_matches_cpu(cuda_device):
    """The slice over the voxel tabletop: card (grid kernel) against CPU
    (plain evaluator) under the same noise."""
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8, pi2_h=20.0,
                        noise=NoiseConfig(stddev=0.25, decay=1.0,
                                          num_rollouts_reused=2),
                        max_iterations=8)
    robot = tmodel.arm_7dof()
    world = _voxel_world("grid")
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    B = 4
    rng = np.random.default_rng(5)
    prob = ProblemSpec(q0=(q0 + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32), qN=(qN + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32))
    shape = (7, B, cfg.num_rollouts, cfg.num_timesteps, cfg.max_iterations)
    cpu = plan_batch(robot, world, prob, cfg, device="cpu",
                     noise_fn=_NoiseBank(*shape, "cpu"))
    before = tr.LAUNCHES["rollout_grid"]
    gpu = plan_batch(robot, world, prob, cfg, device=cuda_device,
                     noise_fn=_NoiseBank(*shape, cuda_device)).to("cpu")
    assert tr.LAUNCHES["rollout_grid"] - before >= int(cpu.iterations.max())
    assert torch.equal(gpu.success, cpu.success)
    assert torch.equal(gpu.iterations, cpu.iterations)
    torch.testing.assert_close(gpu.trajectory, cpu.trajectory, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(gpu.cost, cpu.cost, rtol=1e-4, atol=0)


_VARIANT = {"analytic": "rollout_analytic:per_cand_world",
            "composite": "rollout_grid:per_cand_overlay"}


def _row_world(kind, R, seed, ns=2, nx=2):
    """A world with R rows: random spheres and boxes per row (analytic), or
    the voxel tabletop with per-row overlay spheres (composite)."""
    rng = np.random.default_rng(seed)
    if kind == "composite":
        nx = 0
    rows = AnalyticWorld(
        sphere_center=torch.from_numpy(rng.uniform(
            -0.8, 0.8, (R, ns, 3)).astype(np.float32)),
        sphere_radius=torch.from_numpy(rng.uniform(
            0.05, 0.3, (R, ns)).astype(np.float32)),
        box_center=torch.from_numpy(rng.uniform(
            -0.8, 0.8, (R, nx, 3)).astype(np.float32)),
        box_half=torch.from_numpy(rng.uniform(
            0.05, 0.4, (R, nx, 3)).astype(np.float32)))
    if kind == "analytic":
        return rows
    return CompositeWorld(grid=_voxel_world("grid"), overlay=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "composite"])
@pytest.mark.parametrize("C,T,per", [(1, 2, 1), (300, 17, 1), (300, 17, 3),
                                     (4200, 52, 21)])
def test_row_world_kernels_match_plain(cuda_device, kind, C, T, per):
    """The per-row-world variants against the plain version, grouped
    (cands_per_row = per) and with a row_active mask: masked rows are
    zeros, active rows unchanged."""
    robot = tmodel.arm_7dof().to(cuda_device)
    world = _row_world(kind, C // per, C + T).to(cuda_device)
    cand = _cands(robot, C, T, C + T, cuda_device)
    before = dict(tr.LAUNCHES)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 5.0 / 51, 0.05,
                                      cands_per_row=per)
    after = dict(tr.LAUNCHES)
    assert after[_VARIANT[kind]] == before[_VARIANT[kind]] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 5.0 / 51,
                                            0.05, cands_per_row=per)
    torch.cuda.synchronize()
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    q_a, m_a = tr.obstacle_cost_batch(
        robot, world, cand.permute(2, 1, 0).contiguous(), 5.0 / 51, 0.05,
        row_active=active, time_major=True, cands_per_row=per)
    assert torch.equal(q_a[active], q_k[active])
    assert torch.equal(m_a[active], m_k[active])
    assert bool((q_a[~active] == 0).all()) and bool((m_a[~active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nx", [(1, 0), (0, 2), (0, 0)])
def test_row_world_kernel_empty_families(cuda_device, ns, nx):
    robot = tmodel.arm_7dof().to(cuda_device)
    world = _row_world("analytic", 500, 3, ns, nx).to(cuda_device)
    cand = _cands(robot, 500, 30, 2, cuda_device)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.05, 0.05)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "composite"])
def test_row_world_kernels_equal_shared_bitwise(cuda_device, kind):
    """Every row holding the same world: the per-row variant equals the
    shared-world kernel bit for bit (one primitives_dist, the row's base
    pointer), and the per-candidate form equals the grouped one."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, T, per = 2100, 52, 21
    shared = (AnalyticWorld.make(**_WORLDS["spheres_boxes"])
              if kind == "analytic" else _voxel_world("composite"))
    over = shared if kind == "analytic" else shared.overlay

    def rows(R):
        return AnalyticWorld(**{
            f: getattr(over, f).expand((R,) + getattr(over, f).shape)
            for f in AnalyticWorld.__dataclass_fields__})

    def wrap(o):
        return o if kind == "analytic" else CompositeWorld(shared.grid, o)

    cand = _cands(robot, C, T, 8, cuda_device).permute(2, 1, 0).contiguous()
    run = lambda w, **kw: tr.obstacle_cost_batch(
        robot, w.to(cuda_device), cand, 0.06, 0.05, time_major=True, **kw)
    q_s, m_s = run(shared)
    q_g, m_g = run(wrap(rows(C // per)), cands_per_row=per)
    q_c, m_c = run(wrap(rows(C)))
    for q, m in ((q_g, m_g), (q_c, m_c)):
        assert torch.equal(q, q_s) and torch.equal(m, m_s)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "composite"])
def test_worlds_above_the_register_budget(cuda_device, kind):
    """3 spheres and 3 boxes (30 floats), more than either kernel holds in
    registers: the instantiation that reads them from memory, shared and
    per-row, against the plain version, and every row equal to the shared
    world bit for bit."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, T, per = 2100, 52, 21
    rng = np.random.default_rng(11)
    over = AnalyticWorld.make(
        spheres=[(tuple(rng.uniform(-0.8, 0.8, 3)), rng.uniform(0.05, 0.3))
                 for _ in range(3)],
        boxes=[(tuple(rng.uniform(-0.8, 0.8, 3)),
                tuple(rng.uniform(0.05, 0.4, 3))) for _ in range(3)])
    rows = AnalyticWorld(**{
        f: getattr(over, f).expand((C // per,) + getattr(over, f).shape)
        for f in AnalyticWorld.__dataclass_fields__})
    if kind == "composite":
        grid = _voxel_world("grid")
        over, rows = CompositeWorld(grid, over), CompositeWorld(grid, rows)
    cand = _cands(robot, C, T, 12, cuda_device).permute(2, 1, 0).contiguous()
    got = []
    for world, kw in ((over, {}), (rows, dict(cands_per_row=per))):
        world = world.to(cuda_device)
        q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.06, 0.05,
                                          time_major=True, **kw)
        q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.06,
                                                0.05, time_major=True, **kw)
        torch.testing.assert_close(q_k, q_p, **Q_TOL)
        torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
        got.append((q_k, m_k))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


_EE_WORLDS = {"rollout_analytic": "analytic",
              "rollout_analytic:per_cand_world": "analytic",
              "rollout_grid": "composite",
              "rollout_grid:per_cand_overlay": "composite"}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_EE_WORLDS))
def test_ee_variants_match_plain(cuda_device, variant):
    """The ``:ee`` form of every variant: ee against the plain fk_frames
    frame (rtol 1e-5, atol 2e-5, the JAX package's gate), zeros on masked
    rows, and q_obs/margin bitwise equal to the launch without ee."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, T, per = 4200, 52, 21
    kind = _EE_WORLDS[variant]
    if variant.endswith(("per_cand_world", "per_cand_overlay")):
        world = _row_world(kind, C // per, 7).to(cuda_device)
    else:
        per = None
        world = (AnalyticWorld.make(**_WORLDS["spheres_boxes"]) if
                 kind == "analytic" else _voxel_world("grid")).to(cuda_device)
    cand = _cands(robot, C, T, 11, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    kw = dict(row_active=active, time_major=True, cands_per_row=per)
    before = dict(tr.LAUNCHES)
    q, m, ee = tr.obstacle_cost_batch(robot, world, tm, 0.06, 0.05,
                                      want_ee=True, **kw)
    after = dict(tr.LAUNCHES)
    assert after[variant + ":ee"] == before[variant + ":ee"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    q0, m0 = tr.obstacle_cost_batch(robot, world, tm, 0.06, 0.05, **kw)
    assert torch.equal(q, q0) and torch.equal(m, m0)
    _, _, ee_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.06, 0.05,
                                              cands_per_row=per, want_ee=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(ee[:, :, active], ee_p[:, :, active],
                               rtol=1e-5, atol=2e-5)
    assert bool((ee[:, :, ~active] == 0).all())


def _slice_config(mode):
    base = PlannerConfig(num_timesteps=20, num_rollouts=8, pi2_h=20.0,
                         noise=NoiseConfig(stddev=0.25, decay=1.0,
                                           num_rollouts_reused=2),
                         max_iterations=8)
    if mode == "stomp_torque":
        return base.replace(weights=CostWeights(torque=0.005))
    if mode in ("chomp", "hmc"):
        return base.replace(
            mode="chomp", learning_rate=0.6, use_pseudo_inverse=True,
            weights=CostWeights(obstacle=20.0, smoothness=0.1),
            use_hamiltonian_monte_carlo=mode == "hmc", hmc_step_size=0.3,
            hmc_leapfrog_steps=3, hmc_temperature=0.05)
    return base


class _HMCBank(_NoiseBank):
    """HMC draws from a fixed numpy bank: (z [d, B, 1, N], u [B])."""

    def __init__(self, d, B, N, iters, device, seed=0):
        super().__init__(d, B, 1, N, iters, device, seed)
        self.u = np.random.default_rng(seed + 1).uniform(
            size=(iters, B)).astype(np.float32)

    def __call__(self, iteration, active):
        return (super().__call__(iteration, active),
                torch.from_numpy(self.u[iteration]).to(self.device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stomp_constrained", "stomp_torque",
                                  "chomp", "hmc"])
def test_new_modes_cuda_match_cpu(cuda_device, mode):
    """Constrained and torque-weighted STOMP, CHOMP and HMC on the card
    (kernels, :con forms for constraints) against the CPU run under the
    same draws: success and iterations equal, trajectory atol 1e-4."""
    cfg = _slice_config(mode)
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    B = 4
    rng = np.random.default_rng(8)
    prob = ProblemSpec(q0=(q0 + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32), qN=(qN + rng.uniform(-0.03, 0.03, (B, 7))).astype(
        np.float32))
    cons = (OrientationConstraint.make(tolerance=0.25, weight=0.3)
            if mode == "stomp_constrained" else None)

    def noise(device):
        if mode == "hmc":
            return _HMCBank(7, B, cfg.num_timesteps, cfg.max_iterations,
                            device)
        return _NoiseBank(7, B, cfg.num_rollouts, cfg.num_timesteps,
                          cfg.max_iterations, device)

    cpu = plan_batch(robot, world, prob, cfg, device="cpu",
                     noise_fn=noise("cpu"), constraints=cons)
    before = dict(tr.LAUNCHES)
    gpu = plan_batch(robot, world, prob, cfg, device=cuda_device,
                     noise_fn=noise(cuda_device),
                     constraints=cons).to("cpu")
    kernel = "rollout_analytic" + (":con" if cons is not None else "")
    assert tr.LAUNCHES[kernel] - before[kernel] >= int(cpu.iterations.max())
    assert torch.equal(gpu.success, cpu.success)
    assert torch.equal(gpu.iterations, cpu.iterations)
    torch.testing.assert_close(gpu.trajectory, cpu.trajectory, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(gpu.cost, cpu.cost, rtol=1e-4, atol=0)


class _MPCNoiseBank:
    """noise_fn(tick, iteration, active) serving a fixed numpy z block."""

    def __init__(self, ticks, iters, d, B, K, N, device, seed=0):
        rng = np.random.default_rng(seed)
        self.z = rng.standard_normal((ticks, iters, d, B, K, N)).astype(
            np.float32)
        self.device = device

    def __call__(self, tick, iteration, active):
        return torch.from_numpy(self.z[tick, iteration]).to(self.device)


@pytest.mark.cuda
@pytest.mark.parametrize("static", ["none", "analytic", "grid"])
def test_run_mpc_batch_cuda_matches_cpu(cuda_device, static):
    """Batched MPC on the card (per-row-world kernels) against the CPU run
    (plain evaluator) under the same noise: B=8, 4 ticks, arm_7dof over the
    tabletop (boxes, voxelized, or none) with one moving sphere each."""
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8, pi2_h=20.0,
                        noise=NoiseConfig(stddev=0.25, decay=1.0,
                                          num_rollouts_reused=2),
                        max_iterations=8, record_metrics=False)
    robot = tmodel.arm_7dof()
    static_world = {"none": None,
                    "analytic": AnalyticWorld.make(**_WORLDS["boxes"]),
                    "grid": _voxel_world("grid")}[static]
    B, ticks = 8, 4
    rng = np.random.default_rng(6)
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    centers = np.stack([rng.uniform(0.4, 0.7, B), rng.uniform(-0.4, 0.4, B),
                        rng.uniform(0.4, 0.7, B)], 1)[:, None]
    state = tmpc.init_mpc(robot, cfg, q0 + rng.uniform(-0.03, 0.03, (B, 7)),
                          np.tile(qN, (B, 1)), centers,
                          rng.normal(0, 0.2, (B, 1, 3)))
    shape = (ticks, cfg.max_iterations, 7, B, cfg.num_rollouts,
             cfg.num_timesteps)
    kw = dict(static_world=static_world)
    cpu = tmpc.run_mpc_batch(robot, cfg, state, [0.12], ticks, 0.1,
                             device="cpu", noise_fn=_MPCNoiseBank(
                                 *shape, "cpu"), **kw)
    variant = _VARIANT["composite" if static == "grid" else "analytic"]
    before = tr.LAUNCHES[variant]
    gpu = tmpc.run_mpc_batch(robot, cfg, state, [0.12], ticks, 0.1,
                             device=cuda_device, noise_fn=_MPCNoiseBank(
                                 *shape, cuda_device), **kw).to("cpu")
    assert tr.LAUNCHES[variant] - before >= ticks
    for f in ("collided", "reached_tick", "steps"):
        assert torch.equal(getattr(gpu, f), getattr(cpu, f)), f
    for f in ("q", "theta", "sphere_center"):
        torch.testing.assert_close(getattr(gpu, f), getattr(cpu, f),
                                   atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_run_mpc_batch_refuses_xla_backend_on_cuda(cuda_device):
    """obstacle_backend="xla" names the plain evaluator: MPC on the card
    refuses it instead of running the plain path there."""
    cfg = PlannerConfig(num_timesteps=6, num_rollouts=3, max_iterations=2,
                        obstacle_backend="xla")
    robot = tmodel.planar_2r()
    state = tmpc.init_mpc(robot, cfg, np.zeros((2, 2)), np.ones((2, 2)),
                          np.full((2, 1, 3), 3.0), np.zeros((2, 1, 3)))
    with pytest.raises(ValueError, match="xla"):
        tmpc.run_mpc_batch(robot, cfg, state, [0.1], 1, 0.1,
                           device=cuda_device)


def _edge_world(kind, R, seed):
    """The world kinds the skeleton instantiates differently: per-row
    worlds (1 sphere + 2 boxes analytic, 1 sphere over the voxel grid),
    and shared worlds (the tabletop boxes, the voxel grid)."""
    if kind == "analytic_rows":
        return _row_world("analytic", R, seed, ns=1, nx=2)
    if kind == "composite_rows":
        return _row_world("composite", R, seed, ns=1)
    if kind == "analytic_shared":
        return AnalyticWorld.make(**_WORLDS["boxes"])
    return _voxel_world("grid")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic_rows", "composite_rows",
                                  "analytic_shared", "grid_shared"])
@pytest.mark.parametrize("T", [2, 3, 17, 31, 32, 33, 52, 102])
def test_segment_edges_match_plain(cuda_device, kind, T):
    """Waypoint counts around the window edges (30 owned waypoints per
    window) with a ragged candidate tile (C = 273, not a multiple of the 8
    candidates a block takes): q_obs, margin and ee against the plain
    version; masked warps (every third scenario and single candidates)
    write zeros and leave the other rows bit for bit unchanged."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, per = 273, 21
    rows = kind.endswith("_rows")
    world = _edge_world(kind, C // per, T).to(cuda_device)
    per = per if rows else None
    cand = _cands(robot, C, T, T, cuda_device)
    dt = 5.0 / max(T - 1, 1)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, dt, 0.05,
                                      cands_per_row=per)
    q_p, m_p, ee_p = tr.obstacle_cost_batch_plain(
        robot, world, cand, dt, 0.05, cands_per_row=per, want_ee=True)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[(torch.arange(C, device=cuda_device) // 21) % 3 == 1] = False
    active[[0, 8, 100, 272]] = False
    q_a, m_a, ee = tr.obstacle_cost_batch(
        robot, world, cand.permute(2, 1, 0).contiguous(), dt, 0.05,
        row_active=active, time_major=True, cands_per_row=per, want_ee=True)
    assert torch.equal(q_a[active], q_k[active])
    assert torch.equal(m_a[active], m_k[active])
    assert bool((q_a[~active] == 0).all()) and bool((m_a[~active] == 0).all())
    torch.testing.assert_close(ee[:, :, active], ee_p[:, :, active],
                               rtol=1e-5, atol=2e-5)
    assert bool((ee[:, :, ~active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "composite"])
@pytest.mark.parametrize("per", [1, 3, 21])
def test_cands_per_row_match_plain(cuda_device, kind, per):
    """Rows of 1, 3 and 21 candidates (a warp's row is its candidate's;
    rows straddle the 8-candidate blocks) against the plain version."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, T = 273, 52
    world = _row_world(kind, C // per, per, ns=1, nx=2).to(cuda_device)
    cand = _cands(robot, C, T, per, cuda_device)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.06, 0.05,
                                      cands_per_row=per)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.06, 0.05,
                                            cands_per_row=per)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "composite", "composite_rows"])
def test_packed_table_equals_dense_grid(cuda_device, kind):
    """The grid kernel through the packed corner table and through the
    dense grid (pack=False): the same corner values and arithmetic, so
    q_obs, margin and ee agree bit for bit."""
    robot = tmodel.arm_7dof().to(cuda_device)
    C, T, per = 2100, 52, None
    if kind == "composite_rows":
        world, per = _row_world("composite", C // 21, 4, ns=1), 21
    else:
        world = _voxel_world(kind)
    grid = world if kind == "grid" else world.grid
    assert grid.packed is not None
    dense_grid = dataclasses.replace(grid, packed=None)
    dense = (dense_grid if kind == "grid"
             else dataclasses.replace(world, grid=dense_grid))
    tm = _cands(robot, C, T, 6, cuda_device).permute(2, 1, 0).contiguous()
    got = [tr.obstacle_cost_batch(robot, w.to(cuda_device), tm, 0.06, 0.05,
                                  time_major=True, cands_per_row=per,
                                  want_ee=True) for w in (world, dense)]
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic", "grid"])
def test_planar_2r_matches_plain(cuda_device, kind):
    """A 2-joint robot (one body per link, no fixed rotations) through
    both kernels."""
    robot = tmodel.planar_2r(bodies_per_link=3).to(cuda_device)
    world = (AnalyticWorld.make(spheres=[((1.0, 0.8, 0.0), 0.3)],
                                boxes=[((-0.5, -1.0, 0.0),
                                        (0.4, 0.3, 0.5))])
             if kind == "analytic" else _voxel_world("grid")).to(cuda_device)
    cand = _cands(robot, 999, 40, 2, cuda_device)
    q_k, m_k = tr.obstacle_cost_batch(robot, world, cand, 0.05, 0.05)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.05, 0.05)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


# ---- the joint chain (the TPU kernels' static_joints) ----------------------

def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


# A torso lift (prismatic, +z) under a 3-joint arm and a wrist: a negated
# axis, a general axis, rpy on two joints (rot_fixed_identity False), a
# fixed tool link, cylinder and box geometry. Also read by
# tests/test_torch_urdf.py.
TORSO_ARM_URDF = """
<robot name="torso_arm">
  <link name="base"/>
  <link name="torso">
    <collision><origin xyz="0 0 0.2"/>
      <geometry><box size="0.1 0.1 0.3"/></geometry></collision>
  </link>
  <link name="upper">
    <collision><origin xyz="0.15 0 0" rpy="0 1.5707963267948966 0"/>
      <geometry><cylinder radius="0.05" length="0.3"/></geometry></collision>
  </link>
  <link name="fore">
    <collision><origin xyz="0.12 0 0"/>
      <geometry><box size="0.24 0.06 0.06"/></geometry></collision>
  </link>
  <link name="hand"/>
  <link name="tool">
    <collision><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="lift" type="prismatic">
    <parent link="base"/><child link="torso"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
    <limit lower="0" upper="0.3"/>
  </joint>
  <joint name="shoulder" type="revolute">
    <parent link="torso"/><child link="upper"/>
    <origin xyz="0 0 0.4" rpy="0 0 0.4"/><axis xyz="0 -1 0"/>
    <limit lower="-1.5" upper="1.5"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="0.3 0 0" rpy="0.2 0 0"/><axis xyz="0.6 0 0.8"/>
    <limit lower="-2" upper="2"/>
  </joint>
  <joint name="wrist" type="continuous">
    <parent link="fore"/><child link="hand"/>
    <origin xyz="0.24 0 0"/><axis xyz="1 0 0"/>
  </joint>
  <joint name="tool_mount" type="fixed">
    <parent link="hand"/><child link="tool"/>
    <origin xyz="0.08 0 0"/>
  </joint>
</robot>
"""


def rpr_robot(m):
    """The RPR chain of tests/unit/test_rollout_kernel.py:88-110: a
    prismatic joint and non-identity fixed rotations (m: either package's
    robot.model)."""
    return m._spec(
        joint_axis=[[0, 0, 1], [1, 0, 0], [0, 1, 0]],
        joint_offset=[[0, 0, 0.3], [0.4, 0, 0], [0.3, 0, 0]],
        joint_rot=np.stack([_rz(0.3), _rz(-0.5), _rz(0.2)]),
        lower=[-3.0, 0.0, -3.0], upper=[3.0, 0.6, 3.0],
        limited=[True, True, True], joint_type=[0, 1, 0],
        body_link=[0, 1, 2, 2],
        body_offset=[[0.2, 0, 0], [0.1, 0, 0], [0.15, 0, 0], [0.3, 0, 0]],
        body_radius=[0.06, 0.05, 0.05, 0.04])


def general_axis_robot(m):
    """General (non-0/±1) and negative axis components, a prismatic joint
    along a general axis, fixed rotations, bodies out of link order."""
    return m._spec(
        joint_axis=[[0.6, 0.0, 0.8], [0.0, -1.0, 0.0], [0.0, 0.8, -0.6],
                    [-1.0, 0.0, 0.0]],
        joint_offset=[[0, 0, 0.4], [0.1, 0, 0], [0.3, 0.05, 0],
                      [0.2, 0, 0]],
        joint_rot=np.stack([np.eye(3), _rz(0.25), np.eye(3), _rz(-0.6)]),
        lower=[-2.0, -1.5, -0.3, -2.0], upper=[2.0, 1.5, 0.3, 2.0],
        limited=[True] * 4, joint_type=[0, 0, 1, 0],
        body_link=[3, 0, 1, 1, 2, 3], body_offset=np.random.default_rng(
            0).uniform(-0.15, 0.15, (6, 3)), body_radius=[0.05] * 6)


def _chain_robot(name):
    """Robots whose static chains fold differently: the built-ins (unit
    axes), an RPR chain with a prismatic joint and fixed rotations, general
    and negative axis components (one prismatic), and a URDF robot."""
    from tpustomp_torch.robot import load_urdf

    if name == "arm_7dof":
        return tmodel.arm_7dof()
    if name == "planar_2r":
        return tmodel.planar_2r(bodies_per_link=3)
    if name == "rpr_prismatic":
        return rpr_robot(tmodel)
    if name == "general_axis":
        return general_axis_robot(tmodel)
    return load_urdf(TORSO_ARM_URDF)


def _variant_world(variant, R):
    if variant == "rollout_analytic":
        return AnalyticWorld.make(**_WORLDS["spheres_boxes"]), None
    if variant == "rollout_grid":
        return _voxel_world("grid"), None
    if variant == "rollout_analytic:per_cand_world":
        return _row_world("analytic", R, 5, ns=1, nx=2), 21
    return _row_world("composite", R, 5, ns=1), 21


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_EE_WORLDS))
@pytest.mark.parametrize("robot_name", ["arm_7dof", "planar_2r",
                                        "rpr_prismatic", "general_axis",
                                        "urdf_torso_arm"])
def test_static_chain_matches_runtime_and_plain(cuda_device, robot_name,
                                                variant):
    """Every variant and its :ee form on the robot's static chain against
    the plain version and against the runtime chain (joint_static=None), at
    the kernel-vs-plain tolerance, at the window edges T in {2, 3, 33, 52,
    102} with a ragged tile and masked rows (zeros; other rows bit for bit
    as the unmasked launch)."""
    robot = _chain_robot(robot_name).to(cuda_device)
    runtime = dataclasses.replace(robot, joint_static=None)
    assert tr.chain_of(robot) is not None and tr.chain_of(runtime) is None
    C = 273
    world, per = _variant_world(variant, C // 21)
    world = world.to(cuda_device)
    for T in (2, 3, 33, 52, 102):
        cand = _cands(robot, C, T, T, cuda_device)
        tm = cand.permute(2, 1, 0).contiguous()
        dt = 5.0 / (T - 1)
        q_p, m_p, ee_p = tr.obstacle_cost_batch_plain(
            robot, world, cand, dt, 0.05, cands_per_row=per, want_ee=True)
        active = torch.ones(C, dtype=torch.bool, device=cuda_device)
        active[::3] = False
        for ee in (False, True):
            kw = dict(time_major=True, cands_per_row=per, want_ee=ee)
            before = dict(tr.LAUNCHES)
            s = tr.obstacle_cost_batch(robot, world, tm, dt, 0.05, **kw)
            r = tr.obstacle_cost_batch(runtime, world, tm, dt, 0.05, **kw)
            sm = tr.obstacle_cost_batch(robot, world, tm, dt, 0.05,
                                        row_active=active, **kw)
            form = variant + (":ee" if ee else "")
            runtime_form = variant + ":runtime" + (":ee" if ee else "")
            assert {k: tr.LAUNCHES[k] - before[k] for k in before
                    if tr.LAUNCHES[k] != before[k]} == {form: 2,
                                                       runtime_form: 1}
            torch.cuda.synchronize()
            for ref in ((q_p, m_p, ee_p), r):
                torch.testing.assert_close(s[0], ref[0], **Q_TOL)
                torch.testing.assert_close(s[1], ref[1], atol=M_ATOL, rtol=0)
                if ee:
                    torch.testing.assert_close(s[2], ref[2], rtol=1e-5,
                                               atol=2e-5)
            for a, b in zip(sm[:2], s[:2]):
                assert torch.equal(a[active], b[active])
                assert bool((a[~active] == 0).all())
            if ee:
                assert torch.equal(sm[2][:, :, active], s[2][:, :, active])
                assert bool((sm[2][:, :, ~active] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("robot_name", ["planar_2r", "arm_7dof_3_spheres"])
def test_chain_mismatch_is_a_launch_error(cuda_device, robot_name):
    """A library compiled for arm_7dof's chain refuses a robot whose joint
    or body count differs (cudaErrorInvalidValue, 1): the wrapper raises."""
    robot = (tmodel.planar_2r() if robot_name == "planar_2r"
             else tmodel.arm_7dof(spheres_per_link=3)).to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    grid, prims = tr._world_parts(world)
    cand = _cands(robot, 64, 10, 0, cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tr._launch(robot, world, grid, prims, None, cand, 0.05, 0.05, None,
                   False, False, tr.chain_of(tmodel.arm_7dof()))


@pytest.mark.cuda
def test_stale_robot_plans_on_runtime_kernels(cuda_device):
    """A stale joint_static through plan_batch: a warning, only :runtime
    launches, and the honest robot's trajectory bit for bit."""
    import warnings

    robot = tmodel.arm_7dof()
    axes = robot.joint_axis.clone()
    axes[1] = torch.tensor([0.0, 0.0, 1.0])
    stale = dataclasses.replace(robot, joint_axis=axes)
    honest = dataclasses.replace(stale, joint_static=None)
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8, max_iterations=4)
    prob = ProblemSpec(q0=np.zeros((4, 7), np.float32),
                       qN=np.full((4, 7), 0.4, np.float32))
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    before = dict(tr.LAUNCHES)
    with pytest.warns(UserWarning, match="joint_static"):
        got = plan_batch(stale, world, prob, cfg, device=cuda_device)
    ran = {k for k in before if tr.LAUNCHES[k] != before[k]}
    assert ran and all(":runtime" in k for k in ran), ran
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        ref = plan_batch(honest, world, prob, cfg, device=cuda_device)
    assert torch.equal(got.trajectory, ref.trajectory)


def _row_spheres(B, seed, device):
    """The tabletop boxes plus one sphere per row, placed near the arm."""
    rng = np.random.default_rng(seed)
    boxes = AnalyticWorld.make(**_WORLDS["boxes"])
    centers = np.float32([0.5, 0.3, 0.7]) + rng.uniform(-0.1, 0.1, (B, 1, 3))
    return AnalyticWorld(
        sphere_center=torch.tensor(centers, dtype=torch.float32),
        sphere_radius=torch.full((B, 1), 0.08),
        box_center=boxes.box_center.expand(B, -1, -1).clone(),
        box_half=boxes.box_half.expand(B, -1, -1).clone()).to(device)


def _jittered(B, seed):
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    rng = np.random.default_rng(seed)
    return ((q0 + rng.uniform(-0.2, 0.2, (B, 7))).astype(np.float32),
            (qN + rng.uniform(-0.2, 0.2, (B, 7))).astype(np.float32))


@pytest.mark.cuda
def test_compaction_world_batched_cuda_equals_uncompacted(cuda_device):
    """solve_batch_compacted over per-row worlds on the card (K3-pcw on
    regrouped batches: gathered world rows, a smaller B·C) against
    solve_batch under the same draws: success and iterations equal,
    trajectory atol 1e-5 (cuBLAS may pick other kernels for the smaller
    matmuls of a regrouped batch)."""
    from tpustomp_torch.dynamics.device import device_ops

    cfg = _slice_config("stomp").replace(max_iterations=16,
                                         max_iterations_after_collision_free=3)
    robot = tmodel.arm_7dof().to(cuda_device)
    B = 32
    worldB = _row_spheres(B, 0, cuda_device)
    q0, qN = (torch.from_numpy(x).to(cuda_device) for x in _jittered(B, 1))
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, cuda_device)

    def noise():
        return _NoiseBank(7, B, cfg.num_rollouts, cfg.num_timesteps,
                          cfg.max_iterations, cuda_device)

    ref = tsolver.solve_batch(robot, worldB, cfg, ops, q0, qN, noise(),
                              world_batched=True)
    before = tr.LAUNCHES["rollout_analytic:per_cand_world"]
    got = tsolver.solve_batch_compacted(robot, worldB, cfg, ops, q0, qN,
                                        noise(), world_batched=True, chunk=2,
                                        min_bucket=2)
    assert (tr.LAUNCHES["rollout_analytic:per_cand_world"] - before
            >= int(ref.iterations.max()))
    assert len(set(ref.iterations.tolist())) > 1
    assert torch.equal(got.success, ref.success)
    assert torch.equal(got.iterations, ref.iterations)
    torch.testing.assert_close(got.trajectory, ref.trajectory, atol=1e-5,
                               rtol=0)


@pytest.mark.cuda
def test_smooth_projection_cuda_matches_cpu(cuda_device):
    """plan_batch with rollout_limit_projection="smooth" on the card against
    the CPU run under the same draws: success and iterations equal,
    trajectory atol 1e-4, cost rtol 1e-4."""
    cfg = _slice_config("stomp").replace(rollout_limit_projection="smooth")
    robot = tmodel.arm_7dof()
    lower = robot.joint_lower.clone()
    upper = robot.joint_upper.clone()
    lower[0], upper[0] = -0.7, 0.45          # the rollouts leave this band
    robot = dataclasses.replace(robot, joint_lower=lower, joint_upper=upper)
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    B = 4
    q0, qN = _jittered(B, 2)
    prob = ProblemSpec(q0=np.clip(q0, -0.65, 0.4), qN=np.clip(qN, -0.65, 0.4))

    def noise(device):
        return _NoiseBank(7, B, cfg.num_rollouts, cfg.num_timesteps,
                          cfg.max_iterations, device)

    cpu = plan_batch(robot, world, prob, cfg, device="cpu",
                     noise_fn=noise("cpu"))
    gpu = plan_batch(robot, world, prob, cfg, device=cuda_device,
                     noise_fn=noise(cuda_device)).to("cpu")
    assert torch.equal(gpu.success, cpu.success)
    assert torch.equal(gpu.iterations, cpu.iterations)
    torch.testing.assert_close(gpu.trajectory, cpu.trajectory, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(gpu.cost, cpu.cost, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_stream_cuda_matches_plan_batch(cuda_device, depth):
    """plan_batch_stream on the card (pinned uploads and downloads on a
    side stream) yields what plan_batch returns per batch, bitwise; with no
    `device` both run on the card."""
    from tpustomp_torch import plan_batch_stream

    cfg = _slice_config("stomp")
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    probs = [ProblemSpec(*_jittered(8, s)) for s in range(4)]
    items = [(p, torch.Generator(cuda_device).manual_seed(s))
             for s, p in enumerate(probs)]
    got = list(plan_batch_stream(robot, world, items, cfg, depth=depth))
    assert len(got) == len(probs)
    for s, (p, (traj, succ)) in enumerate(zip(probs, got)):
        ref = plan_batch(robot, world, p, cfg,
                         generator=torch.Generator(cuda_device).manual_seed(s))
        assert ref.trajectory.device.type == "cuda"
        assert np.array_equal(traj, ref.trajectory.cpu().numpy())
        assert np.array_equal(succ, ref.success.cpu().numpy())


def _patched_tabletop(device):
    """The config-2 tabletop as an IncrementalSDF on `device`, with a box
    added by set_box and a point cloud by add_points; returns (the patched
    field, the world before the updates, copies of that world's grid and
    table)."""
    from tpustomp_torch.world.edt import IncrementalSDF

    origin, shape, res = (-0.2, -1.0, 0.0), (64, 80, 48), 0.025
    occ = occupancy_from_analytic(AnalyticWorld.make(**_WORLDS["boxes"]),
                                  origin, shape, res)
    inc = IncrementalSDF(occ, origin, res, max_distance=0.5, device=device)
    before = inc.as_world()
    saved = (before.grid.clone(), before.packed.clone())
    inc.set_box((30, 50, 24), (36, 58, 32), True)
    inc.add_points(np.random.default_rng(0).uniform(
        (0.2, -0.7, 0.7), (0.3, -0.6, 0.8), (500, 3)))
    return inc, before, saved


@pytest.mark.cuda
def test_incremental_sdf_patch_equals_rebuild_on_card(cuda_device):
    """The patch written on the card (clone, slice assignment, index_copy_
    of the touched table rows) equals a fresh field on the final occupancy
    bitwise; the world taken before the updates is unchanged."""
    from tpustomp_torch.world.edt import IncrementalSDF

    inc, before, (grid0, packed0) = _patched_tabletop(cuda_device)
    fresh = IncrementalSDF(inc.occ, inc.origin, inc.resolution,
                           inc.max_distance, device=cuda_device)
    w, f = inc.as_world(), fresh.as_world()
    assert w.grid.device.type == w.packed.device.type == "cuda"
    assert torch.equal(w.grid, f.grid)
    cells = lambda p: p.reshape(64, 80, 48, 8)[:-1, :-1, :-1]
    assert torch.equal(cells(w.packed), cells(f.packed))
    assert torch.equal(before.grid, grid0)
    assert torch.equal(before.packed, packed0)
    assert not torch.equal(w.grid, grid0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "composite_rows"])
def test_grid_kernels_on_patched_world(cuda_device, kind):
    """K5 (rollout_grid) and K5-pco (rollout_grid:per_cand_overlay) on the
    patched field: bitwise the rebuilt field's launch, and within the
    kernel tolerance of the plain version."""
    from tpustomp_torch.world.edt import IncrementalSDF

    robot = tmodel.arm_7dof().to(cuda_device)
    inc, _, _ = _patched_tabletop(cuda_device)
    fresh = IncrementalSDF(inc.occ, inc.origin, inc.resolution,
                           inc.max_distance, device=cuda_device)
    C, T, per = (4000, 102, None) if kind == "grid" else (4200, 52, 21)

    def world(field):
        if kind == "grid":
            return field.as_world()
        rows = _row_world("analytic", C // per, 5, ns=1, nx=0)
        return CompositeWorld(grid=field.as_world(),
                              overlay=rows.to(cuda_device))

    cand = _cands(robot, C, T, 17, cuda_device)
    kw = dict(cands_per_row=per)
    variant = ("rollout_grid" if kind == "grid"
               else "rollout_grid:per_cand_overlay")
    before = tr.LAUNCHES[variant]
    q_k, m_k = tr.obstacle_cost_batch(robot, world(inc), cand, 0.05, 0.05,
                                      **kw)
    q_f, m_f = tr.obstacle_cost_batch(robot, world(fresh), cand, 0.05, 0.05,
                                      **kw)
    assert tr.LAUNCHES[variant] == before + 2
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world(inc), cand, 0.05,
                                            0.05, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q_k, q_f) and torch.equal(m_k, m_f)
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)


@pytest.mark.cuda
def test_plan_sharded_world_size_1_equals_plan_batch_on_card(cuda_device):
    from tpustomp_torch import plan_sharded
    from tpustomp_torch.engine import distributed

    cfg = _slice_config("stomp")
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(**_WORLDS["boxes"])
    prob = ProblemSpec(*_jittered(16, 3))
    ref = plan_batch(robot, world, prob, cfg,
                     generator=torch.Generator(cuda_device).manual_seed(4))
    got = plan_sharded(
        robot, world, prob, cfg,
        generator=torch.Generator(cuda_device).manual_seed(4))
    assert got.trajectory.device.type == "cuda"
    for f in ("trajectory", "success", "iterations", "cost"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    s = distributed.summarize(got)
    assert s["num_scenarios"] == 16
    assert s["success_rate"] == float(ref.success.double().mean())


@pytest.mark.cuda
def test_cli_config2_on_card(cuda_device):
    """`python -m tpustomp_torch configs/config2_tabletop.yaml` plans on
    the card (no --device) and names it."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "tpustomp_torch",
         os.path.join(repo, "configs", "config2_tabletop.yaml")],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["success"] is True
    assert out["device"] == torch.cuda.get_device_name(0)


# The lane plan's edges: waypoint counts around the 30 owned lanes of a
# window, and a ragged batch large enough that the plan takes 8 candidates a
# block, so windows cross candidate boundaries.
_EDGE_C = 4229


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["analytic_shared", "grid_shared"])
@pytest.mark.parametrize("T", [2, 3, 31, 32, 33, 101, 102, 103])
def test_lane_plan_edges_match_plain(cuda_device, kind, T):
    """K3 and K5 with their :ee forms, on the static and the runtime chain,
    at the lane plan's edges: q_obs, margin and ee against the plain
    version; a masked third (with single candidates inside a block) writes
    zeros and leaves the other rows bit for bit as the unmasked launch."""
    assert tr._plan(_EDGE_C, T, 7)[0] > 1
    robot = tmodel.arm_7dof().to(cuda_device)
    runtime = dataclasses.replace(robot, joint_static=None)
    world = _edge_world(kind, 1, T).to(cuda_device)
    cand = _cands(robot, _EDGE_C, T, T, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    dt = 5.0 / (T - 1)
    q_p, m_p, ee_p = tr.obstacle_cost_batch_plain(robot, world, cand, dt,
                                                  0.05, want_ee=True)
    active = torch.rand(_EDGE_C, generator=torch.Generator().manual_seed(T)
                        ).to(cuda_device) > 0.33
    active[[0, 9, 17, _EDGE_C - 1]] = False
    for r in (robot, runtime):
        q_k, m_k = tr.obstacle_cost_batch(r, world, tm, dt, 0.05,
                                          time_major=True)
        torch.testing.assert_close(q_k, q_p, **Q_TOL)
        torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
        q_a, m_a, ee = tr.obstacle_cost_batch(r, world, tm, dt, 0.05,
                                              row_active=active,
                                              time_major=True, want_ee=True)
        assert torch.equal(q_a[active], q_k[active])
        assert torch.equal(m_a[active], m_k[active])
        assert bool((q_a[~active] == 0).all())
        assert bool((m_a[~active] == 0).all())
        torch.testing.assert_close(ee[:, :, active], ee_p[:, :, active],
                                   rtol=1e-5, atol=2e-5)
        assert bool((ee[:, :, ~active] == 0).all())


def _above_the_block(case, device):
    """(robot, world) whose parameters do not fit the kernel's parameter
    block (200 spheres beside the tabletop boxes, shared or as a grid's
    overlay; 210 robot bodies), or whose robot has no host copies (bodies
    shuffled on the card)."""
    rng = np.random.default_rng(3)
    spheres = [(tuple(rng.uniform(-0.8, 0.8, 3)), rng.uniform(0.05, 0.2))
               for _ in range(200)]
    big = AnalyticWorld.make(spheres=spheres, boxes=_WORLDS["boxes"]["boxes"])
    robot = tmodel.arm_7dof()
    if case == "world":
        world = big
    elif case == "overlay":
        world = CompositeWorld(_voxel_world("grid"), big)
    else:
        world = AnalyticWorld.make(**_WORLDS["boxes"])
    if case == "robot":
        robot = dataclasses.replace(tmodel.arm_7dof(spheres_per_link=70),
                                    joint_static=None)
    robot, world = robot.to(device), world.to(device)
    if case == "device_made":
        robot = _shuffled(robot, 0)
    return robot, world


# The parameter route each case of _above_the_block takes: the large
# block above the 3 KB one, and a robot built on the card the 3 KB block
# from its second launch, by one read of its device-packed vector (its
# first takes the memory path; kernels/rollout.py param_route,
# _launch_params).
_ROUTE_OF = {"world": "large_block", "overlay": "large_block",
             "robot": "large_block", "device_made": "block"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["world", "overlay", "robot", "device_made"])
def test_memory_path_matches_plain(cuda_device, case):
    """The routes that once took the memory path (a robot or world above
    the parameter block, a robot without host copies), against the plain
    version, with ee and a masked third: every launch is counted on the
    large block, or for the robot built on the card the first on the
    memory path and the second on the block after one read of its device
    vector, bitwise the first on the rows both compute."""
    robot, world = _above_the_block(case, cuda_device)
    C, T = _EDGE_C, 33
    cand = _cands(robot, C, T, 4, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    q_p, m_p, ee_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.15,
                                                  0.05, want_ee=True)
    tr.reset_launches()
    q_k, m_k = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                      time_major=True)
    q_a, m_a, ee = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                          row_active=active, time_major=True,
                                          want_ee=True)
    device = int(case == "device_made")
    routes = {"block": 0, "large_block": 0, "memory": device}
    routes[_ROUTE_OF[case]] += 2 - device
    assert tr.PARAM_ROUTES == routes
    assert tr.PARAM_READS["device"] == device
    torch.cuda.synchronize()
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
    assert torch.equal(q_a[active], q_k[active])
    assert bool((q_a[~active] == 0).all()) and bool((m_a[~active] == 0).all())
    torch.testing.assert_close(ee[:, :, active], ee_p[:, :, active],
                               rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
def test_main_path_takes_the_parameter_block(cuda_device):
    """A robot and world moved to the card with .to() launch with the
    parameter block on every variant, and a world updated in place since
    (its host copy is stale) launches on the memory path once, then on the
    block after one read of its device vector, with the new values."""
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    grid = _voxel_world("grid").to(cuda_device)
    rows = _row_world("analytic", 13, 2, ns=1, nx=2).to(cuda_device)
    cand = _cands(robot, 273, 52, 1, cuda_device)
    tr.reset_launches()
    for w, per in ((world, None), (grid, None), (rows, 21)):
        tr.obstacle_cost_batch(robot, w, cand, 0.1, 0.05, cands_per_row=per)
    assert tr.PARAM_ROUTES == {"block": 3, "large_block": 0, "memory": 0}
    assert tr.PARAM_READS["device"] == 0
    q_b, _ = tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
    world.box_half.mul_(1.5)
    q_m, _ = tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
    assert tr.PARAM_ROUTES == {"block": 4, "large_block": 0, "memory": 1}
    assert tr.PARAM_READS["device"] == 0
    q_r, _ = tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
    q_p, _ = tr.obstacle_cost_batch_plain(robot, world, cand, 0.1, 0.05)
    assert tr.PARAM_ROUTES == {"block": 5, "large_block": 0, "memory": 1}
    assert tr.PARAM_READS["device"] == 1
    torch.testing.assert_close(q_r, q_p, **Q_TOL)
    assert torch.equal(q_r, q_m) and not torch.equal(q_r, q_b)


@pytest.mark.cuda
def test_occupancy_query_launches_nothing(cuda_device):
    """rollout_occupancy gives the resident blocks per SM of the kernel a
    launch would take (at least its __launch_bounds__ minimum: 4 for K3 on
    arm_7dof's chain with the parameter block), and launches and counts
    nothing."""
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    cand = _cands(robot, 700, 102, 1, cuda_device)
    tr.reset_launches()
    assert tr.rollout_occupancy(robot, world, cand, 0.05, 0.05) >= 4
    assert sum(tr.LAUNCHES.values()) == 0
    assert tr.PARAM_ROUTES == {"block": 0, "large_block": 0, "memory": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["made_on_card:world", "made_on_card:robot",
                                   "changed_in_place", "above_block:world",
                                   "above_large_block"])
def test_occupancy_query_reads_no_device_value(cuda_device, label,
                                              monkeypatch):
    """The occupancy query of a set without host copies, or above either
    block, takes its route from shapes alone: it packs nothing on the
    device (pack_params is made to fail), reads no device vector
    (PARAM_READS) and counts no launch; the set's first launch after it
    reads nothing either, its second makes the set's one read."""
    robot, world = _trigger(label, cuda_device)
    cand = _cands(robot, 700, 52, 1, cuda_device)
    tr.reset_launches()

    def no_pack(*args, **kwargs):
        raise AssertionError("the occupancy query packed the parameters")

    with monkeypatch.context() as m:
        m.setattr(tr, "pack_params", no_pack)
        blocks = tr.rollout_occupancy(robot, world, cand, 0.1, 0.05)
    assert blocks >= 2
    assert tr.PARAM_READS["device"] == 0
    assert sum(tr.LAUNCHES.values()) == 0
    tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
    assert tr.PARAM_READS["device"] == 0
    tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
    assert tr.PARAM_READS["device"] == _TRIGGER_ROUTE[label][1]


# The constraint route (:con): the cone of chip_smoke.py phase 8 and a
# tool-point target, alone and together
_CON_KINDS = ("orientation", "position", "both")


def _con_constraints(kind, device):
    from tpustomp_torch import PositionConstraint

    cons = []
    if kind in ("orientation", "both"):
        cons.append(OrientationConstraint.make(tolerance=0.25, weight=0.3))
    if kind in ("position", "both"):
        cons.append(PositionConstraint.make((0.7, 0.1, 0.9), tolerance=0.05,
                                            weight=2.0))
    return tuple(c.to(device) for c in cons)


def _check_con(robot, world, cand, tm, dt, cons, active, per, q_con, q, m,
               ee):
    """q_con of one :con launch against the plain tail on the same launch's
    :ee frame ee (rtol 1e-5, atol 1e-6 per unit of weight: only acosf
    differs) and against the plain version on fk_frames, within the bound
    derived from the ee gate (chip_smoke.py q_con_tolerance); zeros on
    masked rows; q_obs/margin (q, m) bitwise the launch without
    constraints."""
    from chip_smoke import (CON_ATOL_PER_WEIGHT, CON_RTOL,
                            q_con_tolerance)
    from tpustomp_torch.costs.constraints import constraint_cost_tm

    kw = dict(row_active=active, time_major=True, cands_per_row=per)
    q0, m0 = tr.obstacle_cost_batch(robot, world, tm, dt, 0.05, **kw)
    assert torch.equal(q, q0) and torch.equal(m, m0)
    own = constraint_cost_tm(robot, cons, ee)
    torch.testing.assert_close(
        q_con[active], own[active], rtol=CON_RTOL,
        atol=CON_ATOL_PER_WEIGHT * sum(float(c.weight) for c in cons))
    _, _, ee_p = tr.obstacle_cost_batch_plain(robot, world, cand, dt, 0.05,
                                              cands_per_row=per, want_ee=True)
    ref = constraint_cost_tm(robot, cons, ee_p)
    tol = q_con_tolerance(robot, cons, ee_p)
    assert bool(((q_con - ref).abs() <= tol)[active].all())
    assert bool((q_con[~active] == 0).all())
    assert float(ref[active].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _CON_KINDS)
@pytest.mark.parametrize("variant", sorted(_EE_WORLDS))
def test_con_variants_match_plain(cuda_device, variant, kind):
    """The :con form of every variant at its main path's shape (config 4's
    C = 57,344 x T = 102 for a shared world, config 5's 210,000 x 52 for
    per-row worlds), a third of the rows masked, on the static and the
    runtime chain (each launch counted under its own name): _check_con."""
    robot = tmodel.arm_7dof().to(cuda_device)
    runtime = dataclasses.replace(robot, joint_static=None)
    per5 = 21
    if variant.endswith(("per_cand_world", "per_cand_overlay")):
        C, T, per = 210000, 52, per5
        world = _row_world(_EE_WORLDS[variant], C // per, 7, ns=1,
                           nx=2).to(cuda_device)
    else:
        C, T, per = 57344, 102, None
        world = (AnalyticWorld.make(**_WORLDS["boxes"])
                 if variant == "rollout_analytic"
                 else _voxel_world("grid")).to(cuda_device)
    cons = _con_constraints(kind, cuda_device)
    cand = _cands(robot, C, T, 12, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    kw = dict(row_active=active, time_major=True, cands_per_row=per)
    for r, name in ((robot, variant + ":con"),
                    (runtime, variant + ":runtime:con")):
        before = dict(tr.LAUNCHES)
        q, m, q_con = tr.obstacle_cost_batch(r, world, tm, 0.05, 0.05,
                                             constraints=cons, **kw)
        ran = {k: tr.LAUNCHES[k] - before[k] for k in before
               if tr.LAUNCHES[k] != before[k]}
        assert ran == {name: 1}, ran
        _, _, ee = tr.obstacle_cost_batch(r, world, tm, 0.05, 0.05,
                                          want_ee=True, **kw)
        _check_con(r, world, cand, tm, 0.05, cons, active, per, q_con, q, m,
                   ee)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["world", "robot", "device_made",
                                  "constraint_made_on_card"])
def test_con_memory_path_matches_plain(cuda_device, case):
    """The :con form on the routes that once took the memory path (a robot
    or world above the parameter block: the large block; a robot without
    host copies, or a constraint made on the card: the memory path at the
    first launch, then the block from one read of the device vector,
    bitwise the first): every launch on that route, _check_con's checks."""
    if case == "constraint_made_on_card":
        robot = tmodel.arm_7dof().to(cuda_device)
        world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
        cons = _con_constraints("both", cuda_device)
        cons = (dataclasses.replace(cons[0], weight=cons[0].weight.clone()),
                cons[1])
    else:
        robot, world = _above_the_block(case, cuda_device)
        cons = _con_constraints("both", cuda_device)
    C, T = _EDGE_C, 33
    cand = _cands(robot, C, T, 4, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    tr.reset_launches()
    first = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                   row_active=active, time_major=True,
                                   constraints=cons)
    q, m, q_con = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                         row_active=active, time_major=True,
                                         constraints=cons)
    device = int(case in ("device_made", "constraint_made_on_card"))
    routes = {"block": 0, "large_block": 0, "memory": device}
    routes[_ROUTE_OF.get(case, "block")] += 2 - device
    assert tr.PARAM_ROUTES == routes
    assert tr.PARAM_READS["device"] == device
    assert sum(v for k, v in tr.LAUNCHES.items() if k.endswith(":con")) == 2
    assert all(torch.equal(a, b) for a, b in zip(first, (q, m, q_con)))
    _, _, ee = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                      row_active=active, time_major=True,
                                      want_ee=True)
    _check_con(robot, world, cand, tm, 0.15, cons, active, None, q_con, q,
               m, ee)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 3, 31, 33, 101, 103])
def test_con_lane_plan_edges_and_planar_2r(cuda_device, T):
    """The :con form at the lane plan's edges (a ragged C, a masked third)
    for arm_7dof on both tabletops, and for planar_2r (a cone on its first
    link axis, a tool-point target): _check_con's checks."""
    from tpustomp_torch import PositionConstraint

    for robot, cons in (
            (tmodel.arm_7dof(), _con_constraints("both", "cpu")),
            (tmodel.planar_2r(), (
                OrientationConstraint.make((1, 0, 0), (0.6, 0.8, 0.0), 0.3,
                                           0.7),
                PositionConstraint.make((1.0, 1.0, 0.0), 0.05, 1.5)))):
        robot = robot.to(cuda_device)
        cons = tuple(c.to(cuda_device) for c in cons)
        cand = _cands(robot, _EDGE_C, T, 9, cuda_device)
        tm = cand.permute(2, 1, 0).contiguous()
        active = torch.ones(_EDGE_C, dtype=torch.bool, device=cuda_device)
        active[::3] = False
        for world in (AnalyticWorld.make(**_WORLDS["boxes"]),
                      _voxel_world("grid")):
            world = world.to(cuda_device)
            kw = dict(row_active=active, time_major=True)
            q, m, q_con = tr.obstacle_cost_batch(robot, world, tm, 0.05, 0.05,
                                                 constraints=cons, **kw)
            _, _, ee = tr.obstacle_cost_batch(robot, world, tm, 0.05, 0.05,
                                              want_ee=True, **kw)
            _check_con(robot, world, cand, tm, 0.05, cons, active, None,
                       q_con, q, m, ee)


@pytest.mark.cuda
def test_con_route_plans_as_without_ee(cuda_device):
    """The route's launch takes the lane plan without ee (7 candidates at
    T = 102) and 4 resident blocks an SM at config 4, where the :ee form
    takes 8 candidates and fewer blocks; no launch is counted."""
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    cons = _con_constraints("orientation", cuda_device)
    cand = _cands(robot, 57344, 102, 1, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    tr.reset_launches()
    blocks = {k: tr.rollout_occupancy(robot, world, tm, 0.05, 0.05,
                                      time_major=True, **kw)
              for k, kw in (("none", {}), ("con", dict(constraints=cons)),
                            ("ee", dict(want_ee=True)))}
    assert blocks["con"] == blocks["none"] >= 4 > blocks["ee"], blocks
    assert sum(tr.LAUNCHES.values()) == 0


# Every way a launch's parameters leave the 3 KB block of a robot and world
# moved with .to() (chip_smoke.py param_triggers), a world above the large
# block too, and the route each takes, with the device reads it makes on
# its first launch (none on the second).
_TRIGGER_ROUTE = {"above_block:world": ("large_block", 0),
                  "above_block:robot": ("large_block", 0),
                  "made_on_card:world": ("block", 1),
                  "made_on_card:robot": ("block", 1),
                  "changed_in_place": ("block", 1),
                  "inference_mode": ("memory", 0),
                  "above_large_block": ("memory", 0)}


def _trigger(label, device):
    from chip_smoke import big_world, param_triggers

    robot = tmodel.arm_7dof().to(device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(device)
    if label == "above_large_block":
        from chip_smoke import ABOVE_LARGE_SPHERES

        return robot, big_world(world, n=ABOVE_LARGE_SPHERES)
    return {k: (r, w) for k, r, w in param_triggers(robot, world)}[label]


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(_TRIGGER_ROUTE))
def test_param_triggers_match_plain(cuda_device, label):
    """Each trigger on its route (PARAM_ROUTES, PARAM_READS; a set without
    host copies on the memory path at its first launch, the time-major
    one) against the plain version in both layouts, with a masked third;
    the candidate-major launch bitwise the time-major one."""
    robot, world = _trigger(label, cuda_device)
    route, reads = _TRIGGER_ROUTE[label]
    assert tr.param_route(robot, world) == route
    # the plain version holds a [C·T·12, spheres] distance table
    C, T = (512 if label == "above_large_block" else _EDGE_C), 33
    cand = _cands(robot, C, T, 5, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[::3] = False
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.15, 0.05)
    tr.reset_launches()
    q_k, m_k = tr.obstacle_cost_batch(robot, world, tm, 0.15, 0.05,
                                      time_major=True)
    q_c, m_c = tr.obstacle_cost_batch(robot, world, cand, 0.15, 0.05)
    q_a, m_a = tr.obstacle_cost_batch(robot, world, cand, 0.15, 0.05,
                                      row_active=active)
    first = int(reads == 1)
    routes = {"block": 0, "large_block": 0, "memory": first}
    routes[route] += 3 - first
    assert tr.PARAM_ROUTES == routes
    assert tr.PARAM_READS["device"] == reads
    assert tr.LAYOUTS == {"time_major": 1, "candidate_major": 2}
    torch.testing.assert_close(q_k, q_p, **Q_TOL)
    torch.testing.assert_close(m_k, m_p, atol=M_ATOL, rtol=0)
    assert torch.equal(q_c, q_k) and torch.equal(m_c, m_k)
    assert torch.equal(q_a[active], q_k[active])
    assert bool((q_a[~active] == 0).all()) and bool((m_a[~active] == 0).all())


@pytest.mark.cuda
def test_device_made_world_changed_in_place_gets_new_result(cuda_device):
    """A world built on the card, launched twice (the memory path, then
    the block after one read), changed in place, launched twice again: the
    new version's launches get the new values (a second device read),
    never the first version's block; each version's two launches are
    bitwise equal."""
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    world = dataclasses.replace(world, box_half=world.box_half.clone())
    cand = _cands(robot, 700, 52, 2, cuda_device)
    tr.reset_launches()
    q_1 = [tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
           for _ in range(2)]
    world.box_half.mul_(1.5)
    q_2 = [tr.obstacle_cost_batch(robot, world, cand, 0.1, 0.05)
           for _ in range(2)]
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.1, 0.05)
    assert tr.PARAM_READS["device"] == 2
    assert tr.PARAM_ROUTES == {"block": 2, "large_block": 0, "memory": 2}
    for q, m in q_2:
        torch.testing.assert_close(q, q_p, **Q_TOL)
        torch.testing.assert_close(m, m_p, atol=M_ATOL, rtol=0)
    for a, b in (q_1, q_2):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(q_1[1][0], q_2[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rollout_analytic", "rollout_grid",
                                     "rollout_analytic:per_cand_world",
                                     "rollout_grid:per_cand_overlay"])
@pytest.mark.parametrize("C,T", [(1024, 102), (4229, 33), (37, 2)])
def test_candidate_major_equals_time_major(cuda_device, variant, C, T):
    """K4: the candidate-major launch's q_obs and margin (and with
    constraints q_con) are bitwise the time-major launch's on the same
    candidates, on both chains, for both sources, with a masked third;
    against plain; and on a shared world it launches the evaluator and
    runs no other op on the card but allocations and views (no layout
    copy before it; a per-row world's launch also concatenates its
    primitive rows)."""
    robot = tmodel.arm_7dof().to(cuda_device)
    per = 1 if variant.endswith(("world", "overlay")) else None
    if per is None:
        world = (AnalyticWorld.make(**_WORLDS["boxes"])
                 if variant == "rollout_analytic" else _voxel_world("grid"))
    else:
        world = _row_world("analytic" if "analytic" in variant
                           else "composite", C, 3, ns=1)
    world = world.to(cuda_device)
    cand = _cands(robot, C, T, C + T, cuda_device)
    tm = cand.permute(2, 1, 0).contiguous()
    active = torch.ones(C, dtype=torch.bool, device=cuda_device)
    active[1::3] = False
    cons = _con_constraints("both", cuda_device)
    q_p, m_p = tr.obstacle_cost_batch_plain(robot, world, cand, 0.15, 0.05,
                                            cands_per_row=per)
    for r in (robot, dataclasses.replace(robot, joint_static=None)):
        for kw in ({}, dict(row_active=active), dict(constraints=cons)):
            a = tr.obstacle_cost_batch(r, world, tm, 0.15, 0.05,
                                       time_major=True, cands_per_row=per,
                                       **kw)
            b = tr.obstacle_cost_batch(r, world, cand, 0.15, 0.05,
                                       cands_per_row=per, **kw)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (r, kw)
        torch.testing.assert_close(b[0], q_p, **Q_TOL)
        torch.testing.assert_close(b[1], m_p, atol=M_ATOL, rtol=0)
    if per is not None:
        return
    before = sum(tr.LAUNCHES.values())
    _, ops = device_ops(lambda: tr.obstacle_cost_batch(
        robot, world, cand, 0.15, 0.05), "cuda")
    assert sum(tr.LAUNCHES.values()) == before + 1
    assert set(ops) <= NO_KERNEL_OPS, ops


@pytest.mark.cuda
def test_two_streams_with_device_made_worlds(cuda_device):
    """Two worlds built on the card, each launched on its own stream at
    the same time: each result bitwise its own single-stream launch (each
    launch carries its parameters by value, read once per world at its
    second launch; the first, on the memory path, bitwise too)."""
    robot = tmodel.arm_7dof().to(cuda_device)
    base = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    worlds = [dataclasses.replace(base, box_half=base.box_half * f)
              for f in (1.0, 1.4)]
    cand = _cands(robot, 20000, 102, 7, cuda_device)
    first = [tr.obstacle_cost_batch(robot, w, cand, 0.05, 0.05)
             for w in worlds]
    ref = [tr.obstacle_cost_batch(robot, w, cand, 0.05, 0.05)
           for w in worlds]
    torch.cuda.synchronize()
    for got, want in zip(first, ref):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    streams = [torch.cuda.Stream(cuda_device) for _ in worlds]
    outs = [None, None]
    for _ in range(3):
        for i, (w, st) in enumerate(zip(worlds, streams)):
            st.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(st):
                outs[i] = tr.obstacle_cost_batch(robot, w, cand, 0.05, 0.05)
        torch.cuda.synchronize()
        for got, want in zip(outs, ref):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert not torch.equal(ref[0][0], ref[1][0])


# --- the solver loop's CUDA graphs (engine/graph.py) ------------------------

def _graph_config(kind):
    """Config 4's step at a test's size (N = 100, K = 50, reuse 5), or the
    slice's CHOMP / HMC steps, for the graphed-vs-eager comparisons."""
    if kind in ("chomp", "hmc"):
        return _slice_config(kind).replace(max_iterations=12)
    if kind == "chomp_exact_torque":      # autograd inside the capture
        return _slice_config("chomp").replace(
            max_iterations=12, chomp_gradient_mode="exact",
            weights=CostWeights(obstacle=20.0, smoothness=0.1, torque=0.005))
    base = PlannerConfig(num_timesteps=100, duration=5.0, num_rollouts=50,
                         noise=NoiseConfig(stddev=0.08, decay=0.995,
                                           num_rollouts_reused=5),
                         weights=CostWeights(obstacle=1.0, smoothness=0.1),
                         collision_clearance=0.05, max_iterations=12,
                         max_iterations_after_collision_free=3)
    if kind == "smooth":
        return base.replace(rollout_limit_projection="smooth")
    if kind == "compaction":
        return base.replace(batch_compaction="on", compaction_chunk=2,
                            compaction_min_bucket=1)
    return base


def _assert_bitwise(got, ref):
    """Every field of two Solutions bitwise equal."""
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            _assert_bitwise(a, b)
        elif b is not None:
            assert torch.equal(a, b), f.name


def _on_card(robot, world, device):
    return robot.to(device), world.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["box", "voxel", "composite", "constrained",
                                  "smooth", "compaction", "chomp", "hmc",
                                  "chomp_exact_torque"])
def test_graphed_plan_batch_is_bitwise_eager(cuda_device, case):
    """plan_batch replaying the graph of one iteration (a capture at the
    first call, a cache hit at the second) against the eager loop under the
    same generator: trajectory, cost, iterations, success and metrics
    bitwise; the counters after each graphed run equal the eager run's."""
    from tpustomp_torch.engine import graph

    world = (AnalyticWorld.make(**_WORLDS["boxes"]) if case not in (
        "voxel", "composite") else _voxel_world(
            "grid" if case == "voxel" else "composite"))
    robot, world = _on_card(tmodel.arm_7dof(), world, cuda_device)
    cfg = _graph_config(case)
    kw = {}
    if case == "constrained":
        kw["constraints"] = OrientationConstraint.make(
            axis_local=(0, 0, 1), target_world=(0, 0, 1), tolerance=0.25,
            weight=0.3).to(cuda_device)
    prob = ProblemSpec(*_jittered(64, 3))

    def run():
        tr.reset_launches()
        sol = plan_batch(robot, world, prob, cfg, generator=torch.Generator(
            cuda_device).manual_seed(0), **kw)
        torch.cuda.synchronize()
        return sol, [dict(c) for c in graph._COUNTERS]

    with graph.eager():
        ref, counts = run()
    graph.reset_counts()
    for _ in range(2):
        got, got_counts = run()
        _assert_bitwise(got, ref)
        assert got_counts == counts
    assert graph.GRAPHS["replayed"] > 0 and graph.GRAPHS["captured"] >= 1
    assert not any(k.startswith("eager:") and k != "eager:first_iteration"
                   for k in graph.GRAPHS), dict(graph.GRAPHS)


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["tune", "stream"])
def test_graphed_tune_and_stream_are_bitwise_eager(cuda_device, api):
    """tune (one batched solve with HyperParams rows) and
    plan_batch_stream at depth 2 replay graphs and give the eager loop's
    results bitwise."""
    from tpustomp_torch import plan_batch_stream, tune
    from tpustomp_torch.engine import graph

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config("box")
    probs = [ProblemSpec(*_jittered(16, s)) for s in range(3)]

    def run():
        if api == "tune":
            return tune(robot, world, probs[0], cfg).table
        items = [(p, torch.Generator(cuda_device).manual_seed(s))
                 for s, p in enumerate(probs)]
        return list(plan_batch_stream(robot, world, items, cfg, depth=2))

    with graph.eager():
        ref = run()
    graph.reset_counts()
    got = run()
    assert graph.GRAPHS["replayed"] > 0
    if api == "tune":
        assert got == ref
    else:
        for (t, s), (tr_, sr) in zip(got, ref):
            assert np.array_equal(t, tr_) and np.array_equal(s, sr)


@pytest.mark.cuda
def test_graph_of_a_world_changed_in_place_is_new(cuda_device):
    """A world changed in place by a torch op between two calls moves its
    version: its new values are loaded into the cached graph's copy and
    the captured nodes' parameter blocks are rewritten (no capture), and
    the result is the eager loop's on the changed world."""
    from tpustomp_torch.engine import graph

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config("box")
    prob = ProblemSpec(*_jittered(64, 5))

    def run():
        return plan_batch(robot, world, prob, cfg, generator=torch.Generator(
            cuda_device).manual_seed(0))

    before = run()
    world.box_half.mul_(1.25)
    graph.reset_counts()
    got = run()
    assert graph.GRAPHS["invalidated"] == 0
    assert graph.GRAPHS["captured"] == 0
    assert graph.GRAPHS["inputs_loaded"] == 1
    assert graph.GRAPHS["node_updates"] > 0
    with graph.eager():
        _assert_bitwise(got, run())
    assert not torch.equal(got.cost, before.cost)


@pytest.mark.cuda
def test_graph_of_a_device_made_world_makes_no_read(cuda_device,
                                                    monkeypatch):
    """A world built on the card has no host copies: its first launch
    defers its one device read, the second eager iteration makes it
    ("param_read"), and the capture after makes none; the graph holds the
    parameter block (no memory-path launch in a replay), as the eager
    loop does from its second iteration, and the solve is the eager
    loop's."""
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    host = AnalyticWorld.make(**_WORLDS["boxes"])
    world = AnalyticWorld(*(v.to(cuda_device) * 1.0
                            for v in (host.sphere_center, host.sphere_radius,
                                      host.box_center, host.box_half)))
    reads = []
    real = graph._capture

    def watched(body, stream, generator=None):
        before = dict(tr.PARAM_READS)
        out = real(body, stream, generator)
        reads.append({k: tr.PARAM_READS[k] - before[k] for k in before})
        return out

    monkeypatch.setattr(graph, "_capture", watched)
    cfg = _graph_config("box")
    prob = ProblemSpec(*_jittered(64, 6))
    graph.clear()
    graph.reset_counts()
    tr.reset_launches()
    got = plan_batch(robot, world, prob, cfg, generator=torch.Generator(
        cuda_device).manual_seed(0))
    assert reads == [{"device": 0, "deferred": 0}] * 3
    assert tr.PARAM_READS["device"] == 1
    assert graph.GRAPHS["eager:param_read"] == 1
    (g,) = graph._CACHE.values()
    per_replay = g.loop.per_it[1]       # PARAM_ROUTES, a chunk iteration
    assert per_replay["memory"] == 0 and per_replay["block"] > 0
    with graph.eager():
        ref = plan_batch(robot, world, prob, cfg, generator=torch.Generator(
            cuda_device).manual_seed(0))
    _assert_bitwise(got, ref)


@pytest.mark.cuda
def test_host_objects_share_one_graph(cuda_device):
    """A robot, world and cone built on the CPU anew at every call, with
    device="cuda" (the README's form): the entry point hands the solver
    one device copy of equal objects, so the first call captures and the
    next ones replay that graph, with the eager loop's results."""
    from tpustomp_torch.engine import graph

    cfg = _graph_config("box")
    prob = ProblemSpec(*_jittered(32, 9))

    def run():
        cone = OrientationConstraint.make(
            axis_local=(0, 0, 1), target_world=(0, 0, 1), tolerance=0.25,
            weight=0.3)
        return plan_batch(tmodel.arm_7dof(),
                          AnalyticWorld.make(**_WORLDS["boxes"]), prob, cfg,
                          device=cuda_device, constraints=cone,
                          generator=torch.Generator(cuda_device).manual_seed(
                              0))

    with graph.eager():
        ref = run()
    graph.clear()
    graph.reset_counts()
    for _ in range(3):
        _assert_bitwise(run(), ref)
    assert graph.GRAPHS["captured"] == 3, dict(graph.GRAPHS)
    assert graph.GRAPHS["eager:first_iteration"] == 1, dict(graph.GRAPHS)
    assert len(graph.cached()) == 1


@pytest.mark.cuda
def test_graph_shared_by_two_streams_stays_ordered(cuda_device):
    """Two threads, each on a stream of its own, solve different problems
    through one graph (one key): each loads the static buffers only after
    the other's last use, so every result is its problem's eager one."""
    import threading

    from tpustomp_torch.engine import graph

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config("box")
    probs = [ProblemSpec(*_jittered(64, s)) for s in (11, 12)]

    def run(prob):
        return plan_batch(robot, world, prob, cfg, generator=torch.Generator(
            cuda_device).manual_seed(0))

    with graph.eager():
        refs = [run(p) for p in probs]
    run(probs[0])                                   # the capture
    graph.reset_counts()
    errors = []

    def worker(i):
        stream = torch.cuda.Stream(cuda_device)
        try:
            with torch.cuda.stream(stream):
                for _ in range(4):
                    sol = run(probs[i])
                    stream.synchronize()
                    _assert_bitwise(sol, refs[i])
        except BaseException as e:                  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert graph.GRAPHS["captured"] == 0 and graph.GRAPHS["replayed"] > 0


@pytest.mark.cuda
def test_graphed_solution_survives_the_next_replay(cuda_device):
    """A Solution is the solve's own: a second call that replays the same
    graph on other problems leaves the first call's fields unchanged."""
    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config("box")

    def run(seed):
        return plan_batch(robot, world, ProblemSpec(*_jittered(64, seed)),
                          cfg, generator=torch.Generator(
                              cuda_device).manual_seed(seed))

    first = run(7)
    kept = [first.trajectory.clone(), first.iterations.clone(),
            first.metrics.total_cost.clone()]
    run(8)
    torch.cuda.synchronize()
    assert torch.equal(first.trajectory, kept[0])
    assert torch.equal(first.iterations, kept[1])
    assert torch.equal(first.metrics.total_cost, kept[2])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 4])
def test_solution_to_the_host_is_pinned_and_bitwise(cuda_device, B):
    """Solution.to("cpu") from the card copies a batch's answer (B = 512:
    1.5 MB) through page-locked memory and one query's few KB (B = 4)
    pageable: every field, the nested metrics too, bitwise the pageable
    copy of each tensor, pinned where the answer is large."""
    from tpustomp_torch._tensors import PINNED_MIN_BYTES, to_device

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    sol = plan_batch(robot, world, ProblemSpec(*_jittered(B, 3)),
                     _graph_config("box"),
                     generator=torch.Generator(cuda_device).manual_seed(3))
    pinned = sol.trajectory.numel() * 4 >= PINNED_MIN_BYTES
    assert pinned == (B == 512)
    host, pageable = sol.to("cpu"), to_device(sol, "cpu")
    fields = [(host, pageable)]
    while fields:
        a, b = fields.pop()
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert x.device.type == "cpu", f.name
                assert x.is_pinned() == pinned, f.name
                assert x.dtype == y.dtype and torch.equal(x, y), f.name
            elif dataclasses.is_dataclass(x):
                fields.append((x, y))
    assert host.metrics is not None


# --- the MPC tick's CUDA graphs (engine/mpc.py _Tick) ----------------------

def _config5(B, seed=0):
    """Config 5's planner (configs/config5_mpc.yaml: N = 50, K = 16 + 4
    reused, 8 iterations a tick) and B of its scenarios, seeded as
    bench/mpc_bench.py:64-85 (one sphere each at 0.2 m/s)."""
    cfg = PlannerConfig(num_timesteps=50, duration=3.0, num_rollouts=16,
                        pi2_h=20.0, noise=NoiseConfig(
                            stddev=0.25, decay=1.0, num_rollouts_reused=4),
                        collision_clearance=0.05, max_iterations=8,
                        max_iterations_after_collision_free=2,
                        record_metrics=False)
    rng = np.random.default_rng(seed)
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    centers = np.stack([rng.uniform(0.9, 1.2, B), rng.uniform(-0.6, 0.6, B),
                        rng.uniform(0.3, 0.8, B)], 1)[:, None]
    dirs = rng.normal(size=(B, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    state = tmpc.init_mpc(tmodel.arm_7dof(), cfg,
                          q0 + rng.uniform(-0.03, 0.03, (B, 7)),
                          qN + rng.uniform(-0.03, 0.03, (B, 7)), centers,
                          (-dirs * 0.2)[:, None])
    return cfg, state


def _assert_states_bitwise(got, ref):
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name).cpu(),
                           getattr(ref, f.name).cpu()), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("static", ["none", "box", "voxel"])
def test_mpc_graph_episode_is_bitwise_eager(cuda_device, static):
    """A config-5 episode (B = 64, 6 ticks) replaying its tick's graphs
    (captured in tick 0) against the eager episode under the same
    generator: every MPCState field bitwise, the same kernel counters, a
    second episode captures nothing, and no replay launches a kernel on
    the memory path."""
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    world = {"none": None,
             "box": AnalyticWorld.make(**_WORLDS["boxes"]),
             "voxel": _voxel_world("grid")}[static]
    world = None if world is None else world.to(cuda_device)
    cfg, state = _config5(64)

    def run():
        tr.reset_launches()
        out = tmpc.run_mpc_batch(robot, cfg, state, [0.12], 6, 0.1,
                                 static_world=world, device=cuda_device,
                                 generator=torch.Generator(
                                     cuda_device).manual_seed(0))
        torch.cuda.synchronize()
        return out, [dict(c) for c in graph._COUNTERS]

    graph.clear()
    with graph.eager():
        ref, counts = run()
    variant = _VARIANT["composite" if static == "voxel" else "analytic"]
    assert counts[0][variant] >= 6 * 3    # an iteration or more, 2 K4 a tick
    graph.reset_counts()
    got, got_counts = run()
    _assert_states_bitwise(got, ref)
    assert got_counts == counts
    assert graph.GRAPHS["captured"] == 3 and graph.GRAPHS["replayed"] > 0
    graph.reset_counts()
    again, again_counts = run()
    _assert_states_bitwise(again, ref)
    assert again_counts == counts
    assert again_counts[1]["memory"] == 0
    assert graph.GRAPHS["captured"] == 0
    assert graph.GRAPHS["replayed"] >= 6 * 2 + 6
    assert not any(k.startswith("eager:") for k in graph.GRAPHS)
    (entry,) = graph.cached()
    assert entry["kind"] == "mpc_tick" and entry["pool_bytes"] > 0


@pytest.mark.cuda
def test_mpc_graph_resilient_and_resumed_are_bitwise_eager(cuda_device):
    """run_mpc_resilient recovering corrupted rows by its full-batch
    replay, and an episode resumed midway from its state and generator
    (a checkpoint's contents), both on one cached tick over the voxel
    world: bitwise the eager episode."""
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    grid = _voxel_world("grid").to(cuda_device)
    cfg, state = _config5(32, seed=1)

    def gen():
        return torch.Generator(cuda_device).manual_seed(4)

    def whole():
        return tmpc.run_mpc_batch(robot, cfg, state, [0.12], 6, 0.1,
                                  static_world=grid, device=cuda_device,
                                  generator=gen())

    def fault(chunk_idx, out):
        if chunk_idx == 0:
            out.theta[3] = float("nan")
        return out

    graph.clear()
    with graph.eager():
        ref = whole()
    graph.reset_counts()
    rec = tmpc.run_mpc_resilient(robot, cfg, state, [0.12], 6, 0.1,
                                 chunk_ticks=3, static_world=grid,
                                 device=cuda_device, generator=gen(),
                                 _fault_hook=fault)
    _assert_states_bitwise(rec, ref)
    g = gen()
    mid = tmpc.run_mpc_batch(robot, cfg, state, [0.12], 3, 0.1,
                             static_world=grid, device=cuda_device,
                             generator=g)
    mid = mid.to("cpu").to(cuda_device)
    resumed = tmpc.run_mpc_batch(robot, cfg, mid, [0.12], 3, 0.1,
                                 static_world=grid, device=cuda_device,
                                 generator=g)
    _assert_states_bitwise(resumed, ref)
    assert graph.GRAPHS["captured"] == 3 and graph.GRAPHS["replayed"] > 0


# --- the loop's condition on the device: chunks behind IF nodes -----------

def _three_routes(run):
    """run(generator) eagerly, on the per-iteration route and on the chunk
    route (twice: a capture, then a hit): [(result, generator offset after
    it, GRAPHS)] in that order."""
    from tpustomp_torch.engine import graph

    out = []
    for route in ("eager", "per_iteration", "chunk", "chunk"):
        graph.reset_counts()
        gen = torch.Generator("cuda").manual_seed(0)
        if route == "eager":
            with graph.eager():
                res = run(gen)
        elif route == "per_iteration":
            with graph.per_iteration():
                res = run(gen)
        else:
            res = run(gen)
        torch.cuda.synchronize()
        out.append((res, gen.get_offset(), dict(graph.GRAPHS)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["box", "hmc", "constrained"])
def test_chunk_route_is_bitwise_eager(cuda_device, case):
    """plan_batch (B = 64) on the chunk route: the loop's condition and the
    draws in the graph, against the eager loop and the per-iteration
    route: every Solution field bitwise, the generator's offset after the
    solve equal (the chunk's replays move the graph's own generator, the
    caller's is set where the eager loop leaves it), the kernel counters
    equal; a second chunk call captures nothing and reads the condition
    at most ceil(iterations / CHUNK) + 1 times."""
    from tpustomp_torch.engine import graph

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config(case if case == "hmc" else "box")
    kw = {}
    if case == "constrained":
        kw["constraints"] = OrientationConstraint.make(
            axis_local=(0, 0, 1), target_world=(0, 0, 1), tolerance=0.25,
            weight=0.3).to(cuda_device)
    prob = ProblemSpec(*_jittered(64, 3))
    graph.clear()
    counts = []

    def run(gen):
        tr.reset_launches()
        sol = plan_batch(robot, world, prob, cfg, generator=gen, **kw)
        counts.append([dict(c) for c in graph._COUNTERS])
        return sol

    (ref, off, _), per_it, miss, hit = _three_routes(run)
    assert off > 0
    for sol, o, _ in (per_it, miss, hit):
        _assert_bitwise(sol, ref)
        assert o == off
    assert counts[1] == counts[0] == counts[2] == counts[3]
    assert per_it[2]["per_iteration:requested"] > 0
    g = hit[2]
    assert g["chunk"] > 0 and g.get("captured", 0) == 0
    assert not any(k.startswith(("per_iteration", "eager")) for k in g), g
    assert g["flag_reads"] <= -(-g["chunk"] // graph.CHUNK) + 1


@pytest.mark.cuda
def test_chunk_capture_that_fails_raises(cuda_device, monkeypatch):
    """A body that raises while it is captured into an IF node is an error
    of the solve: nothing falls back to another route, and the next solve
    captures and runs."""
    from tpustomp_torch.engine import graph

    robot, world = _on_card(tmodel.arm_7dof(),
                            AnalyticWorld.make(**_WORLDS["boxes"]),
                            cuda_device)
    cfg = _graph_config("box")
    prob = ProblemSpec(*_jittered(16, 4))
    real = graph.Loop._advance

    def failing(self, draws):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("inside the IF node")
        return real(self, draws)

    graph.clear()
    monkeypatch.setattr(graph.Loop, "_advance", failing)
    with pytest.raises(ValueError, match="inside the IF node"):
        plan_batch(robot, world, prob, cfg)
    assert graph.cached() == []
    monkeypatch.setattr(graph.Loop, "_advance", real)
    graph.reset_counts()
    with graph.eager():
        ref = plan_batch(robot, world, prob, cfg)
    _assert_bitwise(plan_batch(robot, world, prob, cfg), ref)
    assert graph.GRAPHS["chunk"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("static", ["box", "voxel"])
def test_chunk_mpc_episode_is_bitwise_eager(cuda_device, static):
    """A config-5 episode (B = 64, 6 ticks) on chunk ticks against the eager
    episode and the per-iteration ticks: every MPCState field bitwise, the
    generator's offset after it equal, the same kernel counters and draws
    used and padded; a hit reads nothing but the episode's total."""
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    world = (AnalyticWorld.make(**_WORLDS["boxes"]) if static == "box"
             else _voxel_world("grid")).to(cuda_device)
    cfg, state = _config5(64)
    graph.clear()
    seen = []

    def run(gen):
        tr.reset_launches()
        tmpc.NOISE_DRAWS.update(used=0, padded=0)
        out = tmpc.run_mpc_batch(robot, cfg, state, [0.12], 6, 0.1,
                                 static_world=world, device=cuda_device,
                                 generator=gen)
        seen.append(([dict(c) for c in graph._COUNTERS],
                     dict(tmpc.NOISE_DRAWS)))
        return out

    (ref, off, _), per_it, miss, hit = _three_routes(run)
    for out, o, _ in (per_it, miss, hit):
        _assert_states_bitwise(out, ref)
        assert o == off
    assert all(x == seen[0] for x in seen[1:]), seen
    g = hit[2]
    assert g["chunk"] > 0 and g.get("flag_reads", 0) == 0
    assert not any(k.startswith(("per_iteration", "eager")) for k in g), g


@pytest.mark.cuda
def test_chunk_mpc_ticks_make_no_host_read(cuda_device, monkeypatch):
    """Ticks 1..n of an episode (a cached tick's chunks, tick 0 of the
    first episode captures) run under torch.cuda.set_sync_debug_mode(
    "error"): no host read or sync between the episode's load and its
    copy-out. The result is the eager episode's."""
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    cfg, state = _config5(64, seed=2)
    state = state.to(cuda_device)
    real = tmpc._chunk_ticks
    strict = []

    def no_sync(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        strict.append(a[1:3])

    monkeypatch.setattr(tmpc, "_chunk_ticks", no_sync)

    def run():
        return tmpc.run_mpc_batch(robot, cfg, state, [0.12], 6, 0.1,
                                  static_world=world, device=cuda_device,
                                  generator=torch.Generator(
                                      cuda_device).manual_seed(0))

    graph.clear()
    with graph.eager():
        ref = run()
    _assert_states_bitwise(run(), ref)          # tick 0 captures
    _assert_states_bitwise(run(), ref)          # every tick replays
    assert strict == [(1, 6), (0, 6)]


@pytest.mark.cuda
def test_padded_draws_launch_nothing(cuda_device):
    """On chunk ticks a tick's padding (the draws of the iterations its
    solve did not run) moves the generator's offset and launches no draw:
    the profiler's normal-distribution kernels of a cached episode are
    the draws used, where the eager episode's are used and padded."""
    from torch.profiler import ProfilerActivity, profile

    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(**_WORLDS["boxes"]).to(cuda_device)
    cfg, state = _config5(2)        # few rows: ticks stop early, and pad

    def run():
        return tmpc.run_mpc_batch(robot, cfg, state, [0.12], 6, 0.1,
                                  static_world=world, device=cuda_device,
                                  generator=torch.Generator(
                                      cuda_device).manual_seed(0))

    graph.clear()
    run()                                       # captures
    draws = {}
    for mode in ("eager", "chunk"):
        tmpc.NOISE_DRAWS.update(used=0, padded=0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if mode == "eager":
                with graph.eager():
                    run()
            else:
                run()
            torch.cuda.synchronize()
        normal = sum(e.count for e in prof.key_averages()
                     if "normal" in e.key)
        draws[mode] = (normal, dict(tmpc.NOISE_DRAWS))
    (n_eager, d_eager), (n_chunk, d_chunk) = draws["eager"], draws["chunk"]
    assert d_chunk == d_eager and d_eager["padded"] > 0
    assert n_eager == d_eager["used"] + d_eager["padded"]
    assert n_chunk == d_chunk["used"]


# --- the world, the constraints and the goal band as graph inputs ----------

def _replans(cuda_device, calls, B=64, seed=5):
    """plan_batch(robot, world, prob, cfg, **kw) for each (robot, world,
    kw) of `calls` after the one before, graphed, each against the eager
    loop on the same inputs: every result bitwise, no capture after the
    first call, one cache entry. Returns the results."""
    from tpustomp_torch.engine import graph

    cfg = _graph_config("box")
    prob = ProblemSpec(*_jittered(B, seed))

    def run(robot, world, kw):
        return plan_batch(robot, world, prob, cfg, device=cuda_device,
                          generator=torch.Generator(cuda_device).manual_seed(
                              0), **kw)

    graph.clear()
    graph.reset_counts()
    sols = []
    for robot, world, kw in calls():
        got = run(robot, world, kw)
        if not sols:
            assert graph.GRAPHS["captured"] == 3
        assert graph.GRAPHS["captured"] == 3, dict(graph.GRAPHS)
        assert graph.GRAPHS["invalidated"] == 0
        with graph.eager():
            _assert_bitwise(got, run(robot, world, kw))
        sols.append(got)
    assert len(graph.cached()) == 1
    for a, b in zip(sols, sols[1:]):
        assert not torch.equal(a.cost, b.cost)
    return sols


@pytest.mark.cuda
def test_graph_replays_an_edited_incremental_sdf(cuda_device):
    """plan, set_box, plan, add_points, plan on an IncrementalSDF on the
    card (64x80x48): the grid and the corner table are loaded into the
    graph's copies, no node is rewritten (origin and resolution stay), and
    every replan is bitwise the eager loop's on its world."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.world.edt import IncrementalSDF

    origin, shape, res = (-0.2, -1.0, 0.0), (64, 80, 48), 0.025
    inc = IncrementalSDF(occupancy_from_analytic(
        AnalyticWorld.make(**_WORLDS["boxes"]), origin, shape, res), origin,
        res, max_distance=0.5, device=cuda_device)
    robot = tmodel.arm_7dof().to(cuda_device)
    pts = np.random.default_rng(0).uniform(
        (0.5, -0.35, 0.75), (0.7, -0.15, 0.95), (400, 3)).astype(np.float32)

    def calls():
        yield robot, inc.as_world(), {}
        inc.set_box((28, 36, 32), (40, 48, 44), True)
        yield robot, inc.as_world(), {}
        inc.add_points(pts)
        yield robot, inc.as_world(), {}

    _replans(cuda_device, calls)
    assert graph.GRAPHS["inputs_loaded"] == 4
    assert graph.GRAPHS["node_updates"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["moved_box", "cone_target"])
def test_graph_replays_new_values_of_the_same_shapes(cuda_device, case):
    """A box moved in a new CPU AnalyticWorld, or a cone whose target
    moves, at every call (device="cuda"): one entry, the captured nodes'
    parameter blocks rewritten (kernels/graph_node.py), every result
    bitwise the eager loop's."""
    from tpustomp_torch.engine import graph

    def calls():
        for s in (0.0, 0.06, -0.08):
            if case == "moved_box":
                world = AnalyticWorld.make(boxes=[
                    *_WORLDS["boxes"]["boxes"],
                    ((0.64, 0.04 + s, 0.94), (0.05, 0.05, 0.05))])
                yield tmodel.arm_7dof(), world, {}
            else:
                cone = OrientationConstraint.make(
                    axis_local=(0, 0, 1), target_world=(s, 0.3 * s, 1.0),
                    tolerance=0.25, weight=0.3)
                yield (tmodel.arm_7dof(),
                       AnalyticWorld.make(**_WORLDS["boxes"]),
                       dict(constraints=cone))

    _replans(cuda_device, calls)
    assert graph.GRAPHS["node_updates"] > 0


@pytest.mark.cuda
def test_mpc_graph_replays_an_edited_grid(cuda_device):
    """A config-5 episode (B = 64) in three chunks of 2 ticks whose static
    grid (an IncrementalSDF on the card) is edited between them: one tick
    entry, captured in the first chunk, and the episode bitwise the eager
    one over the same worlds."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.world.edt import IncrementalSDF

    origin, shape, res = (-0.2, -1.0, 0.0), (64, 80, 48), 0.025
    inc = IncrementalSDF(occupancy_from_analytic(
        AnalyticWorld.make(**_WORLDS["boxes"]), origin, shape, res), origin,
        res, max_distance=0.5, device=cuda_device)
    robot = tmodel.arm_7dof().to(cuda_device)
    cfg, state0 = _config5(64)
    worlds = [inc.as_world()]
    inc.set_box((28, 36, 32), (40, 48, 44), True)
    worlds.append(inc.as_world())
    inc.set_box((20, 20, 24), (30, 30, 34), True)
    worlds.append(inc.as_world())

    def episode():
        gen, state = torch.Generator(cuda_device).manual_seed(0), state0
        for world in worlds:
            state = tmpc.run_mpc_batch(robot, cfg, state, [0.12], 2, 0.1,
                                       static_world=world,
                                       device=cuda_device, generator=gen)
        torch.cuda.synchronize()
        return state

    graph.clear()
    graph.reset_counts()
    got = episode()
    assert graph.GRAPHS["captured"] == 3, dict(graph.GRAPHS)
    assert graph.GRAPHS["inputs_loaded"] == 4
    (entry,) = graph.cached()
    assert entry["kind"] == "mpc_tick"
    with graph.eager():
        _assert_states_bitwise(got, episode())


@pytest.mark.cuda
def test_goal_band_graph_is_bitwise_eager(cuda_device):
    """resolve_goal_tolerance on its cached graph (kind "goal_band"):
    [B, d] and [d] bands, new goals and a moved box replay it, each goal
    bitwise the eager band's."""
    import tpustomp_torch.api.plan as tplan
    from tpustomp_torch.engine import graph

    robot = tmodel.arm_7dof().to(cuda_device)
    cfg = _graph_config("box")
    B = 64
    graph.clear()
    graph.reset_counts()
    for rows, shift, seed in [(True, 0.0, 1), (True, 0.0, 2),
                              (True, 0.1, 2), (False, 0.1, 3)]:
        world = AnalyticWorld.make(boxes=[
            *_WORLDS["boxes"]["boxes"],
            ((0.6, shift, 0.9), (0.1, 0.1, 0.1))]).to(cuda_device)
        q0, qN = (torch.from_numpy(x).to(cuda_device)
                  for x in _jittered(B, seed))
        tol = torch.full((B, 7) if rows else (7,), 0.3,
                         device=cuda_device).expand(B, 7)
        got = tplan.resolve_goal_tolerance(robot, world, cfg, q0, qN, tol,
                                           tol)
        with graph.eager():
            ref = tplan.resolve_goal_tolerance(robot, world, cfg, q0, qN,
                                               tol, tol)
        assert torch.equal(got, ref)
    assert graph.GRAPHS["captured"] == 1
    (entry,) = graph.cached()
    assert entry["kind"] == "goal_band" and entry["replays"] == 3


"""The propose stage of the STOMP step (kernels/propose.py, csrc/propose.cu).

On the CPU: the plain version against the solver's former inline ops
(``_spec`` below, kept verbatim as the specification), bitwise, over batch
sizes, both cells' planner shapes scaled down, joint limits on, off and
mixed, candidates pushed past the limits and per-row noise scales
(HyperParams); one ``_stomp_advance`` iteration against the same iteration
with the former ops in the propose stage's place, bitwise; the wrapper's
argument checks. On the card (``cuda`` marker; skips without one): the
kernel against the plain version on the card, bitwise, at B = 1 and 1,024
(N 100, K 50, Kr 5), 10,000 (N 50, K 16, Kr 4) and 3 (rows not a whole
number of float4s), with NaNs and values
past the limits, eagerly and replayed from a CUDA graph; the wrapper's
refusals and its launch count.

Imports no JAX:

    python -m pytest tests/test_torch_propose.py -m cuda --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpustomp_torch import NoiseConfig, PlannerConfig
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.engine.sampling import noise_product_tm
from tpustomp_torch.kernels import propose as tp
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.sdf import AnalyticWorld

# (N, K, Kr): the tabletop's (100, 50, 5) and the MPC fleet's (50, 16, 4)
# planners, scaled down
_SHAPES = {"tabletop": (20, 10, 2), "mpc": (10, 4, 1)}
_LIMITS = {"all": [True] * 7, "none": [False] * 7,
           "mixed": [True, False, True, True, False, True, False]}


def _spec(z, L, sigma, theta, reuse, Q0, QN, lower, upper, limited):
    """The propose stage as engine/solver.py _stomp_advance wrote it inline
    before the kernel: (cand_tm [N, d, B, C], full [d, T, B·C])."""
    B, d = Q0.shape
    N = theta.shape[1]
    C = 1 + z.shape[2] + reuse.shape[1]
    T = N + 2
    bcast = (slice(None), None, None)
    q0_tm = Q0.t()[:, None, :, None].expand(d, 1, B, C)
    qN_tm = QN.t()[:, None, :, None].expand(d, 1, B, C)
    eps = torch.einsum("nm,dbkm->ndbk", L, z)
    eps_tm = eps * sigma.t()[None, :, :, None]
    theta_tm = theta.permute(1, 2, 0)
    cand_tm = torch.cat([theta_tm[..., None], theta_tm[..., None] + eps_tm,
                         reuse.permute(2, 3, 0, 1)], dim=3)
    cand_tm = torch.where(limited[bcast],
                          torch.clamp(cand_tm, lower[bcast], upper[bcast]),
                          cand_tm)
    full = torch.cat([q0_tm, cand_tm.permute(1, 0, 2, 3), qN_tm],
                     dim=1).reshape(d, T, B * C)
    return cand_tm, full


def _inputs(B, N, K, Kr, limits, hyper, seed, device="cpu", d=7):
    """(z, L, sigma, theta, reuse, Q0, QN, lower, upper, limited): θ and
    the reused rollouts spread past the limits [-1.5, 1.5] (a wide joint
    0 at [-3, 3]), σ as the solver makes it (decay, with HyperParams a
    noise scale a row)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=-2.0, hi=2.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    z = torch.randn(d, B, K, N, generator=g)
    L = torch.randn(N, N, generator=g) * 0.1
    sigma = torch.rand(d, generator=g)[None, :] * 0.97 ** 3
    if hyper:
        sigma = sigma * u(B, lo=0.2, hi=3.0)[:, None]
    theta, reuse = u(B, N, d), u(B, Kr, N, d)
    Q0, QN = u(B, d, lo=-1.0, hi=1.0), u(B, d, lo=-1.0, hi=1.0)
    lower = torch.full((d,), -1.5)
    upper = torch.full((d,), 1.5)
    lower[0], upper[0] = -3.0, 3.0
    limited = torch.tensor(_LIMITS[limits])
    out = (z, L, sigma.expand(B, d).contiguous(), theta, reuse, Q0, QN,
           lower, upper, limited)
    return tuple(t.to(device) for t in out)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    """Bitwise equal, NaNs included."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("hyper", [False, True])
@pytest.mark.parametrize("limits", sorted(_LIMITS))
@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("B", [1, 3, 17])
def test_plain_is_the_former_inline_ops(B, shape, limits, hyper):
    N, K, Kr = _SHAPES[shape]
    z, L, sigma, *rest = _inputs(B, N, K, Kr, limits, hyper, B * 31 + N)
    theta, lower, upper, limited = rest[0], *rest[4:]
    want_cand, want_full = _spec(z, L, sigma, *rest)
    cand, full = tp.propose(noise_product_tm(z, L), sigma, *rest)
    assert _same(cand, want_cand) and _same(full, want_full)
    assert cand.is_contiguous() and full.is_contiguous()
    # the inputs did reach past the limits, and limited joints were clipped
    assert bool(((theta < lower) | (theta > upper)).any())
    lim = limited[None, :, None, None]
    inside = ((cand >= lower[:, None, None])
              & (cand <= upper[:, None, None]))
    assert bool((inside | ~lim).all())
    if limits != "all":
        assert bool((~inside & ~lim).any())


def test_plain_passes_nan_through():
    """A NaN in θ, in the noise or in a reused rollout stays a NaN in its
    slots, clipped or not, as torch.clamp leaves it."""
    N, K, Kr = _SHAPES["tabletop"]
    z, L, sigma, *rest = _inputs(3, N, K, Kr, "mixed", False, 5)
    theta, reuse = rest[0], rest[1]
    theta[1, 4, :] = float("nan")
    reuse[2, 1, 7, 3] = float("nan")
    eps_raw = noise_product_tm(z, L)
    eps_raw[3, 0, 0, 2] = float("nan")
    cand, full = tp.propose(eps_raw, sigma, *rest)
    want_cand, want_full = tp.propose_plain(eps_raw, sigma, *rest)
    assert _same(cand, want_cand) and _same(full, want_full)
    assert bool(cand[4, :, 1, :1 + K].isnan().all())
    assert bool(cand[7, 3, 2, 1 + K + 1].isnan())
    assert bool(cand[3, 0, 0, 3].isnan())
    assert int(cand.isnan().sum()) == 7 * (1 + K) + 2


def _step_problem(hyper):
    cfg = PlannerConfig(num_timesteps=12, num_rollouts=6, pi2_h=20.0,
                        noise=NoiseConfig(stddev=0.25, decay=0.97,
                                          num_rollouts_reused=2),
                        max_iterations=8)
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(
        boxes=[((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))])
    rng = np.random.default_rng(7)
    B, d, N = 3, 7, cfg.num_timesteps
    q0 = torch.as_tensor(rng.uniform(-0.8, 0.8, (B, d)), dtype=torch.float32)
    qN = torch.as_tensor(rng.uniform(-0.8, 0.8, (B, d)), dtype=torch.float32)
    # joint 1 pushed to its limits so that candidates cross them
    q0[:, 1] = robot.joint_upper[1] - 0.01
    qN, state = tsolver._init_batch(robot, cfg, q0, qN)
    state = dataclasses.replace(
        state, iteration=torch.tensor([0, 2, 5], dtype=torch.int32),
        reuse_theta=state.reuse_theta + torch.as_tensor(
            rng.normal(0, 0.3, state.reuse_theta.shape), dtype=torch.float32))
    ops = device_ops(N, cfg.dt, cfg.smoothness, "cpu")
    hp = (tsolver.HyperParams(noise_scale=torch.tensor([0.5, 1.0, 2.0]),
                              h=torch.tensor([10.0, 20.0, 30.0]),
                              decay=torch.tensor([0.9, 0.97, 1.0]))
          if hyper else None)
    step = tsolver.make_step_batch_tm(robot, world, cfg, ops, q0, qN,
                                      noise_fn=None, hyper=hp)
    z = torch.as_tensor(rng.normal(0, 1, (d, B, cfg.num_rollouts, N)),
                        dtype=torch.float32)
    return step, state, z


@pytest.mark.parametrize("hyper", [False, True])
def test_one_stomp_iteration_as_before(hyper, monkeypatch):
    """One _stomp_advance iteration on the CPU is bitwise the iteration
    with the former inline ops in the propose stage's place."""
    step, state, z = _step_problem(hyper)
    got = step.advance(state, z)

    def former(eps_raw, sigma, theta, reuse, Q0, QN, lower, upper, limited):
        # the former ops from the draw itself, not from eps_raw
        return _spec(z, step.ops.L_sample, sigma, theta, reuse, Q0, QN,
                     lower, upper, limited)

    monkeypatch.setattr(tp, "propose", former)
    want = tsolver.make_step_batch_tm(
        step.robot, step.world, step.cfg, step.ops, step.Q0, step.QN,
        noise_fn=None, hyper=step.hyper).advance(state, z)
    for f in dataclasses.fields(tsolver.SolverState):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a, b), f.name
    assert not torch.equal(got.theta, state.theta)


def _good(device="cpu"):
    N, K, Kr = _SHAPES["mpc"]
    z, L, sigma, *rest = _inputs(2, N, K, Kr, "mixed", False, 1, device)
    return [noise_product_tm(z, L), sigma, *rest]


_BAD = {
    "dtype": lambda a: a.__setitem__(1, a[1].double()),
    "limited_dtype": lambda a: a.__setitem__(8, a[8].float()),
    "shape": lambda a: a.__setitem__(4, a[4][:1]),
    "reuse_rank": lambda a: a.__setitem__(3, a[3][:, 0]),
    "limits_shape": lambda a: a.__setitem__(6, a[6][:3]),
    "stride": lambda a: a.__setitem__(0, a[0].transpose(2, 3).contiguous()
                                      .transpose(2, 3)),
    "sigma_stride": lambda a: a.__setitem__(1, a[1].t().contiguous().t()),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_checks_refuse(bad):
    args = _good()
    tp._checked(*args)
    _BAD[bad](args)
    with pytest.raises((ValueError, TypeError)):
        tp._checked(*args)


def test_checks_take_strided_state():
    """θ, the reused rollouts and the endpoints are read through their
    strides: a permuted layout is taken, and the plain version agrees."""
    args = _good()
    theta = args[2].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    reuse = args[3].permute(1, 0, 3, 2).contiguous().permute(1, 0, 3, 2)
    strided = [*args[:2], theta, reuse, args[4].t().contiguous().t(),
               *args[5:]]
    assert not theta.is_contiguous() and not reuse.is_contiguous()
    assert tp._checked(*strided) == (10, 7, 2, 4, 1)
    got = tp.propose(*strided)
    want = tp.propose(*args)
    assert all(_same(a, b) for a, b in zip(got, want))


def test_cpu_launches_nothing():
    before = dict(tp.LAUNCHES)
    tp.propose(*_good())
    assert tp.LAUNCHES == before


def test_reset_launches_clears_the_count():
    """rollout.reset_launches() zeroes every counter engine/graph.py moves
    to replays, the propose kernel's among them."""
    from tpustomp_torch.engine import graph
    from tpustomp_torch.kernels import rollout

    assert tp.LAUNCHES in graph._COUNTERS
    saved = [dict(c) for c in graph._COUNTERS]
    try:
        tp.LAUNCHES["propose"] = 5
        rollout.reset_launches()
        assert tp.LAUNCHES == {"propose": 0}
    finally:
        for c, old in zip(graph._COUNTERS, saved):
            c.update(old)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA propose kernel)")
    return torch.device("cuda")


# (B, N, K, Kr): single, batch1024, fleet10k (rows of whole float4s), and
# rows of 63 columns (the kernel's scalar form)
_CARD_SHAPES = [(1, 100, 50, 5), (1024, 100, 50, 5), (10000, 50, 16, 4),
                (3, 50, 16, 4)]


def _card_inputs(B, N, K, Kr, seed, dev, nan=True):
    z, L, sigma, *rest = _inputs(B, N, K, Kr, "mixed", True, seed, dev)
    eps_raw = noise_product_tm(z, L)
    if nan:
        rest[0][B - 1, N // 2, :] = float("nan")
        rest[1][0, Kr - 1, 3, 2] = float("nan")
        eps_raw[1, 2, B // 2, K - 1] = float("nan")
    return [eps_raw, sigma, *rest]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,K,Kr", _CARD_SHAPES)
def test_kernel_is_plain_on_the_card(cuda_device, B, N, K, Kr):
    args = _card_inputs(B, N, K, Kr, B + N, cuda_device)
    before = tp.LAUNCHES["propose"]
    cand, full = tp.propose(*args)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["propose"] == before + 1
    want_cand, want_full = tp.propose_plain(*args)
    assert _same(cand, want_cand) and _same(full, want_full)
    assert bool(cand.isnan().any())
    # clipped candidates are there
    lo, hi = args[6], args[7]
    assert bool(((want_cand == lo[:, None, None])
                 | (want_cand == hi[:, None, None])).any())
    # θ and the reused rollouts in a permuted layout, bitwise the same
    strided = [*args[:2], args[2].permute(2, 0, 1).contiguous()
               .permute(1, 2, 0),
               args[3].permute(1, 0, 3, 2).contiguous().permute(1, 0, 3, 2),
               *args[4:]]
    again = tp.propose(*strided)
    assert _same(again[0], cand) and _same(again[1], full)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,K,Kr", _CARD_SHAPES)
def test_kernel_replayed_from_a_graph(cuda_device, B, N, K, Kr):
    """Captured once, replayed twice on new inputs copied into the static
    ones: bitwise the plain version each time; the capture counts one
    launch, the replays none."""
    static = _card_inputs(B, N, K, Kr, 1, cuda_device)
    tp.load(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    before = tp.LAUNCHES["propose"]
    with torch.cuda.graph(graph, stream=stream):
        cand, full = tp.propose(*static)
    assert tp.LAUNCHES["propose"] == before + 1
    for seed in (2, 3):
        new = _card_inputs(B, N, K, Kr, seed, cuda_device, nan=seed == 3)
        for s, v in zip(static, new):
            s.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        want_cand, want_full = tp.propose_plain(*new)
        assert _same(cand, want_cand) and _same(full, want_full)
    assert tp.LAUNCHES["propose"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", sorted(_BAD))
def test_kernel_refuses(cuda_device, bad):
    args = _good(cuda_device)
    before = tp.LAUNCHES["propose"]
    _BAD[bad](args)
    with pytest.raises((ValueError, TypeError)):
        tp.propose(*args)
    mixed = _good(cuda_device)
    mixed[5] = mixed[5].cpu()
    with pytest.raises(ValueError):
        tp.propose(*mixed)
    assert tp.LAUNCHES["propose"] == before

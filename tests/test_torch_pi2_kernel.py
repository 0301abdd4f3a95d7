"""PI²'s tail in the STOMP step (kernels/pi2.py, csrc/pi2.cu).

On the CPU: the plain version against the solver's former inline ops
(``_former`` below, kept verbatim as the specification), bitwise, for the
cumulative and local cost, the control cost on and off, one h and one h a
row, at both cells' planner shapes scaled down; one ``_stomp_advance``
iteration against the same iteration with the former ops in the tail's
place, bitwise; the kernel's tiling (``_plan``) at the cells' shapes and
past a block's shared memory; the wrapper's hand-over on the "meta"
device, which stands in for the card (a library that records its
arguments stands in for the kernel's: every tensor in place with its
strides, no op but the output's allocation); its refusals; the launch
counter.

On the card (``cuda`` marker; skips without one): the kernel against a
float64 evaluation of the same formula and beside the plain ops on the
card, at config 4 (B 1,024, K 55, T 102), config 5 (B 10,000, K 20,
T 52) and B = 1, for both modes, the control cost and one h a row, with
a scenario holding a NaN and one whose costs are all equal; every
tiling bitwise the same; a graph's replays on new inputs; no cumsum,
flip or exp left on the STOMP step's card route; one launch a
STOMP iteration over a plan_batch (eager and graphed), the smooth
projection's route and an MPC episode, none for CHOMP.

Imports no JAX:

    python -m pytest tests/test_torch_pi2_kernel.py -m cuda --noconftest
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from tpustomp_torch import NoiseConfig, PlannerConfig, ProblemSpec, plan_batch
from tpustomp_torch.dynamics.device import device_ops
from tpustomp_torch.engine import graph
from tpustomp_torch.engine import mpc as tmpc
from tpustomp_torch.engine import pi2 as tpi2
from tpustomp_torch.engine import solver as tsolver
from tpustomp_torch.kernels import pi2 as kp
from tpustomp_torch.kernels import propose, rollout
from tpustomp_torch.robot import model as tmodel
from tpustomp_torch.world.sdf import AnalyticWorld

from tests.test_torch_param_routes import device_ops as aten_ops

# (N, K): the tabletop's (100, 55) and the MPC fleet's (50, 20) noisy
# slots, scaled down
_SHAPES = {"tabletop": (20, 11), "mpc": (10, 5)}
_W_CTRL = 0.1
_BOXES = [((0.6, 0.0, 0.2), (0.45, 0.6, 0.25))]


def _former(S_all, ctrl_all, w_smooth, mode, cand_tm, theta_tm, M, pi2_h):
    """The update as engine/solver.py _stomp_advance and engine/pi2.py
    update_tm_cand wrote it before the kernel: δθ [B, N, d]. cand_tm is
    every slot [N, d, B, C]; ctrl_all None stands for
    pi2_include_control_cost off."""
    S_used = S_all[:, 1:, :]
    if ctrl_all is not None:
        S_used = S_used + w_smooth * ctrl_all[:, 1:, :]
    if mode == "cumulative":
        S_used = torch.flip(torch.cumsum(torch.flip(S_used, [2]), dim=2),
                            [2])
    S = S_used[:, :, 1:-1]
    h_arr = torch.as_tensor(pi2_h, dtype=torch.float32, device=S.device)
    h_arr = h_arr.expand(S.shape[0])[:, None, None]
    lo = S.amin(dim=-2, keepdim=True)
    hi = S.amax(dim=-2, keepdim=True)
    S_norm = (S - lo) / (hi - lo + 1e-8)
    e = torch.exp(-h_arr * S_norm)
    P = e / e.sum(dim=-2, keepdim=True)
    wavg = torch.einsum("bkn,ndbk->ndb", P, cand_tm[..., 1:])
    psum = torch.sum(P, dim=1).t()
    delta = wavg - theta_tm * psum[:, None, :]
    delta = torch.einsum("nm,mdb->ndb", M, delta)
    return delta.permute(2, 0, 1)


def _inputs(B, N, K, seed, device="cpu", ctrl=False, per_row=False, d=7,
            odd=True):
    """(S_all [B, C, T], ctrl_all or None, cand_tm [N, d, B, C] (every
    slot: the tail reads [..., 1:]), theta_tm [N, d, B] (θ's [B, N, d]
    permuted, as the solver hands it), h): costs ≥ 0, about 60 % of them
    0, as an obstacle cost is, and with `odd` a scenario with a NaN cost
    and one whose noisy slots' costs are all equal."""
    g = torch.Generator().manual_seed(seed)
    C, T = K + 1, N + 2
    S_all = (2.0 * torch.rand(B, C, T, generator=g)
             * (torch.rand(B, C, T, generator=g) < 0.4))
    if odd:
        S_all[B - 1, min(2, K), T // 2] = float("nan")
        if B > 1:
            S_all[0, 1:, :] = 0.25
    ctrl_all = torch.rand(B, C, T, generator=g) * 3.0 if ctrl else None
    if odd and ctrl and B > 1:
        ctrl_all[0, 1:, :] = 0.5
    theta = torch.randn(B, N, d, generator=g)
    cand = (theta.permute(1, 2, 0)[..., None]
            + 0.3 * torch.randn(N, d, B, C, generator=g))
    h = (torch.rand(B, generator=g) * 25.0 + 1.0 if per_row
         else torch.tensor(10.0))
    out = (S_all, ctrl_all, cand, theta, h)
    S_all, ctrl_all, cand, theta, h = (None if t is None else t.to(device)
                                       for t in out)
    return S_all, ctrl_all, cand, theta.permute(1, 2, 0), h


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    """Bitwise equal, NaNs included."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ctrl", [False, True])
@pytest.mark.parametrize("mode", ["cumulative", "local"])
@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_plain_is_the_former_inline_ops(shape, mode, ctrl, per_row):
    N, K = _SHAPES[shape]
    B = 5
    S_all, ctrl_all, cand, theta_tm, h = _inputs(
        B, N, K, N * 7 + K, ctrl=ctrl, per_row=per_row)
    M = torch.randn(N, N, generator=torch.Generator().manual_seed(N))
    want = _former(S_all, ctrl_all, _W_CTRL, mode, cand, theta_tm, M, h)
    got = kp.tail(S_all, ctrl_all, _W_CTRL, mode == "cumulative",
                  cand[..., 1:], theta_tm, h)
    assert got.shape == (N, 7, B)
    assert _same(tpi2.smooth_tm(got, M), want)
    # the odd scenarios are there: NaNs in the last, none elsewhere
    assert bool(want[B - 1].isnan().any())
    assert not bool(want[:B - 1].isnan().any())


def _step_problem(hyper, mode, ctrl):
    cfg = PlannerConfig(num_timesteps=12, num_rollouts=6, pi2_h=20.0,
                        pi2_cost_mode=mode, pi2_include_control_cost=ctrl,
                        noise=NoiseConfig(stddev=0.25, decay=0.97,
                                          num_rollouts_reused=2),
                        max_iterations=8)
    robot = tmodel.arm_7dof()
    world = AnalyticWorld.make(boxes=_BOXES)
    rng = np.random.default_rng(11)
    B, d, N = 3, 7, cfg.num_timesteps
    q0 = torch.as_tensor(rng.uniform(-0.8, 0.8, (B, d)), dtype=torch.float32)
    qN = torch.as_tensor(rng.uniform(-0.8, 0.8, (B, d)), dtype=torch.float32)
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


@pytest.mark.parametrize("ctrl", [False, True])
@pytest.mark.parametrize("mode", ["cumulative", "local"])
@pytest.mark.parametrize("hyper", [False, True])
def test_one_stomp_iteration_as_before(hyper, mode, ctrl, monkeypatch):
    """One _stomp_advance iteration on the CPU is bitwise the iteration
    with the former inline ops in the tail's place (and M's product,
    which the former ops made, taken out of the solver's)."""
    step, state, z = _step_problem(hyper, mode, ctrl)
    got = step.advance(state, z)
    seen = []

    def former(S_all, ctrl_all, w, cumulative, cand, theta_tm, h):
        assert cumulative == (mode == "cumulative")
        assert (ctrl_all is not None) == ctrl
        seen.append(cand)
        full = torch.cat([theta_tm[..., None], cand], dim=3)
        return _former(S_all, ctrl_all, w, mode, full, theta_tm,
                       step.ops.M, h)

    monkeypatch.setattr(kp, "tail", former)
    monkeypatch.setattr(tpi2, "smooth_tm", lambda delta, M: delta)
    want = tsolver.make_step_batch_tm(
        step.robot, step.world, step.cfg, step.ops, step.Q0, step.QN,
        noise_fn=None, hyper=step.hyper).advance(state, z)
    assert len(seen) == 1
    for f in dataclasses.fields(tsolver.SolverState):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a, b), f.name
    assert not torch.equal(got.theta, state.theta)


# (B, K, T, d, sms): config 4, config 5, one query, a long trajectory,
# many rollouts, and a card of few SMs
_PLAN_SHAPES = {"config4": (1024, 55, 102, 7, 132),
                "config5": (10000, 20, 52, 7, 132),
                "single": (1, 55, 102, 7, 132),
                "long": (4, 200, 1002, 7, 132),
                "many_rollouts": (2, 5000, 52, 7, 132),
                "few_sms": (64, 20, 52, 7, 8)}


@pytest.mark.parametrize("shape", sorted(_PLAN_SHAPES))
def test_plan(shape):
    """nb, tt and the waypoint split cover every output once within the
    block's shared memory: the cells' shapes in one tile of 28 KB or
    less, the batch alone filling the card where it can, a single query
    split over its waypoints, longer trajectories in tiles of T."""
    B, K, T, d, sms = _PLAN_SHAPES[shape]
    N = T - 2
    p = kp._plan(B, K, T, d, sms)
    nb, tt, n_split, splits = p["nb"], p["tt"], p["n_split"], p["splits"]
    assert 1 <= nb <= B and 1 <= tt <= T
    assert p["smem"] == nb * (8 * K + 4 * K * (tt | 1) + 4 * tt + 12 * d)
    assert p["smem"] <= (kp._BLOCK_BUDGET if shape != "many_rollouts"
                         else kp._SMEM_MAX)
    # the waypoint runs cover [0, N) once, none empty
    assert (splits - 1) * n_split < N <= splits * n_split
    blocks = -(-B // nb) * splits
    if shape in ("config4", "config5"):
        assert tt == T and splits == 1
        assert blocks >= sms * kp._BLOCKS_PER_SM
    if shape == "config5":
        assert nb > 1
    if shape == "single":
        assert tt == T and splits > 1 and n_split * d >= kp._MIN_OUTPUTS
    if shape in ("long", "many_rollouts"):
        assert tt < T
    # one more scenario or column would pass the budget
    if nb < B:
        assert (nb + 1) * (p["smem"] // nb) > kp._BLOCK_BUDGET or \
            shape == "many_rollouts"


@pytest.mark.parametrize("K", [1, 16, 17, 20, 55, 100, 5000])
def test_lanes_a_column(K):
    """A column of P takes a power of two of threads, from K alone, each
    with at most 16 slots (up to a warp): 2 at config 5's K = 20, 4 at
    config 4's 55."""
    lanes = kp._lanes(K)
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    assert -(-K // lanes) <= 16 or lanes == 32
    assert lanes == 1 or -(-K // (lanes // 2)) > 16
    assert {20: 2, 55: 4}.get(K, lanes) == lanes


def test_plan_refuses_a_column_past_shared_memory():
    with pytest.raises(ValueError):
        kp._plan(1, 20000, 52, 7, 132)


def _meta_args(B=6, N=10, K=5, ctrl=True, per_row=True):
    S_all, ctrl_all, cand, theta_tm, h = _inputs(B, N, K, 3, ctrl=ctrl,
                                                 per_row=per_row, odd=False)
    return [None if t is None else t.to("meta")
            for t in (S_all, ctrl_all)] + [cand[..., 1:].to("meta"),
                                            theta_tm.to("meta"),
                                            h.to("meta")]


@pytest.fixture
def stub_library(monkeypatch):
    """A library whose pi2_launch records its arguments, standing in for
    the kernel's on the "meta" device."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(pi2_launch=launch)
    monkeypatch.setattr(kp, "_library", lambda: lib)
    monkeypatch.setattr(rollout, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ctrl", [False, True])
def test_launch_hands_over_every_tensor_in_place(stub_library, ctrl,
                                                 per_row):
    """The wrapper hands the kernel the caller's tensors with their
    strides (the noisy slots as cand_tm[..., 1:], θ permuted), h's stride
    (0 for one value), no control pointer without the control cost, the
    plan for the shape; the only op on the device is the output's
    allocation, and the launch is counted."""
    S_all, ctrl_all, cand, theta_tm, h = _meta_args(ctrl=ctrl,
                                                    per_row=per_row)
    N, d, B, K = cand.shape
    assert not cand.is_contiguous() and not theta_tm.is_contiguous()
    before = kp.LAUNCHES["pi2"]
    out, ops = aten_ops(lambda: kp._launch(
        S_all, ctrl_all, 0.5, True, cand, theta_tm, h), "meta")
    assert set(ops) <= {"empty", "empty_strided"}, ops
    assert out.shape == (N, d, B) and out.is_contiguous()
    assert kp.LAUNCHES["pi2"] == before + 1
    (args,) = stub_library
    assert (args[1] is None) == (not ctrl)
    strides = args[6:20]
    want = (*S_all.stride(), *(ctrl_all if ctrl else S_all).stride(),
            *cand.stride(), *theta_tm.stride(), 1 if per_row else 0)
    assert strides == want
    p = kp._plan(B, K, N + 2, d, 132)
    assert args[20:] == (0.5, 1, B, K, N + 2, d, p["nb"], p["tt"],
                         p["n_split"], p["splits"], kp._lanes(K), 7)


def test_tail_refuses_a_device_that_is_not_the_card():
    args = _meta_args()
    with pytest.raises(ValueError):
        kp.tail(args[0], args[1], 0.1, True, *args[2:])


_BAD = {
    "S_dtype": lambda a: a.__setitem__(0, a[0].double()),
    "S_slots": lambda a: a.__setitem__(0, a[0][:, 1:]),
    "S_steps": lambda a: a.__setitem__(0, a[0][:, :, 1:]),
    "ctrl_shape": lambda a: a.__setitem__(1, a[1][:-1]),
    "cand_rank": lambda a: a.__setitem__(2, a[2][..., 0]),
    "theta_shape": lambda a: a.__setitem__(3, a[3][:, :, :-1]),
    "theta_dtype": lambda a: a.__setitem__(3, a[3].half()),
    "h_shape": lambda a: a.__setitem__(4, a[4][:-1]),
    "h_float": lambda a: a.__setitem__(4, 10.0),
    "mixed_device": lambda a: a.__setitem__(3, a[3].to("meta")),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_checks_refuse(bad):
    S_all, ctrl_all, cand, theta_tm, h = _inputs(4, 6, 3, 1, ctrl=True,
                                                 per_row=True)
    args = [S_all, ctrl_all, cand[..., 1:], theta_tm, h]
    assert kp._checked(*args) == (4, 3, 8, 6, 7)
    _BAD[bad](args)
    with pytest.raises((ValueError, TypeError)):
        kp._checked(*args)


def test_cpu_launches_nothing():
    S_all, ctrl_all, cand, theta_tm, h = _inputs(3, 6, 4, 2)
    before = dict(kp.LAUNCHES)
    kp.tail(S_all, ctrl_all, 0.1, True, cand[..., 1:], theta_tm, h)
    assert kp.LAUNCHES == before


def test_reset_launches_clears_the_count():
    """rollout.reset_launches() zeroes every counter engine/graph.py moves
    to replays, the PI² kernel's among them."""
    assert any(c is kp.LAUNCHES for c in graph._COUNTERS)
    saved = [dict(c) for c in graph._COUNTERS]
    try:
        kp.LAUNCHES["pi2"] = 5
        rollout.reset_launches()
        assert kp.LAUNCHES == {"pi2": 0}
    finally:
        for c, old in zip(graph._COUNTERS, saved):
            c.update(old)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA PI² kernel)")
    kp.load(torch.device("cuda"))
    return torch.device("cuda")


# (B, N, K): config 4's tabletop batch, config 5's fleet, one query
_CARD_SHAPES = {"config4": (1024, 100, 55), "config5": (10000, 50, 20),
                "single": (1, 100, 55)}


def _float64(S_all, ctrl_all, w, cumulative, cand, theta_tm, h):
    """The tail's formula in float64 from the same float32 inputs."""
    S = S_all.double()[:, 1:, :]
    if ctrl_all is not None:
        S = S + w * ctrl_all.double()[:, 1:, :]
    if cumulative:
        S = S.flip(2).cumsum(2).flip(2)
    S = S[:, :, 1:-1]
    lo, hi = S.amin(1, keepdim=True), S.amax(1, keepdim=True)
    hh = h.double().expand(S.shape[0])[:, None, None]
    e = torch.exp(-hh * ((S - lo) / (hi - lo + 1e-8)))
    P = e / e.sum(1, keepdim=True)
    return (torch.einsum("bkn,ndbk->ndb", P, cand.double())
            - theta_tm.double() * P.sum(1).t()[:, None, :])


def _gap(a, ref):
    """max |a − ref| over the entries where ref is a number."""
    m = ~ref.isnan()
    return float((a.double() - ref)[m].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ctrl", [False, True])
@pytest.mark.parametrize("mode", ["cumulative", "local"])
@pytest.mark.parametrize("shape", sorted(_CARD_SHAPES))
def test_kernel_matches_float64_on_the_card(cuda_device, shape, mode, ctrl,
                                            per_row):
    """The kernel's distance to a float64 evaluation of the formula is at
    most the larger of two: twice the plain float32 ops' own distance on
    the card (its sums run in another order: the cost-to-go in double,
    the K-term sums one lane a slot and folded over the warp, where
    torch's scan and reductions take theirs), and the worst-case rounding
    of the K-term float32 sums it makes, K · 2^-23 · (max |cand| +
    max |θ|) (Σ_k P_k = 1). The NaNs of the NaN scenario are where the
    plain ops put them; the scenario whose costs are all equal averages
    its noisy slots (P = 1/K)."""
    B, N, K = _CARD_SHAPES[shape]
    cum = mode == "cumulative"
    S_all, ctrl_all, cand, theta_tm, h = _inputs(
        B, N, K, B + N + K, cuda_device, ctrl=ctrl, per_row=per_row)
    noisy = cand[..., 1:]
    before = kp.LAUNCHES["pi2"]
    got = kp.tail(S_all, ctrl_all, _W_CTRL, cum, noisy, theta_tm, h)
    plain = kp.tail_plain(S_all, ctrl_all, _W_CTRL, cum, noisy, theta_tm, h)
    torch.cuda.synchronize()
    assert kp.LAUNCHES["pi2"] == before + 1
    ref = _float64(S_all, ctrl_all, _W_CTRL, cum, noisy, theta_tm, h)
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got.isnan(), ref.isnan())
    assert bool(got[..., B - 1].isnan().any())
    assert not bool(got[..., :B - 1].isnan().any())
    floor = K * 2.0 ** -23 * float(noisy.abs().max() + theta_tm.abs().max())
    g_kernel, g_plain = _gap(got, ref), _gap(plain, ref)
    assert g_kernel <= max(2.0 * g_plain, floor), (g_kernel, g_plain, floor)
    if B > 1:       # scenario 0: every noisy slot costs the same
        mean = noisy[..., 0, :].double().mean(-1) - theta_tm[..., 0].double()
        assert float((got[..., 0].double() - mean).abs().max()) <= floor


def _plans(B, N, K, d=7):
    """The default plan and others that tile T, split the waypoints and
    take other scenario counts: every one must give the same bits."""
    T = N + 2
    p = kp._plan(B, K, T, d, torch.cuda.get_device_properties(0)
                 .multi_processor_count)
    others = [dict(nb=1, tt=7, n_split=N, splits=1),
              dict(nb=min(B, 3), tt=T, n_split=7, splits=-(-N // 7)),
              dict(nb=min(B, 5), tt=2, n_split=13, splits=-(-N // 13))]
    return p, others


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cumulative", "local"])
@pytest.mark.parametrize("shape", ["config4", "config5_cut", "single"])
def test_every_plan_gives_the_same_bits(cuda_device, shape, mode):
    B, N, K = {"config4": (1024, 100, 55), "config5_cut": (600, 50, 20),
               "single": (1, 100, 55)}[shape]
    args = _inputs(B, N, K, 5, cuda_device, ctrl=True, per_row=True)
    S_all, ctrl_all, cand, theta_tm, h = args
    default, others = _plans(B, N, K)
    first = kp._launch(S_all, ctrl_all, _W_CTRL, mode == "cumulative",
                       cand[..., 1:], theta_tm, h, default)
    for p in others:
        again = kp._launch(S_all, ctrl_all, _W_CTRL, mode == "cumulative",
                           cand[..., 1:], theta_tm, h, p)
        assert _same(again, first), p


@pytest.mark.cuda
def test_long_trajectory_takes_tiles(cuda_device):
    """K · T past a block's budget: the default plan tiles T, and matches
    the float64 evaluation as above."""
    B, N, K = 3, 400, 120
    assert kp._plan(B, K, N + 2, 7, 132)["tt"] < N + 2
    S_all, ctrl_all, cand, theta_tm, h = _inputs(B, N, K, 9, cuda_device,
                                                 per_row=True)
    got = kp.tail(S_all, ctrl_all, _W_CTRL, True, cand[..., 1:], theta_tm,
                  h)
    plain = kp.tail_plain(S_all, ctrl_all, _W_CTRL, True, cand[..., 1:],
                          theta_tm, h)
    ref = _float64(S_all, ctrl_all, _W_CTRL, True, cand[..., 1:], theta_tm,
                   h)
    assert torch.equal(got.isnan(), ref.isnan())
    floor = K * 2.0 ** -23 * float(cand.abs().max() + theta_tm.abs().max())
    assert _gap(got, ref) <= max(2.0 * _gap(plain, ref), floor)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_CARD_SHAPES))
def test_kernel_replayed_from_a_graph(cuda_device, shape):
    """Captured once, replayed on new inputs copied into the captured
    ones: bitwise an eager launch each time; the capture counts one
    launch, the replays none."""
    B, N, K = _CARD_SHAPES[shape]
    static = list(_inputs(B, N, K, 1, cuda_device, ctrl=True,
                          per_row=True))
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    g = torch.cuda.CUDAGraph()
    before = kp.LAUNCHES["pi2"]
    with torch.cuda.graph(g, stream=stream):
        out = kp.tail(static[0], static[1], _W_CTRL, True,
                      static[2][..., 1:], static[3], static[4])
    assert kp.LAUNCHES["pi2"] == before + 1
    for seed in (2, 3):
        new = _inputs(B, N, K, seed, cuda_device, ctrl=True, per_row=True,
                      odd=seed == 3)
        for s, v in zip(static, new):
            s.copy_(v)
        g.replay()
        torch.cuda.synchronize()
        want = kp.tail(new[0], new[1], _W_CTRL, True, new[2][..., 1:],
                       new[3], new[4])
        assert _same(out, want)
    assert kp.LAUNCHES["pi2"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("bad", sorted(_BAD))
def test_kernel_refuses(cuda_device, bad):
    S_all, ctrl_all, cand, theta_tm, h = _inputs(4, 6, 3, 1, cuda_device,
                                                 ctrl=True, per_row=True)
    args = [S_all, ctrl_all, cand[..., 1:], theta_tm, h]
    before = kp.LAUNCHES["pi2"]
    _BAD[bad](args)
    with pytest.raises((ValueError, TypeError)):
        kp.tail(args[0], args[1], 0.1, True, *args[2:])
    mixed = [S_all, ctrl_all, cand[..., 1:], theta_tm.cpu(), h]
    with pytest.raises(ValueError):
        kp.tail(mixed[0], mixed[1], 0.1, True, *mixed[2:])
    assert kp.LAUNCHES["pi2"] == before


def _arm_problem(B, seed, device):
    rng = np.random.default_rng(seed)
    q0 = np.array([-0.6, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    qN = np.array([0.4, 0.5, 0.0, -0.8, 0.0, -0.5, 0.0], np.float32)
    jitter = rng.uniform(-0.03, 0.03, (2, B, 7)).astype(np.float32)
    return ProblemSpec(q0=torch.as_tensor(q0 + jitter[0], device=device),
                       qN=torch.as_tensor(qN + jitter[1], device=device))


@pytest.mark.cuda
def test_no_plain_tail_op_on_the_card_route(cuda_device):
    """One STOMP iteration on the card runs no cumsum, flip or exp (the
    rest of the step has none: amin, amax and div it has elsewhere): the
    tail is the kernel."""
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8,
                        noise=NoiseConfig(num_rollouts_reused=2),
                        max_iterations=4)
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(boxes=_BOXES).to(cuda_device)
    prob = _arm_problem(4, 0, cuda_device)
    ops = device_ops(cfg.num_timesteps, cfg.dt, cfg.smoothness, cuda_device)
    qN, state = tsolver._init_batch(robot, cfg, prob.q0, prob.qN)
    step = tsolver.make_step_batch_tm(robot, world, cfg, ops, prob.q0, qN,
                                      noise_fn=None)
    z = torch.randn(7, 4, cfg.num_rollouts, cfg.num_timesteps,
                    device=cuda_device)
    step.advance(state, z)                          # warm: builds, loads
    before = kp.LAUNCHES["pi2"]
    _, names = aten_ops(lambda: step.advance(state, z), "cuda")
    torch.cuda.synchronize()
    assert kp.LAUNCHES["pi2"] == before + 1
    assert not {"cumsum", "flip", "exp"} & set(names), names


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["eager", "chunk", "smooth"])
def test_one_launch_a_stomp_iteration(cuda_device, route):
    cfg = PlannerConfig(num_timesteps=30, num_rollouts=10,
                        noise=NoiseConfig(num_rollouts_reused=2),
                        max_iterations=12,
                        rollout_limit_projection="smooth"
                        if route == "smooth" else "clip")
    robot = tmodel.arm_7dof().to(cuda_device)
    world = AnalyticWorld.make(boxes=_BOXES).to(cuda_device)
    prob = _arm_problem(32, 1, cuda_device)
    for _ in range(2):                  # a cache miss, then a hit
        rollout.reset_launches()
        with (graph.eager() if route == "eager"
              else contextlib.nullcontext()):
            sol = plan_batch(robot, world, prob, cfg)
        torch.cuda.synchronize()
        its = int(sol.iterations.max())
        assert its > 0
        assert kp.LAUNCHES["pi2"] == its
        assert propose.LAUNCHES["propose"] == (0 if route == "smooth"
                                               else its)


@pytest.mark.cuda
def test_mpc_episode_and_chomp_launches(cuda_device):
    """An MPC episode launches the tail once a STOMP iteration, as many
    as the propose kernel; CHOMP launches none."""
    cfg = PlannerConfig(num_timesteps=20, num_rollouts=8,
                        noise=NoiseConfig(num_rollouts_reused=2),
                        max_iterations=8, record_metrics=False)
    robot = tmodel.arm_7dof().to(cuda_device)
    B = 16
    rng = np.random.default_rng(4)
    prob = _arm_problem(B, 2, "cpu")
    centers = np.stack([rng.uniform(0.4, 0.7, B), rng.uniform(-0.4, 0.4, B),
                        rng.uniform(0.4, 0.7, B)], 1)[:, None]
    state = tmpc.init_mpc(robot, cfg, prob.q0.to(cuda_device),
                          prob.qN.to(cuda_device),
                          torch.as_tensor(centers, dtype=torch.float32,
                                          device=cuda_device),
                          torch.as_tensor(rng.normal(0, 0.2, (B, 1, 3)),
                                          dtype=torch.float32,
                                          device=cuda_device))
    rollout.reset_launches()
    tmpc.run_mpc_batch(robot, cfg, state, [0.12], 5, 0.1,
                       device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert kp.LAUNCHES["pi2"] > 0
    assert kp.LAUNCHES["pi2"] == propose.LAUNCHES["propose"]
    rollout.reset_launches()
    plan_batch(robot, AnalyticWorld.make(boxes=_BOXES).to(cuda_device),
               _arm_problem(8, 3, cuda_device),
               PlannerConfig(mode="chomp", num_timesteps=20,
                             max_iterations=5))
    torch.cuda.synchronize()
    assert kp.LAUNCHES["pi2"] == 0 and propose.LAUNCHES["propose"] == 0

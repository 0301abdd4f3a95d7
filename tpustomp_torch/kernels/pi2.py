"""PI²'s tail in the time-major STOMP step (``csrc/pi2.cu``).

From the per-timestep costs of every candidate to the probability-weighted
update before the smoothing matrix M, in one pass: S_all ``[B, C, T]``
(slot 0 the current θ, the noisy slots after it, T = N + 2 with both
endpoints), optionally the control cost ctrl_all ``[B, C, T]`` with its
weight, the cost mode (cumulative: each noisy slot's cost-to-go, the
reverse suffix sum over all T timesteps; else the local cost), the noisy
candidates cand ``[N, d, B, K]`` (K = C − 1: ``cand_tm[..., 1:]``, read in
place), θ ``[N, d, B]`` and PI²'s h (one value, or one a row) become

    Σ_k P_k(n+1)·cand_k(n) − θ(n)·Σ_k P_k(n+1)    [N, d, B]

with P engine/pi2.py ``probabilities`` of the interior timesteps.

:func:`tail_plain` is those ops as the solver wrote them in PyTorch (the
CPU's route, bitwise what it ran before the kernel); :func:`tail`
launches the kernel for CUDA tensors and takes the plain version for CPU
tensors only. Its sums over the rollouts run in another order than
torch's reductions (the cost-to-go in double), so on the card it is held
to a float64 evaluation, not bitwise to the plain ops. The library is
built by nvcc from the checkout at first use, as the rollout kernels are
(kernels/rollout.py ``build``), with a plain C interface called through
ctypes.

``LAUNCHES`` counts the kernel's launches, one a STOMP iteration
(engine/graph.py moves a capture's count to the graph's replays, as it
does the rollout kernels'; ``rollout.reset_launches()`` zeroes it with
theirs).
"""

from __future__ import annotations

import ctypes

import torch

from tpustomp_torch.engine import pi2 as engine_pi2
from tpustomp_torch.kernels import rollout

LAUNCHES = {"pi2": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# pi2_launch: s, ctrl, cand, theta, h, out; 14 strides; w_ctrl; cumulative,
# B, K, T, d, nb, tt, n_split, splits, lanes; stream
_ARGTYPES = [_P] * 6 + [_L] * 14 + [_F] + [_I] * 10 + [_P]
_LOADED: set = set()      # device indices whose module is loaded
_TYPED: set = set()       # ids of the libraries whose entries are typed

# csrc/pi2.cu: a block's budget of shared memory (8 blocks of 256 threads
# share an SM's 228 KB), and the most it may take (kSmemMax)
_BLOCK_BUDGET = 28 * 1024
_SMEM_MAX = 227 * 1024
# blocks a card of this many SMs should hold before the waypoints split
_BLOCKS_PER_SM = 4
# outputs (n, j, b) a block should own at least when the waypoints split
_MIN_OUTPUTS = 32


def _library() -> ctypes.CDLL:
    lib = rollout.build(("pi2",))[("pi2", None)]
    if id(lib) not in _TYPED:
        _TYPED.add(id(lib))
        lib.pi2_load.argtypes = [_I]
        lib.pi2_launch.argtypes = _ARGTYPES
        for fn in (lib.pi2_load, lib.pi2_launch):
            fn.restype = ctypes.c_int
    return lib


def load(device: torch.device) -> None:
    """Build the library and load its kernels on `device`, outside any
    capture."""
    index = torch.device(device).index or 0
    if index not in _LOADED:
        rc = _library().pi2_load(index)
        if rc != 0:
            raise RuntimeError(f"pi2_load failed: CUDA error {rc}")
        _LOADED.add(index)


def tail_plain(S_all, ctrl_all, w_ctrl, cumulative, cand, theta_tm, h):
    """[N, d, B] in plain PyTorch: the kernel's specification."""
    S_used = S_all[:, 1:, :]
    if ctrl_all is not None:
        S_used = S_used + w_ctrl * ctrl_all[:, 1:, :]
    if cumulative:
        S_used = torch.flip(torch.cumsum(torch.flip(S_used, [2]), dim=2),
                            [2])
    return engine_pi2.weighted_candidates(cand, theta_tm, S_used[:, :, 1:-1],
                                          h)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _lanes(K: int) -> int:
    """Threads a column of P: the least power of two that leaves each at
    most 16 of the K slots (K alone decides it, so every tiling sums a
    column in the same order)."""
    return min(32, 1 << (_cdiv(K, 16) - 1).bit_length())


def _plan(B: int, K: int, T: int, d: int, sms: int) -> dict:
    """The kernel's tiling for B scenarios of K noisy slots, T timesteps
    and d joints on a card of `sms` SMs: nb scenarios a block (as many as
    28 KB of shared memory hold), tt columns of S a tile (T unless one
    scenario's K × T floats pass that), and the waypoints split in runs of
    n_split over `splits` blocks where the batch alone gives fewer blocks
    than 4 an SM (each run keeps at least 32 outputs). smem is the block's
    bytes (csrc/pi2.cu smem_bytes). Raises where one column of K slots
    passes the card's most shared memory."""
    N = T - 2

    def smem(nb, tt):
        return nb * (8 * K + 4 * K * (tt | 1) + 4 * tt + 12 * d)

    budget = _BLOCK_BUDGET if smem(1, 1) <= _BLOCK_BUDGET else _SMEM_MAX
    if smem(1, 1) > budget:
        raise ValueError(f"{K} noisy rollouts of {d} joints: one column "
                         f"takes {smem(1, 1)} bytes of shared memory, more "
                         f"than a block's {_SMEM_MAX}")
    # the widest tile that fits (tt | 1 pads an even tile by one column)
    tt = max(1, min(T, (budget - 12 * K - 12 * d) // (4 * K + 4)))
    while tt < T and smem(1, tt + 1) <= budget:
        tt += 1
    nb = max(1, min(B, budget // smem(1, tt)))
    n_min = max(1, _cdiv(_MIN_OUTPUTS, d * nb))
    splits = max(1, min(_cdiv(sms * _BLOCKS_PER_SM, _cdiv(B, nb)),
                        N // n_min, 65535))
    n_split = max(1, _cdiv(N, splits))
    splits = max(1, _cdiv(N, n_split))
    return dict(nb=nb, tt=tt, n_split=n_split, splits=splits,
                smem=smem(nb, tt))


def _checked(S_all, ctrl_all, cand, theta_tm, h):
    """(B, K, T, N, d) of the kernel's arguments; raises on a device, dtype,
    shape or size it does not take (any strides are taken)."""
    if cand.dim() != 4:
        raise ValueError(f"cand must be [N, d, B, K], got "
                         f"{tuple(cand.shape)}")
    N, d, B, K = cand.shape
    if K < 1:
        raise ValueError("cand has no noisy slot")
    T = N + 2
    shapes = dict(S_all=(B, K + 1, T), ctrl_all=(B, K + 1, T),
                  theta_tm=(N, d, B))
    given = dict(S_all=S_all, ctrl_all=ctrl_all, cand=cand,
                 theta_tm=theta_tm, h=h)
    dev = cand.device
    for name, t in given.items():
        if t is None and name == "ctrl_all":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cand on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    if tuple(h.shape) not in ((), (B,)):
        raise ValueError(f"h must be [] or [{B}], got {tuple(h.shape)}")
    if N * d * B >= 2**31 or B * (K + 1) >= 2**31:
        raise ValueError(f"{N * d * B} outputs: the kernel indexes them with "
                         "32-bit ints")
    return B, K, T, N, d


def tail(S_all, ctrl_all, w_ctrl, cumulative, cand, theta_tm, h):
    """[N, d, B] of PI²'s tail: the kernel for CUDA tensors,
    :func:`tail_plain` for CPU tensors; raises on any other device. h: a
    float32 tensor, [] or [B], on the card."""
    if cand.device.type == "cpu":
        return tail_plain(S_all, ctrl_all, w_ctrl, cumulative, cand,
                          theta_tm, h)
    if cand.device.type != "cuda":
        raise ValueError(f"the pi2 kernel takes CUDA or CPU tensors, got "
                         f"{cand.device}")
    return _launch(S_all, ctrl_all, w_ctrl, cumulative, cand, theta_tm, h)


def _launch(S_all, ctrl_all, w_ctrl, cumulative, cand, theta_tm, h,
            plan=None):
    """The kernel's launch on the arguments' device: the arguments checked,
    the plan chosen (`plan`, a :func:`_plan` dict, overrides it), the
    output allocated, every tensor handed over in place with its
    strides."""
    B, K, T, N, d = _checked(S_all, ctrl_all, cand, theta_tm, h)
    dev = cand.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan or _plan(B, K, T, d, rollout._sm_count(index))
    out = torch.empty((N, d, B), dtype=torch.float32, device=dev)
    ctrl = ctrl_all if ctrl_all is not None else S_all
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pi2_launch(
            S_all.data_ptr(), None if ctrl_all is None else ctrl.data_ptr(),
            cand.data_ptr(), theta_tm.data_ptr(), h.data_ptr(),
            out.data_ptr(), *S_all.stride(), *ctrl.stride(), *cand.stride(),
            *theta_tm.stride(), h.stride(0) if h.dim() else 0,
            float(w_ctrl), int(bool(cumulative)), B, K, T, d, p["nb"],
            p["tt"], p["n_split"], p["splits"], _lanes(K), stream)
    if err != 0:
        raise RuntimeError(f"pi2 kernel launch failed: CUDA error {err}")
    LAUNCHES["pi2"] += 1
    return out

"""The propose stage of the time-major STOMP step (``csrc/propose.cu``).

From the sampling GEMM's output to the evaluator's input, in one pass:
eps_raw ``[N, d, B, K]`` (``engine/sampling.py`` ``noise_product_tm``,
L·z before the scale), sigma ``[B, d]``, theta ``[B, N, d]``, the reused
rollouts ``[B, Kr, N, d]`` (the solver state's layout), Q0 and QN
``[B, d]`` and the joint limits ``[d]`` become

- cand ``[N, d, B, C]``, C = 1 + K + Kr: slot 0 is θ, slots 1..K are
  θ + σ·eps, the last Kr slots the reused rollouts, every slot clipped to
  the limits where the joint is limited;
- full ``[d, T, B·C]``, T = N + 2: Q0, cand transposed, QN, the layout the
  evaluator reads.

:func:`propose_plain` is those ops as the solver wrote them in PyTorch
(the CPU's route, bitwise the JAX package's); :func:`propose` launches the
kernel for CUDA tensors, bitwise the plain version, and takes the plain
version for CPU tensors only. The library is built by nvcc from the
checkout at first use, as the rollout kernels are (kernels/rollout.py
``build``), with a plain C interface called through ctypes.

``LAUNCHES`` counts the kernel's launches (engine/graph.py moves a
capture's count to the graph's replays, as it does the rollout kernels';
``rollout.reset_launches()`` zeroes it with theirs).
"""

from __future__ import annotations

import ctypes

import torch

from tpustomp_torch.kernels import rollout

LAUNCHES = {"propose": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LOADED: set = set()      # device indices whose module is loaded
_TYPED: set = set()       # ids of the libraries whose entries are typed
_BCAST = (slice(None), None, None)                  # [d] -> [d, 1, 1]


def _library() -> ctypes.CDLL:
    lib = rollout.build(("propose",))[("propose", None)]
    if id(lib) not in _TYPED:
        _TYPED.add(id(lib))
        lib.propose_load.argtypes = [_I]
        lib.propose_launch.argtypes = [_P] * 11 + [_L] * 11 + [_I] * 5 + [_P]
        for fn in (lib.propose_load, lib.propose_launch):
            fn.restype = ctypes.c_int
    return lib


def load(device: torch.device) -> None:
    """Build the library and load its kernel on `device`, outside any
    capture."""
    index = torch.device(device).index or 0
    if index not in _LOADED:
        rc = _library().propose_load(index)
        if rc != 0:
            raise RuntimeError(f"propose_load failed: CUDA error {rc}")
        _LOADED.add(index)


def candidates_plain(eps_tm, theta, reuse):
    """cand [N, d, B, C] before the clip: θ, θ + eps_tm, the reused
    rollouts (eps_tm [N, d, B, K] already scaled)."""
    theta_tm = theta.permute(1, 2, 0)                     # [N, d, B]
    return torch.cat([theta_tm[..., None], theta_tm[..., None] + eps_tm,
                      reuse.permute(2, 3, 0, 1)], dim=3)


def full_plain(cand, Q0, QN):
    """full [d, T, B·C]: Q0, cand [N, d, B, C] transposed, QN."""
    N, d, B, C = cand.shape
    q0 = Q0.t()[:, None, :, None].expand(d, 1, B, C)
    qN = QN.t()[:, None, :, None].expand(d, 1, B, C)
    return torch.cat([q0, cand.permute(1, 0, 2, 3), qN],
                     dim=1).reshape(d, N + 2, B * C)


def propose_plain(eps_raw, sigma, theta, reuse, Q0, QN, lower, upper,
                  limited):
    """(cand, full) in plain PyTorch: the kernel's specification."""
    eps_tm = eps_raw * sigma.t()[None, :, :, None]
    cand = candidates_plain(eps_tm, theta, reuse)
    cand = torch.where(limited[_BCAST],
                       torch.clamp(cand, lower[_BCAST], upper[_BCAST]), cand)
    return cand, full_plain(cand, Q0, QN)


def _checked(eps_raw, sigma, theta, reuse, Q0, QN, lower, upper, limited):
    """(N, d, B, K, Kr) of the kernel's arguments; raises on a device,
    dtype, shape or layout it does not take."""
    if eps_raw.dim() != 4:
        raise ValueError(f"eps_raw must be [N, d, B, K], got "
                         f"{tuple(eps_raw.shape)}")
    N, d, B, K = eps_raw.shape
    if reuse.dim() != 4:
        raise ValueError(f"reuse must be [B, Kr, N, d], got "
                         f"{tuple(reuse.shape)}")
    Kr = reuse.shape[1]
    shapes = dict(eps_raw=(N, d, B, K), sigma=(B, d), theta=(B, N, d),
                  reuse=(B, Kr, N, d), Q0=(B, d), QN=(B, d), lower=(d,),
                  upper=(d,), limited=(d,))
    given = dict(eps_raw=eps_raw, sigma=sigma, theta=theta, reuse=reuse,
                 Q0=Q0, QN=QN, lower=lower, upper=upper, limited=limited)
    dev = eps_raw.device
    for name, t in given.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, eps_raw on {dev}")
        want = torch.bool if name == "limited" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    # theta, reuse, Q0 and QN are read through their strides; the rest are
    # read as contiguous runs
    for name in ("eps_raw", "sigma", "lower", "upper", "limited"):
        if not given[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{given[name].stride()}")
    if B * (1 + K + Kr) + 1024 >= 2**31 or N * d + 2 * d >= 2**31:
        raise ValueError(f"B·C = {B * (1 + K + Kr)} columns: the kernel "
                         "indexes a row with 32-bit ints")
    return N, d, B, K, Kr


def propose(eps_raw, sigma, theta, reuse, Q0, QN, lower, upper, limited):
    """(cand [N, d, B, C], full [d, T, B·C]) of the propose stage: the
    kernel for CUDA tensors, :func:`propose_plain` for CPU tensors."""
    if eps_raw.device.type == "cpu":
        return propose_plain(eps_raw, sigma, theta, reuse, Q0, QN, lower,
                             upper, limited)
    N, d, B, K, Kr = _checked(eps_raw, sigma, theta, reuse, Q0, QN, lower,
                              upper, limited)
    dev = eps_raw.device
    C = 1 + K + Kr
    cand = torch.empty((N, d, B, C), dtype=torch.float32, device=dev)
    full = torch.empty((d, N + 2, B * C), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.propose_launch(
            eps_raw.data_ptr(), sigma.data_ptr(), theta.data_ptr(),
            reuse.data_ptr(), Q0.data_ptr(), QN.data_ptr(),
            lower.data_ptr(), upper.data_ptr(), limited.data_ptr(),
            cand.data_ptr(), full.data_ptr(), *theta.stride(),
            *reuse.stride(), *Q0.stride(), *QN.stride(), N, d, B, K, Kr,
            stream)
    if err != 0:
        raise RuntimeError(f"propose kernel launch failed: CUDA error {err}")
    LAUNCHES["propose"] += 1
    return cand, full

"""PI² probability weighting and parameter update (port of
``tpustomp/engine/pi2.py``).

Contract: SURVEY Appendix A.9 (per-timestep min-max normalized,
exponentiated-cost softmax over rollouts) and A.10 (probability-weighted
noise average smoothed through M = column-scaled R⁻¹).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def probabilities(S: torch.Tensor, h) -> torch.Tensor:
    """S [..., K, N] per-rollout per-timestep state cost -> P [..., K, N].

    P_k(t) = exp(-h·S̃_k(t)) / Σ_k' exp(-h·S̃_k'(t)), S̃ min-max normalized
    per timestep over the rollout axis (-2). h: scalar, or a tensor that
    broadcasts against S[..., :1, :1] (per-scenario sensitivity).
    """
    lo = S.amin(dim=-2, keepdim=True)
    hi = S.amax(dim=-2, keepdim=True)
    S_norm = (S - lo) / (hi - lo + _EPS)
    e = torch.exp(-h * S_norm)
    return e / e.sum(dim=-2, keepdim=True)


def update(eps: torch.Tensor, S: torch.Tensor, M: torch.Tensor,
           h: float) -> torch.Tensor:
    """eps [K, N, d], S [K, N] -> δθ [N, d] = M Σ_k P_k ⊙ ε_k (A.10)."""
    P = probabilities(S, h)
    delta = torch.einsum("kn,knd->nd", P, eps)
    return M @ delta


def update_tm(eps_tm: torch.Tensor, S: torch.Tensor, M: torch.Tensor,
              h: float) -> torch.Tensor:
    """Batched A.9/A.10 on time-major noise: eps_tm [N, d, B, K],
    S [B, K, N] -> δθ [B, N, d]. The readable specification that
    :func:`update_tm_cand` is tested against."""
    P = probabilities(S, h)                                    # [B, K, N]
    delta = torch.einsum("bkn,ndbk->ndb", P, eps_tm)
    delta = torch.einsum("nm,mdb->ndb", M, delta)
    return delta.permute(2, 0, 1)


def weighted_candidates(cand_tm: torch.Tensor, theta_tm: torch.Tensor,
                        S: torch.Tensor, h) -> torch.Tensor:
    """Σ_k P_k·ε_k without materializing the re-centered noise:
    Σ_k P_k·cand_k − θ·Σ_k P_k.

    cand_tm [N, d, B, K] (noisy candidate slots only), theta_tm [N, d, B],
    S [B, K, N] -> [N, d, B], before the smoothing by M. h: scalar or [B].
    On the card kernels/pi2.py computes it in one kernel.
    """
    h_arr = torch.as_tensor(h, dtype=torch.float32, device=S.device)
    h_arr = h_arr.expand(S.shape[0])[:, None, None]
    P = probabilities(S, h_arr)                                # [B, K, N]
    wavg = torch.einsum("bkn,ndbk->ndb", P, cand_tm)
    psum = torch.sum(P, dim=1).t()                             # [N, B]
    return wavg - theta_tm * psum[:, None, :]


def smooth_tm(delta: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """M·delta over the waypoints: delta [N, d, B] -> δθ [B, N, d]."""
    return torch.einsum("nm,mdb->ndb", M, delta).permute(2, 0, 1)


def update_tm_cand(cand_tm: torch.Tensor, theta_tm: torch.Tensor,
                   S: torch.Tensor, M: torch.Tensor, h) -> torch.Tensor:
    """`update_tm` without materializing the re-centered noise
    (:func:`weighted_candidates`, then M).

    cand_tm [N, d, B, K] (noisy candidate slots only), theta_tm [N, d, B],
    S [B, K, N] -> δθ [B, N, d]. h: scalar or [B].
    """
    return smooth_tm(weighted_candidates(cand_tm, theta_tm, S, h), M)

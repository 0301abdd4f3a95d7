"""Noisy rollout generation: ε = σ · L z with z standard normal (A.3)
(port of ``tpustomp/engine/sampling.py``).

The samplers take the standard-normal block `z` as an argument; where z
comes from is the caller's choice. The solver's default source is
:func:`draw_z`: ONE ``torch.randn`` of shape [d, B, K, N] per iteration from
an explicit ``torch.Generator``, drawn for the whole batch. The draw's shape
does not depend on which scenarios are done, so scenarios that froze never
change the noise the active ones get (the hazard documented at the JAX
package's ``rbg_block_key``).

The bits differ from the JAX package's threefry stream: same distribution
(iid normals), different numbers. Tests that need equal noise hand both
sides the same z (they redraw JAX's z from its keys and pass it in).
"""

from __future__ import annotations

import torch


def draw_z(generator: torch.Generator, d: int, B: int, K: int, N: int,
           device) -> torch.Tensor:
    """The default noise source: z [d, B, K, N] ~ N(0, 1), float32."""
    return torch.randn((d, B, K, N), generator=generator, device=device,
                       dtype=torch.float32)


def draw_hmc(generator: torch.Generator, d: int, B: int, N: int, device):
    """HMC's draws for one iteration: momentum normals z [d, B, 1, N] and
    Metropolis uniforms u [B] in [0, 1), float32."""
    return (draw_z(generator, d, B, 1, N, device),
            torch.rand((B,), generator=generator, device=device,
                       dtype=torch.float32))


class GeneratorNoise:
    """The solver's default noise source as a noise_fn: every call draws
    one iteration's noise from `generator`, :func:`draw_z` of [d, B, K, N],
    or with hmc=True :func:`draw_hmc`'s (z [d, B, 1, N], u [B]); `active`
    is not read. :meth:`into` writes the same draw into given tensors (a
    graph's input buffers, engine/graph.py), with no copy."""

    def __init__(self, generator: torch.Generator, d: int, B: int, K: int,
                 N: int, device, hmc: bool = False):
        self.generator, self.hmc = generator, hmc
        self.d, self.B, self.K, self.N, self.device = d, B, K, N, device

    def __call__(self, iteration, active):
        if self.hmc:
            return draw_hmc(self.generator, self.d, self.B, self.N,
                            self.device)
        return draw_z(self.generator, self.d, self.B, self.K, self.N,
                      self.device)

    def into(self, iteration, active, out) -> None:
        """The next draw written into `out`, (z,) or (z, u), contiguous
        float32 tensors of the draw's shapes: the same numbers a call
        returns."""
        torch.randn(out[0].shape, generator=self.generator, out=out[0])
        if self.hmc:
            torch.rand(out[1].shape, generator=self.generator, out=out[1])


def shard_noise(noise_fn, lo: int, hi: int, total: int):
    """A global batch's noise_fn as the shard of rows [lo, hi) of `total`
    sees it: noise_fn itself when the shard is the whole batch. The wrapper
    is called with the shard's active mask (after any leading arguments, as
    MPC's tick); noise_fn gets the global mask (rows of other shards marked
    done) and its draw is cut to the shard's rows. Handles STOMP's
    z [d, B, K, N] and HMC's (z [d, B, 1, N], u [B])."""
    if hi - lo == total:
        return noise_fn

    def cut(*args):
        *lead, active = args
        full = torch.zeros(total, dtype=torch.bool, device=active.device)
        full[lo:hi] = active
        out = noise_fn(*lead, full)
        if isinstance(out, tuple):
            z, u = out
            return z[:, lo:hi], u[lo:hi]
        return out[:, lo:hi]

    return cut


def sample_noise(z: torch.Tensor, L: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
    """ε [K, N, d] = σ_j · L z_kj for z [d, K, N] and sigma [d] (A.3).

    Endpoints are exactly zero by construction: L acts on free waypoints
    only."""
    return torch.einsum("nm,dkm->knd", L, z) * sigma[None, None, :]


def sample_noise_tm(z: torch.Tensor, L: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """Batched TIME-MAJOR draw: z [d, B, K, N], sigma [B, d] (per-scenario
    decay folded in by the caller) -> ε_tm [N, d, B, K], the evaluator's
    layout. Per scenario equal to :func:`sample_noise` transposed."""
    eps = torch.einsum("nm,dbkm->ndbk", L, z)
    return eps * sigma.t()[None, :, :, None]

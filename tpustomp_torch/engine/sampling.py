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

A source whose draw is a generator's draw, cut or not (:class:`GeneratorNoise`,
:func:`shard_noise` of one, the compacted solver's rows of one, MPC's
per-tick draws), describes it as a :class:`DrawPlan` (:func:`draw_plan`):
the solver's graphed chunks (engine/graph.py) then draw inside the graph,
from a generator of the graph's own set to the source's state. A caller's
own ``noise_fn`` has no plan: its draws stay on the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DrawPlan:
    """One iteration's draw as a generator makes it: ``shapes[0]`` the
    normals z [d, total, K, N] of the whole (global) batch, then with HMC
    ``shapes[1]`` the uniforms u [total], drawn in that order from
    `generator`; the solve gets the rows [lo, hi) of them and, where
    `rows` is given (an int64 index into those rows), just these."""

    generator: torch.Generator
    shapes: tuple
    lo: int
    hi: int
    rows: torch.Tensor | None = None

    def cut(self) -> bool:
        """The solve takes some rows of the draw, not all."""
        return self.rows is not None or self.hi - self.lo != self.shapes[0][1]

    def index(self, device) -> torch.Tensor:
        """The rows the solve takes, as an index into the whole draw."""
        if self.rows is None:
            return torch.arange(self.lo, self.hi, device=device)
        return self.rows.to(device) + self.lo

    def key(self) -> tuple:
        """What a graph of these draws bakes in: the shapes and the number
        of rows it takes (which rows is an input)."""
        return (self.shapes, self.cut(),
                self.hi - self.lo if self.rows is None else self.rows.numel())


def draw_plan(noise_fn) -> DrawPlan | None:
    """noise_fn's DrawPlan, or None for a source with none."""
    fn = getattr(noise_fn, "draw_plan", None)
    return None if fn is None else fn()


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

    def draw_plan(self) -> DrawPlan:
        shapes = ((self.d, self.B, 1 if self.hmc else self.K, self.N),)
        if self.hmc:
            shapes += ((self.B,),)
        return DrawPlan(self.generator, shapes, 0, self.B)


class _Shard:
    """shard_noise's wrapper: called with the shard's active mask (after
    any leading arguments), it calls the source with the global mask and
    cuts the draw to rows [lo, hi)."""

    def __init__(self, noise_fn, lo: int, hi: int, total: int):
        self.source, self.lo, self.hi, self.total = noise_fn, lo, hi, total

    def __call__(self, *args):
        *lead, active = args
        full = torch.zeros(self.total, dtype=torch.bool,
                           device=active.device)
        full[self.lo:self.hi] = active
        out = self.source(*lead, full)
        if isinstance(out, tuple):
            z, u = out
            return z[:, self.lo:self.hi], u[self.lo:self.hi]
        return out[:, self.lo:self.hi]

    def draw_plan(self) -> DrawPlan | None:
        plan = draw_plan(self.source)
        if plan is None or (plan.lo, plan.hi) != (0, self.total):
            return None
        return dataclasses.replace(plan, lo=self.lo, hi=self.hi)


def shard_noise(noise_fn, lo: int, hi: int, total: int):
    """A global batch's noise_fn as the shard of rows [lo, hi) of `total`
    sees it: noise_fn itself when the shard is the whole batch. The wrapper
    is called with the shard's active mask (after any leading arguments, as
    MPC's tick); noise_fn gets the global mask (rows of other shards marked
    done) and its draw is cut to the shard's rows. Handles STOMP's
    z [d, B, K, N] and HMC's (z [d, B, 1, N], u [B]). A source with a
    DrawPlan keeps one: the same draw, cut."""
    if hi - lo == total:
        return noise_fn
    return _Shard(noise_fn, lo, hi, total)


class TiledNoise:
    """A noise_fn of n rows tiled `times` over a batch of times·n rows (row
    g·n + i gets row i's draw; the source gets the first n rows' active
    mask): tune's cells, each the same problems under the same noise."""

    def __init__(self, noise_fn, n: int, times: int):
        self.source, self.n, self.times = noise_fn, n, times

    def __call__(self, iteration, active):
        out = self.source(iteration, active[:self.n])
        return out.repeat(1, self.times, 1, 1)

    def draw_plan(self) -> DrawPlan | None:
        plan = draw_plan(self.source)
        if plan is None or plan.rows is not None or len(plan.shapes) != 1:
            return None
        rows = torch.arange(self.n * self.times,
                            device=plan.generator.device) % self.n
        return dataclasses.replace(plan, rows=rows)


class RowNoise:
    """The full batch's noise_fn as the rows `rows` (an index tensor) see
    it: called with their active mask, it calls the source with the
    full-B mask (the other rows done) and cuts the draw to those rows (the
    compacted solver's buckets, engine/solver.py)."""

    def __init__(self, noise_fn, rows: torch.Tensor, B: int):
        self.source, self.rows, self.B = noise_fn, rows, B

    def __call__(self, iteration, active):
        full = torch.zeros(self.B, dtype=torch.bool, device=active.device)
        out = self.source(iteration, full.index_copy_(0, self.rows, active))
        if isinstance(out, tuple):
            z, u = out
            return z[:, self.rows], u[self.rows]
        return out[:, self.rows]

    def draw_plan(self) -> DrawPlan | None:
        plan = draw_plan(self.source)
        if plan is None or plan.rows is not None:
            return None
        return dataclasses.replace(plan, rows=self.rows)


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
    return noise_product_tm(z, L) * sigma.t()[None, :, :, None]


def noise_product_tm(z: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """L z of a batched time-major draw, before the scale: z [d, B, K, N]
    -> [N, d, B, K] (the propose kernel, kernels/propose.py, scales it)."""
    return torch.einsum("nm,dbkm->ndbk", L, z)

"""CUDA graphs of the port: its counterpart of the JAX package's compiled
programs, and the one owner of their cache.

JAX runs a batched solve as one device program, compiled once per (config,
shapes) and cached: ``_jitted_solve_batch`` (``tpustomp/api/plan.py:177-211``)
holds ``_init_batch``, the ``lax.while_loop`` of ``solver.solve_batch``
(``tpustomp/engine/solver.py:827-849``), ``_finalize_batch`` and
``select_best``; the compacted path runs ``_jitted_chunk_batch`` a chunk;
``_jitted_goal`` picks a goal in its band; MPC's ``lax.scan`` body is a
tick. The port captures the same programs as CUDA graphs over static
buffers and replays them. Its callers see this interface:

- :func:`run` (``solver.run_until``), :func:`solve` (``solve_batch``,
  ``solve_batch_compacted``, ``plan_timed``) and :func:`goal` (the goal
  band) each make the graph-or-eager choice themselves
  (:func:`eager_reason`) and run the eager path in its cases: a CPU step,
  ``utils.tracing.debug_mode`` (the state checked after every
  iteration), keyed tensors moved under ``torch.inference_mode``, a robot
  whose joint types only the device holds, and :func:`eager` around any
  entry point. :func:`solve`'s ``loop`` callback drives a :class:`Handle`
  (the solve's state and its loop, graphed or eager), so a caller writes
  its loop once.
- A cache entry (:class:`Entry`: a solve shape, a goal band, an MPC tick)
  is a set of named regions (:class:`Region`) over static buffers and the
  entry's own copies of the robot, DeviceOps, shared world and
  constraints. Every kind goes through one protocol: :func:`entry` opens
  it (lock, lookup, the caller's builder on a miss, caching once a
  capture succeeded, the release event), :func:`load` is a hit's input
  load, and :func:`ready` settles a new loop eagerly and captures it. A
  program with a loop holds a :class:`Loop` (its static solver state and
  the loop region); engine/mpc.py builds the tick's entry on this
  interface and keeps only the tick's own regions.

The loop has two routes, chosen before anything runs (:func:`route`):

- "chunk" (the default noise): one graph of :data:`CHUNK` iterations (the
  compacted path's ``chunk``), each under a conditional IF node
  (kernels/graph_if.py) whose condition ``ctl[0]`` is ``any(~done) &
  (count < limit)``, on the device. A body draws its noise inside the
  graph from the entry's own generator, set to the source's state before
  the replays (``sampling.DrawPlan``), advances, and counts ``ctl[1]``.
  The host queues chunk j+1 before it reads chunk j's ``ctl`` (pinned
  memory and an event): at most ceil(iterations / CHUNK) + 1 reads a
  solve. The source's generator is then moved as far as the eager loop
  moves it (one iteration's offset advance, measured at the first eager
  draw, times the iterations run).
- One iteration a replay, the draw on the host and one read of the
  condition after it: a caller's own noise_fn ("per_iteration:noise_fn")
  and :func:`per_iteration` ("per_iteration:requested"). A CHOMP
  iteration is two regions here: its gradient (the "grad" region, under
  a ``chomp.grad`` span) and the update from it.

Capture (a miss): the loop's first iteration runs eagerly on the stream
the loop is captured from (it builds the kernel libraries, settles every
parameter route and that stream's cuBLAS workspace), and one more
("param_read") while it deferred a parameter read (kernels/rollout.py
``_launch_params``); then the loop is captured. The other regions
(solve-in: ``_init_batch``; solve-out: finalize, with restarts the best's
choice; the goal band; tick-in and tick-out) run eagerly on the capture
stream and are captured after. A chunk's bodies are captured on one body
stream into one pool of their own. A capture or a replay that raises is an
error; nothing falls back.

Cache: one entry per kind, config and shapes, device, loop route (and the
draw's shapes and cut), the robot and DeviceOps (each tensor by identity
and ``_version``, held weakly: an entry whose tensors are gone is dropped
at the next call) and the world's and constraints' types and shapes; at
most :data:`LIMIT` entries, least recently used first out. The world and
the constraints are inputs, as JAX's jit takes them: a call copies their
tensors into the entry's copies where they are not the ones the copies
last took (by identity and version; the copies take their sources' host
copies), and every captured evaluator node whose by-value parameter block
moved gets the new block (kernels/graph_node.py, :func:`_rewrite`). A
per-scenario world's rows are loaded like the state. What a graph
freezes otherwise comes from the robot, which the key names, and from
shapes; a write that moves no version is not seen. Results never alias
the graph.

Counters: the kernel wrappers' host counts (``rollout.LAUNCHES``,
``PARAM_ROUTES``, ``LAYOUTS``, ``BODY_ORDER``, ``propose.LAUNCHES``,
``chomp_grad.LAUNCHES``, ``pi2.LAUNCHES``) that a capture added move to
its region's replays, and a chunk adds one iteration's share per
iteration run, so a graphed run counts what the eager loop counts.
:data:`GRAPHS` counts the rest.

Graphed programs of one process run one at a time (a lock); an entry's
next load waits for the device work of its last call (an event), so calls
on different streams stay ordered.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import threading
import time
import weakref
from typing import Callable

import numpy as np
import torch

from tpustomp_torch._tensors import (clone_with_mirrors, copy_with_mirror,
                                     fields, map_tensors)
from tpustomp_torch.engine.sampling import draw_plan
from tpustomp_torch.kernels import (chomp_grad, graph_if, graph_node, pi2,
                                    propose, rollout)
from tpustomp_torch.robot.model import joint_types_on_host
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import CompositeWorld

# Most entries cached at once (a config-4 entry's pools are about a GB).
LIMIT = 8

# Iterations a chunk holds: config 5's max_iterations, so an MPC tick's
# solve is one chunk (the compacted path's chunks hold its `chunk`).
CHUNK = 8

# Regions captured (a solve's loop, solve-in and solve-out; an MPC tick's
# three; a goal band's one) and replayed; entries evicted (LIMIT),
# invalidated (a robot's or DeviceOps' version moved) or dead (a tensor of
# the key is gone); input tensors copied into an entry ("inputs_loaded")
# and parameter blocks rewritten in captured nodes ("node_updates"); the
# iterations each route ran ("chunk", "per_iteration:noise_fn",
# "per_iteration:requested"); the host's reads of the loop's condition
# ("flag_reads"); and iterations run eagerly by reason: "first_iteration"
# (the iteration before a capture, or before replays from a state whose
# strides differ from the graph's), "param_read" (the one after a first
# iteration that deferred a parameter read) and the reasons of
# eager_reason.
GRAPHS = collections.Counter()

_ENABLED = contextvars.ContextVar("tpustomp_torch_graphs", default=True)
_PER_ITERATION = contextvars.ContextVar("tpustomp_torch_per_iteration",
                                        default=False)
# the body pool of the chunk being captured: [] until its first IF node
_BODY_POOL = contextvars.ContextVar("tpustomp_torch_body_pool", default=None)
_CACHE: collections.OrderedDict = collections.OrderedDict()
_DEAD: list = []        # keys of graphs a tensor of which is gone
_STREAMS: dict = {}
_LOCK = threading.RLock()
_COUNTERS = (rollout.LAUNCHES, rollout.PARAM_ROUTES, rollout.LAYOUTS,
             rollout.BODY_ORDER, propose.LAUNCHES, chomp_grad.LAUNCHES,
             pi2.LAUNCHES)


@contextlib.contextmanager
def eager():
    """Run the solver loop, and the MPC tick around it, eagerly inside the
    block (reason "requested"): the comparison the smoke and the card
    tests make."""
    token = _ENABLED.set(False)
    try:
        yield
    finally:
        _ENABLED.reset(token)


@contextlib.contextmanager
def per_iteration():
    """Inside the block, graphed loops replay one iteration a replay, the
    draw on the host and one read of the loop's condition after each (the
    route of a caller's own noise_fn; "per_iteration:requested"): the
    comparison the smoke and the card tests make against the chunks."""
    token = _PER_ITERATION.set(True)
    try:
        yield
    finally:
        _PER_ITERATION.reset(token)


def eager_reason(device, robot, ops=None, world=None,
                 constraints=()) -> str | None:
    """Why a program on `device` over `robot`, DeviceOps `ops` and the
    shared world and constraints (its inputs) runs eagerly, or None when
    it replays graphs."""
    if not _ENABLED.get():
        return "requested"
    if tracing.debug_enabled():
        return "debug_mode"
    tensors = []
    _skeleton((robot, ops, world, tuple(constraints)), tensors)
    if any(t.is_inference() for t in tensors):
        return "inference_tensors"
    if not joint_types_on_host(robot):
        return "joint_types_on_card"
    if device.type != "cuda":
        return "cpu"
    return None


def _why(step) -> str | None:
    return eager_reason(step.Q0.device, step.robot, step.ops,
                        _shared(step.world, step.world_batched),
                        step.constraints)


def route(kind: str, noise_fn) -> str:
    """How a graphed loop of a step of `kind` drawing from `noise_fn`
    runs: "chunk" (CHUNK iterations a replay under IF nodes, the draws in
    the graph), or one iteration a replay, by reason:
    "per_iteration:noise_fn" (a noise_fn without a DrawPlan: a caller's
    own draws stay on the host) or "per_iteration:requested" (inside
    :func:`per_iteration`)."""
    if _PER_ITERATION.get():
        return "per_iteration:requested"
    if kind != "chomp" and draw_plan(noise_fn) is None:
        return "per_iteration:noise_fn"
    return "chunk"


@dataclasses.dataclass(eq=False, kw_only=True)
class Region:
    """One captured region: its CUDA graph, what one replay adds to each
    counter, its evaluator nodes and what its capture cost. `region` names
    it in the spans: solve-in, chunk, iteration, grad, solve-out, goal,
    tick-in, tick-out."""

    region: str = ""
    graph: object = None      # torch.cuda.CUDAGraph (its graph kept)
    counts: tuple = ()        # what one replay adds to each counter
    nodes: list = dataclasses.field(default_factory=list)  # graph_node.Node
    pool_bytes: int = 0
    capture_ms: float = 0.0
    instantiate_ms: float = 0.0
    replays: int = 0

    def replay(self) -> None:
        # no CUDA events here: a pair a replay cost ≈ 35 µs of host time on
        # an H100 host, 2 % of a single query's 8.4 ms; mpc.tick has them
        with tracing.span("graph.replay", region=self.region):
            self.graph.replay()
        for c, add in zip(_COUNTERS, self.counts):
            for k, n in add.items():
                c[k] += n
        self.replays += 1
        GRAPHS["replayed"] += 1

    def cost(self) -> dict:
        return dict(pool_bytes=self.pool_bytes, capture_ms=self.capture_ms,
                    instantiate_ms=self.instantiate_ms,
                    replays=self.replays)


@dataclasses.dataclass(eq=False, kw_only=True)
class _Stage(Region):
    """A region that runs fn(owner) over the owner's static buffers and
    keeps what it returns: solve-in, solve-out, the goal band, the grad."""

    owner: object
    fn: Callable
    out: object = None

    def body(self) -> None:
        self.out = self.fn(self.owner)

    def buffers(self) -> list:
        return self.owner.buffers()


@dataclasses.dataclass(eq=False, kw_only=True)
class Entry:
    """One cached graphed program: its regions by name (`parts`, the
    names :func:`cached` reports), its loop (a :class:`Loop`, or None),
    other static buffers, and its own copies of the keyed robot and
    DeviceOps and of its inputs, the shared world and the constraints.
    :func:`entry` sets its identity in the cache (key, weak references
    and versions of the keyed tensors, the inputs its copies hold last)
    and the event after its last call's work."""

    kind: str
    device: torch.device
    batch: tuple
    robot: object = None
    ops: object = None
    world: object = None
    constraints: tuple = ()
    loop: Loop | None = None
    static: list = dataclasses.field(default_factory=list)
    parts: dict = dataclasses.field(default_factory=dict)
    key: tuple = ()
    refs: tuple = ()
    versions: tuple = ()
    held: tuple = ()          # (weak ref, version) of the inputs loaded last
    released: object = None   # event after the last call's use, or None

    def regions(self) -> tuple:
        return tuple(self.parts.values())

    def buffers(self) -> list:
        """Every static buffer: what a call loads and the regions write."""
        return [*self.static,
                *(() if self.loop is None else self.loop.buffers())]

    def inputs(self) -> list:
        """The tensors of the entry's copies of its inputs."""
        return _inputs(self.world, self.constraints)

    def info(self) -> dict:
        regions = {name: r.cost() for name, r in self.parts.items()}
        loop = self.loop
        return dict(kind=self.kind,
                    route=None if loop is None else loop.route,
                    k=None if loop is None else loop.k,
                    batch=self.batch,
                    static_bytes=_nbytes(self.buffers(), (
                        self.robot, self.world, self.constraints, self.ops)),
                    **{k: sum(r[k] for r in regions.values())
                       for k in ("pool_bytes", "capture_ms",
                                 "instantiate_ms")},
                    replays=(self.regions()[0] if loop is None
                             else loop).replays,
                    regions=regions)


@dataclasses.dataclass(eq=False, kw_only=True)
class Loop(Region):
    """A program's solver loop: its region (a chunk, or one iteration)
    over the static buffers of one solve shape, and the step over them
    and over the entry's copies (:meth:`over`)."""

    kind: str
    route: str                # "chunk" or "per_iteration:<reason>"
    k: int                    # iterations a chunk holds
    Q0: torch.Tensor          # the static buffers: Q0, the goal wrapped
    QN: torch.Tensor          # (the loop's) and before wrapping (solve-in's
    QN_in: torch.Tensor       # input), the HyperParams rows
    hyper: object
    state: object             # the static SolverState
    draws: tuple              # the draws' buffers (Step.draw_shapes)
    active: torch.Tensor      # ~state.done, for the host's next draw
    finished: torch.Tensor    # state.done.all(), the host's condition
    ctl: torch.Tensor         # int32 [2]: the device's condition, count
    limit: torch.Tensor       # int32 []: the count the loop stops at
    host: torch.Tensor        # int32 [2, 2]: ctl's copies (pinned)
    full: tuple = ()          # the whole batch's draw, when cut
    rows: torch.Tensor | None = None  # the rows of it the solve takes
    gen: torch.Generator | None = None  # the chunk's own generator
    inc: int | None = None    # its Philox offset advance an iteration
    per_it: tuple = ()        # what a chunk iteration adds to each counter
    theta0: torch.Tensor | None = None  # solve-in's warm start
    step: object = None       # the Step over the buffers and copies
    grad: torch.Tensor | None = None  # ∇U between a CHOMP iteration's
    grad_region: _Stage | None = None  # regions (per-iteration route)

    def __post_init__(self) -> None:
        self.region = "chunk" if self.route == "chunk" else "iteration"

    @classmethod
    def over(cls, step, state, k: int = CHUNK, QN=None,
             own=clone_with_mirrors) -> Loop:
        """The loop of `step` from `state` (QN: the wrapped goal where
        step.QN is the goal before wrapping), in chunks of k on the chunk
        route: static buffers, and its step over them and over `own`'s
        copies of the robot, world, constraints and DeviceOps (by default
        clones with their host copies: the entry holds nothing of the
        caller's but weak references, and its step keeps what the captured
        kernels read for as long as it may replay)."""
        dev = step.Q0.device
        how = route(step.kind, step.noise_fn)
        hyper = (None if step.hyper is None
                 else map_tensors(step.hyper, torch.clone))
        plan = (draw_plan(step.noise_fn)
                if how == "chunk" and step.kind != "chomp" else None)
        cut = plan is not None and plan.cut()
        g = cls(kind=step.kind, route=how, k=k, Q0=step.Q0.clone(),
                QN=(step.QN if QN is None else QN).clone(),
                QN_in=step.QN.clone(), hyper=hyper,
                state=map_tensors(state, torch.clone),
                draws=tuple(torch.empty(shape, dtype=torch.float32,
                                        device=dev)
                            for shape in step.draw_shapes()),
                active=torch.empty_like(state.done),
                finished=torch.empty((), dtype=torch.bool, device=dev),
                ctl=torch.zeros(2, dtype=torch.int32, device=dev),
                limit=torch.zeros((), dtype=torch.int32, device=dev),
                host=torch.zeros((2, 2), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda"),
                full=(tuple(torch.empty(s, dtype=torch.float32, device=dev)
                            for s in plan.shapes) if cut else ()),
                rows=plan.index(dev).clone() if cut else None,
                gen=None if plan is None else torch.Generator(device=dev))
        g.step = step.over(
            Q0=g.Q0, QN=g.QN, hyper=hyper, noise_fn=None,
            robot=own(step.robot),
            world=_static_world(step.world, step.world_batched, own),
            constraints=tuple(map(own, step.constraints)),
            ops=own(step.ops))
        if how != "chunk" and getattr(g.step.advance, "phases", None):
            g.grad = torch.empty_like(g.state.theta)
        return g

    def iteration(self) -> None:
        """The per-iteration region: advance (with a grad buffer, CHOMP's
        update from the gradient the grad region left in it), the new
        state copied into the static state, then what the host reads
        before the next iteration (the draw's active rows, the loop's
        condition), so it launches nothing of its own for them."""
        draws = (self.draws[0] if self.kind == "stomp"
                 else self.draws if self.kind == "hmc" else None)
        if self.grad is None:
            self._advance(draws)
        else:
            self._store(self.step.advance.phases[1](self.state, self.grad))
        torch.logical_not(self.state.done, out=self.active)
        self.finished.copy_(self.state.done.all())

    def chunk(self) -> None:
        """The chunk region: the loop's condition, then k iterations, each
        under an IF node on it."""
        self._go()
        for _ in range(self.k):
            _if_node(self.ctl[0], self._body)

    def _body(self) -> None:
        """One chunk iteration: the draw, advance, the count and the
        condition for the next."""
        self._advance(self.draw())
        self.ctl[1].add_(1)
        self._go()

    def _advance(self, draws) -> None:
        self._store(self.step.advance(self.state, draws))

    def _grad(self) -> None:
        """The grad region: ∇U of the static state into the grad buffer."""
        self.grad.copy_(self.step.advance.phases[0](self.state.theta))

    def _store(self, new) -> None:
        for f in dataclasses.fields(self.state):
            getattr(self.state, f.name).copy_(getattr(new, f.name))

    def _go(self) -> None:
        torch.logical_and(torch.logical_not(self.state.done).any(),
                          torch.lt(self.ctl[1], self.limit),
                          out=self.ctl[0])

    def draw(self):
        """The iteration's draw from the chunk's generator into the draws'
        buffers (through the whole batch's, when the solve takes a cut)."""
        if self.kind == "chomp":
            return None
        bufs = self.full or self.draws
        torch.randn(bufs[0].shape, generator=self.gen, out=bufs[0])
        if self.kind == "hmc":
            torch.rand(bufs[1].shape, generator=self.gen, out=bufs[1])
        for buf, v, dim in zip(self.draws, self.full, (1, 0)):
            torch.index_select(v, dim, self.rows, out=buf)
        return self.draws[0] if self.kind == "stomp" else self.draws

    def rows_world(self):
        """The static buffers of a per-scenario world's rows, or None."""
        return _rows(self.step.world, self.step.world_batched)

    def buffers(self) -> list:
        rows = self.rows_world()
        return [*self.draws, *fields(self.state), self.active,
                self.finished, self.ctl, self.limit, self.Q0, self.QN,
                self.QN_in, *self.full,
                *(() if self.rows is None else (self.rows,)),
                *(() if self.theta0 is None else (self.theta0,)),
                *(() if self.grad is None else (self.grad,)),
                *(() if self.hyper is None else fields(self.hyper)),
                *(() if rows is None else fields(rows))]

    def iterate(self, step, it_limit: int, count: int) -> int:
        """Per-iteration replays from the loaded state until every row is
        done or the count reaches it_limit: each the draw of `step` into
        the draws' buffers, one replay (a CHOMP iteration's grad region
        first, under a `chomp.grad` span) and the read of the loop's
        condition. Returns the count."""
        start = count
        while True:
            step.draw_into(count, self.active, self.draws)
            if self.grad_region is not None:
                with tracing.span("chomp.grad", device=True):
                    self.grad_region.replay()
            self.replay()
            count += 1
            GRAPHS["flag_reads"] += 1
            if count >= it_limit or _finished(self):
                GRAPHS[self.route] += count - start
                return count

    def tally(self, n: int) -> None:
        """n iterations of chunk replays ran: one iteration's share of
        the kernel counters n times, and GRAPHS["chunk"]."""
        for c, add in zip(_COUNTERS, self.per_it):
            for name, v in add.items():
                c[name] += v * n
        GRAPHS["chunk"] += n


def _skeleton(obj, tensors: list):
    """obj's structure with its tensors replaced by (shape, dtype, device)
    and appended to `tensors`: the hashable part of a graph's key."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return (tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__qualname__,) + tuple(
            _skeleton(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_skeleton(v, tensors) for v in obj)
    return obj


def _nbytes(tensors: list, objs=()) -> int:
    """Bytes of `tensors` and of every tensor in `objs`."""
    tensors = list(tensors)
    _skeleton(objs, tensors)
    return sum(v.numel() * v.element_size() for v in tensors)


def _rows(world, batched: bool):
    """The part of a step's world that carries its row axis (one world a
    scenario): the world itself, or a composite's overlay; None for a
    world shared by every scenario."""
    if not batched:
        return None
    return world.overlay if isinstance(world, CompositeWorld) else world


def _shared(world, batched: bool):
    """The part of a step's world that every scenario shares: a shared
    world, a composite's grid, or None."""
    if not batched:
        return world
    return world.grid if isinstance(world, CompositeWorld) else None


def _inputs(world, constraints=()) -> list:
    """The tensors of a shared world and of the constraints, in the
    skeleton's order: what a call loads into its entry's copies
    (:func:`_load_inputs`)."""
    tensors = []
    _skeleton((world, tuple(constraints)), tensors)
    return tensors


def _held(tensors) -> tuple:
    return tuple((weakref.ref(t), t._version) for t in tensors)


def _load_inputs(entry, bufs: list, values: list) -> None:
    """The caller's shared world and constraints (`values`) into the
    entry's copies of them (`bufs`), each tensor only where it is not the
    one the copy last took (by identity and version; entry.held), so a
    call with the world of the last adds no copy. A copy takes its
    source's host copy (_tensors.copy_with_mirror). Then every evaluator
    node of the entry's regions whose parameter block the new values
    change gets its new block (:func:`_rewrite`); the grid and the corner
    table are read through pointers, which stay the copies'. Returns
    (tensors copied, nodes rewritten)."""
    moved = 0
    for i, (buf, v) in enumerate(zip(bufs, values)):
        if buf is v or (i < len(entry.held) and entry.held[i][0]() is v
                        and entry.held[i][1] == v._version):
            continue
        copy_with_mirror(buf, v)
        GRAPHS["inputs_loaded"] += 1
        moved += 1
    if not moved:
        return 0, 0
    entry.held = _held(values)
    return moved, _rewrite(entry)


def _rewrite(entry) -> int:
    """Each evaluator node of the entry's regions (graph_node.Node) whose
    set's parameter block (kernels/rollout.py block_params: from the
    copies' host copies, or one device read) differs from the one it holds
    gets the new block in the instantiated graph. Returns how many did."""
    blocks, n = {}, 0
    for r in entry.regions():
        for node in r.nodes:
            robot, world, shared, cons = node.args
            key = (id(robot), id(world), shared, *map(id, cons))
            vec = blocks.get(key)
            if vec is None:
                vec = blocks[key] = rollout.block_params(*node.args)
            if not np.array_equal(vec.view(np.uint32),
                                  node.params.view(np.uint32)):
                graph_node.rewrite(r.graph.raw_cuda_graph_exec(), node, vec)
                GRAPHS["node_updates"] += 1
                n += 1
    return n


def layout(state) -> tuple:
    """The (shape, dtype) of every field of a solver state."""
    return tuple((tuple(v.shape), v.dtype) for v in fields(state))


def _refs(key, tensors) -> tuple:
    """Weak references to a cache entry's tensors; a tensor's end marks
    the entry dead."""
    return tuple(weakref.ref(t, lambda _, k=key: _DEAD.append(k))
                 for t in tensors)


def _lookup(key, tensors):
    """The cached entry of `key`, or None; an entry whose tensors moved a
    version since its capture is dropped."""
    g = _CACHE.get(key)
    if g is None:
        return None
    if all(r() is t and t._version == v
           for r, t, v in zip(g.refs, tensors, g.versions)):
        _CACHE.move_to_end(key)
        return g
    del _CACHE[key]
    _drop(g, "invalidated")
    return None


def _drop(g, why: str) -> None:
    """Free an entry's graphs and pools once the last call that used it is
    done."""
    GRAPHS[why] += 1
    if g.released is not None:
        g.released.synchronize()
    for r in g.regions():
        if r.graph is not None:
            body_pool = getattr(r.graph, "body_pool", None)
            r.graph.reset()
            if body_pool is not None:
                torch._C._cuda_releasePool(*body_pool)


def _purge() -> None:
    """Drop the graphs a tensor of whose key is gone (weak reference
    callbacks only note the key: a callback may run inside a capture)."""
    while _DEAD:
        key = _DEAD.pop()
        g = _CACHE.get(key)
        if g is not None and any(r() is None for r in g.refs):
            del _CACHE[key]
            _drop(g, "dead")


def _make_room() -> None:
    """Evict least recently used entries down to LIMIT - 1: one pool
    less."""
    while len(_CACHE) >= LIMIT:
        _drop(_CACHE.popitem(last=False)[1], "evicted")


def hold(g) -> None:
    """Keep the cached entry g the most recently used (a compacted solve's
    full batch, while its buckets' entries are captured and replayed)."""
    if _CACHE.get(g.key) is g:
        _CACHE.move_to_end(g.key)


def clear() -> None:
    """Drop every cached graph."""
    with _LOCK:
        _purge()
        while _CACHE:
            _drop(_CACHE.popitem(last=False)[1], "evicted")


def reset_counts() -> None:
    GRAPHS.clear()


def cached() -> list[dict]:
    """What each cached entry holds and cost, oldest first: kind, batch,
    loop route, pool and static bytes, capture and instantiate ms (summed
    over its regions, each region's under "regions") and the replays of
    its loop (or of its one region)."""
    with _LOCK:
        _purge()
        return [g.info() for g in _CACHE.values()]


@contextlib.contextmanager
def entry(kind: str, *parts, build: Callable[[], Entry], robot, ops=None,
          world=None, constraints=(), draws=None, k: int = CHUNK,
          span: str | None = "graph.lookup"):
    """The cached entry of a graphed program, opened under the lock:
    ``with entry(...) as (e, new):``. Its key is `kind`, the hashable
    `parts`, the structure of the robot, DeviceOps, shared world and
    constraints, the robot's and DeviceOps' tensors by identity (their
    versions checked: an entry whose versions moved is dropped), and,
    with `draws` = (step kind, noise_fn), the loop's route (chunks of k).
    The lookup is a `span` (with `hit`; None: no span). On a miss, room is
    made and build() makes the entry (new is True); it is cached when the
    block ends with a region captured. At the block's end the entry's
    buffers are marked in use until the device's queued work is done."""
    with _LOCK:
        with (tracing.span(span) if span else tracing.OFF) as s:
            if draws is not None:
                how = route(*draws)
                plan = draw_plan(draws[1]) if how == "chunk" else None
                parts += (how, k if how == "chunk" else None,
                          None if plan is None else plan.key())
            tensors = []
            key = (kind, *parts, _skeleton((robot, ops), tensors),
                   _skeleton((world, tuple(constraints)), []),
                   tuple(map(id, tensors)))
            _purge()
            e = _lookup(key, tensors)
            s.set(hit=e is not None)
        new = e is None
        if new:
            _make_room()
            e = build()
            e.key, e.refs = key, _refs(key, tensors)
            e.versions = tuple(t._version for t in tensors)
            e.held = _held(_inputs(world, constraints))
        yield e, new
        if new and any(r.graph is not None for r in e.regions()):
            _make_room()
            _CACHE[key] = e
        _release(e)


def _open(step, shapes: tuple, k: int, build):
    """:func:`entry` of a solve shape: `step`'s kind, config, batch,
    device, HyperParams or none, world rows, the state's layout `shapes`
    and its loop route."""
    return entry(step.kind, step.cfg, tuple(step.Q0.shape), step.Q0.device,
                 step.hyper is None, step.world_batched, shapes,
                 type(step.world).__qualname__,
                 _skeleton(_rows(step.world, step.world_batched), []),
                 build=build, robot=step.robot, ops=step.ops,
                 world=_shared(step.world, step.world_batched),
                 constraints=step.constraints,
                 draws=(step.kind, step.noise_fn), k=k)


def _solve_entry(step, state, k: int, QN=None) -> Entry:
    """A new entry of a solve shape: its loop from `state` and nothing
    else captured yet."""
    g = Loop.over(step, state, k, QN)
    s = g.step
    return Entry(kind=step.kind, device=step.Q0.device,
                 batch=tuple(step.Q0.shape), robot=s.robot, ops=s.ops,
                 world=_shared(s.world, s.world_batched),
                 constraints=s.constraints, loop=g, parts={"loop": g})


def _stream(device, body: bool = False) -> torch.cuda.Stream:
    """The device's capture stream, or its body stream (a chunk's bodies
    are captured from it): one each, so their cuBLAS workspaces are set up
    once, by eager work outside any capture."""
    key = (device, body)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def _on(stream, fn):
    """fn() on `stream`, ordered after the current stream's work and before
    its later work; tensors it returns are marked as used there."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    tensors = []
    _skeleton(out, tensors)
    for v in tensors:
        v.record_stream(cur)
    return out


def eagerly(device, fn):
    """fn() run eagerly on the device's capture stream (a miss's work
    before its capture: it sets up that stream's cuBLAS workspace)."""
    return _on(_stream(device), fn)


def _if_node(pred: torch.Tensor, fn: Callable[[], None]) -> None:
    """fn() captured under an IF node of the graph the current stream
    captures: a replay runs it only if the int32 `pred` is nonzero when
    it gets there. The bodies of one capture run on the body stream and
    allocate from one pool of their own."""
    device = pred.device
    parent = torch.cuda.current_stream(device)
    body = _stream(device, body=True)
    graph_if.begin(parent, pred, body)
    try:
        with torch.cuda.stream(body):
            pools = _BODY_POOL.get()
            if not pools:
                pools.append((device.index, torch._C._graph_pool_handle()))
                torch._C._cuda_beginAllocateCurrentStreamToPool(*pools[0])
            fn()
    finally:
        graph_if.end(body)


def _capture(body: Callable[[], None], stream, generator=None):
    """body() captured on `stream` into a new CUDA graph with a memory pool
    of its own (and, for IF nodes' bodies, a body pool), drawing from
    `generator` where it is given: (graph, capture ms, instantiate ms,
    pool bytes)."""
    graph_if.load(stream.device)
    graph_node.load(stream.device)
    # the captured graph is kept beside the instantiated one: its kernel
    # nodes are the handles graph_node rewrites
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if generator is not None:
        graph.register_generator_state(generator)
    reserved = torch.cuda.memory_reserved(stream.device)
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    pools = []
    token = _BODY_POOL.set(pools)
    try:
        with torch.cuda.stream(stream):
            t0 = time.perf_counter()
            graph.capture_begin()
            try:
                body()
            except BaseException:
                try:
                    graph.capture_end()     # leave the stream out of capture
                except RuntimeError:
                    pass                    # the capture is void: body's error
                if pools:                   # no graph keeps the body pool
                    torch._C._cuda_endAllocateToPool(*pools[0])
                    torch._C._cuda_releasePool(*pools[0])
                raise
            if pools:                       # released with the graph (_drop)
                torch._C._cuda_endAllocateToPool(*pools[0])
                graph.body_pool = pools[0]
            t1 = time.perf_counter()
            graph.capture_end()
            graph.instantiate()
            t2 = time.perf_counter()
    finally:
        _BODY_POOL.reset(token)
    cur.wait_stream(stream)
    return (graph, 1e3 * (t1 - t0), 1e3 * (t2 - t1),
            torch.cuda.memory_reserved(stream.device) - reserved)


def _snapshot() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


def _record(r: Region, body: Callable[[], None], device,
            generator=None) -> None:
    """body() captured into the region r on the device's capture stream;
    what the capture counted moves to r's replays. The allocator's cached
    blocks are released first: a capture allocates new segments for its
    pool and may not release cached ones itself, not even the pools of
    dropped graphs, which torch frees only then."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    before = _snapshot()
    with graph_node.recording(r.nodes):
        r.graph, r.capture_ms, r.instantiate_ms, r.pool_bytes = _capture(
            body, _stream(device), generator)
    # the capture launched nothing: its counts move to the replays
    r.counts = tuple({k: c[k] - b[k] for k in c}
                     for c, b in zip(_COUNTERS, before))
    for c, b in zip(_COUNTERS, before):
        c.update(b)
    GRAPHS["captured"] += 1


def capture(r: Region, device, body=None) -> None:
    """r captured from its body (or `body`, a bound method of an object
    with the buffers it writes), as a `graph.capture` span."""
    with tracing.span("graph.capture", region=r.region) as s:
        _record(r, body or r.body, device)
        s.set(capture_ms=r.capture_ms, instantiate_ms=r.instantiate_ms)


def _record_loop(e: Entry, device) -> None:
    """e's loop region captured: a chunk (its counts become one
    iteration's share, added per iteration run) or one iteration (CHOMP's
    as two regions, its gradient apart: the entry's grad region)."""
    g = e.loop
    if g.route != "chunk":
        if g.grad is not None:
            g.grad_region = _Stage(region="grad", owner=g, fn=Loop._grad)
            _record(g.grad_region, g.grad_region.body, device)
            e.parts["grad"] = g.grad_region
        _record(g, g.iteration, device)
        return
    _record(g, g.chunk, device, g.gen)
    per_it = []
    for c in g.counts:
        if any(n % g.k for n in c.values()):
            raise RuntimeError(f"a chunk's {g.k} bodies launched unequal "
                               f"counts: {c}")
        per_it.append({name: n // g.k for name, n in c.items()})
    g.per_it, g.counts = tuple(per_it), ()


def _static_world(world, batched: bool, own):
    """A graph's world: a per-scenario world's rows as contiguous static
    buffers (loaded with the state), the rest as `own` makes it."""
    rows = _rows(world, batched)
    if rows is None:
        return own(world)
    bufs = map_tensors(rows, lambda v: v.clone(
        memory_format=torch.contiguous_format))
    if isinstance(world, CompositeWorld):
        return CompositeWorld(grid=own(world.grid), overlay=bufs)
    return bufs


def _fits(g: Loop, state) -> bool:
    """The state has the static state's strides, so the replayed kernels
    see the layout the eager loop's would."""
    return all(a.stride() == b.stride()
               for a, b in zip(fields(g.state), fields(state)))


def _wait(e: Entry) -> None:
    """The current stream waits for the last call that used e's buffers
    (on whichever stream it ran)."""
    if e.released is not None:
        torch.cuda.current_stream(e.device).wait_event(e.released)


def _release(e: Entry) -> None:
    """Mark e's buffers as in use until the current stream's queued work
    is done."""
    if e.device.type == "cuda":
        e.released = torch.cuda.Event()
        e.released.record(torch.cuda.current_stream(e.device))


def load(e: Entry, pairs, world=None, constraints=(),
         span: str = "graph.load") -> None:
    """A call's load of e, as a `span` with the inputs copied and the
    nodes rewritten: after the device work of e's last call, each
    (buffer, value) of `pairs` copied, and the call's shared world and
    constraints into e's copies of them (:func:`_load_inputs`)."""
    with tracing.span(span) as s:
        _wait(e)
        for buf, v in pairs:
            buf.copy_(v)
        n, updates = _load_inputs(e, e.inputs(),
                                  _inputs(world, constraints))
        s.set(inputs=n, node_updates=updates)


def _pairs(g: Loop, step) -> list:
    """(buffer, value) pairs of what a solve loads besides its state and
    its inputs: Q0, HyperParams, world rows and the draw's rows."""
    pairs = [(g.Q0, step.Q0)]
    if step.hyper is not None:
        pairs += zip(fields(g.hyper), fields(step.hyper))
    rows = g.rows_world()
    if rows is not None:
        pairs += zip(fields(rows), fields(_rows(step.world, True)))
    if g.rows is not None:
        pairs.append((g.rows, draw_plan(step.noise_fn).index(g.rows.device)))
    return pairs


def _load_state(e: Entry, step, state, QN=None) -> None:
    """The solve's state, Q0/QN (QN: the wrapped goal where step.QN is not
    yet), HyperParams, rows and inputs into e's loop buffers and copies."""
    g = e.loop
    load(e, [(g.QN, step.QN if QN is None else QN),
             *zip(fields(g.state), fields(state)), *_pairs(g, step)],
         _shared(step.world, step.world_batched), step.constraints)
    torch.logical_not(g.state.done, out=g.active)


def _settle(g: Loop, step, state, it_limit: int, count: int):
    """The solve's next iteration, run eagerly over g's step on the stream
    g's loop is captured from (it builds the kernels' libraries, settles
    their parameter routes and the stream's cuBLAS workspace), and one more
    while it deferred a parameter read: (state, count, whether the solve is
    over). The first draw of a chunk's generator measures its offset
    advance an iteration (g.inc)."""
    stream = _stream(step.Q0.device, body=g.route == "chunk")
    plan = None if g.gen is None else draw_plan(step.noise_fn)
    measure = (plan is not None and g.inc is None
               and plan.generator.device.type == "cuda")

    def one(s, c):
        if not measure:
            return g.step.advance(s, step.draw(c, s.done))
        start = plan.generator.get_offset()
        draws = step.draw(c, s.done)
        g.inc = plan.generator.get_offset() - start
        return g.step.advance(s, draws)

    for reason in ("first_iteration", "param_read"):
        deferred = rollout.PARAM_READS["deferred"]
        state = _on(stream, lambda s=state, c=count: one(s, c))
        measure = False
        count += 1
        GRAPHS["eager:" + reason] += 1
        if count >= it_limit or bool(state.done.all()):
            return state, count, True
        if rollout.PARAM_READS["deferred"] == deferred:
            break
    return state, count, False


def ready(e: Entry, new: bool, step, state, it_limit: int, count: int = 0,
          QN=None, keep: bool = False):
    """Before e's loop replays from `state` (count iterations run): on a
    new entry, or a state of other strides, the eager iterations of
    _settle, and a new entry's loop captured unless the solve ended in
    them (with `keep`, whether or not); then the state loaded, unless a
    new entry's solve ended eagerly without `keep`. Returns (state, count,
    over): over, the solve is over (its state then the eager loop's)."""
    g = e.loop
    over = count >= it_limit
    if not over and (new or not _fits(g, state)):
        if not new:
            _load_state(e, step, state, QN)  # Q0/QN/hyper/rows of this call
        # a cached entry whose layout does not fit settles eagerly and
        # captures nothing: its iterations stay in the caller's span
        with (tracing.span("graph.capture", region=g.region) if new
              else tracing.OFF) as s:
            state, count, over = _settle(g, step, state, it_limit, count)
            if new and (keep or not over):
                _record_loop(e, step.Q0.device)
                s.set(capture_ms=g.capture_ms,
                      instantiate_ms=g.instantiate_ms)
    if keep or not (new and over):
        _load_state(e, step, state, QN)
    return state, count, over


def _finished(g: Loop) -> bool:
    """The host's read of the per-iteration loop's condition."""
    with tracing.span("graph.flag_wait"):
        return bool(g.finished)


class _Reads:
    """The host's reads of a chunk's condition: ctl copied to a pinned
    slot (two, taken in turn) behind an event after each replay, read only
    once the next chunk is queued; with `mask`, the done mask too."""

    def __init__(self, g: Loop, mask: bool):
        self.g, self.slot = g, 0
        self.done = (torch.zeros((2,) + tuple(g.state.done.shape),
                                 dtype=torch.bool, pin_memory=g.ctl.is_cuda)
                     if mask else None)

    def post(self):
        g, slot = self.g, self.slot
        self.slot ^= 1
        g.host[slot].copy_(g.ctl, non_blocking=True)
        if self.done is not None:
            self.done[slot].copy_(g.state.done, non_blocking=True)
        event = None
        if g.ctl.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return slot, event

    def read(self, posted):
        slot, event = posted
        if event is not None:
            with tracing.span("graph.flag_wait"):
                event.synchronize()
        GRAPHS["flag_reads"] += 1
        go, count = self.g.host[slot].tolist()
        mask = None if self.done is None else self.done[slot].numpy().copy()
        return bool(go), count, mask


def _chunks(g: Loop, step, it_limit: int, count: int, mask=False):
    """Chunk replays from g's loaded state until the device's condition
    fails (every row done, or the count at it_limit): chunk j+1 is queued
    before chunk j's condition is read. Returns (count, done mask or
    None). The kernel counters take one iteration's share per iteration
    run; the source's generator is left where the eager loop leaves it."""
    plan = None if g.gen is None else draw_plan(step.noise_fn)
    if plan is not None:
        g.gen.set_state(plan.generator.get_state())
    g.ctl[1].fill_(count)
    g.limit.fill_(it_limit)
    start, bound = count, count
    reads = _Reads(g, mask)

    def launch():
        nonlocal bound
        g.replay()
        bound = min(bound + g.k, it_limit)
        return reads.post()

    posted = launch()
    while True:
        ahead = launch() if bound < it_limit else None
        go, count, done = reads.read(posted)
        if not go:
            break
        posted = ahead
    n = count - start
    g.tally(n)
    if plan is not None:
        _rewind(g, plan.generator, n)
    return count, done


def _rewind(g: Loop, generator, n: int) -> None:
    """`generator` moved as far as n eager iterations' draws move it (the
    chunk's replays moved g.gen by whole chunks). On the CPU, where only
    tests emulate a graph and a skipped body draws nothing, g.gen's state
    is already that."""
    if generator.device.type == "cuda":
        generator.set_offset(generator.get_offset() + n * g.inc)
    else:
        generator.set_state(g.gen.get_state())


def _loop(g: Loop, step, it_limit: int, count: int, mask: bool = False):
    """g's loop from its loaded state: chunks or per-iteration replays.
    Returns the count, and with mask=True (count, the done mask read with
    the loop's condition)."""
    with tracing.span("graph.loop", route=g.route) as s:
        start, replays = count, g.replays
        if g.route == "chunk":
            count, done = _chunks(g, step, it_limit, count, mask)
        else:
            count = g.iterate(step, it_limit, count)
            done = g.state.done.cpu().numpy() if mask else None
        s.set(chunks=g.replays - replays, iterations=count - start)
    return (count, done) if mask else count


class Handle:
    """A program's solver loop as its caller drives it (:func:`solve`'s
    `loop`): `state`, the solve's state, and :meth:`run`, its loop from
    there. Graphed (`entry`), the state is the entry's static state and
    the loop its chunk or per-iteration replays; eager (`why`, the
    reason), the state is the eager loop's own and the loop one
    step(state, count) an iteration. `step` draws the noise."""

    def __init__(self, step, state=None, why: str | None = None,
                 entry: Entry | None = None):
        self.step, self.why, self.entry = step, why, entry
        self.state = state if entry is None else entry.loop.state

    @property
    def QN(self) -> torch.Tensor:
        """The wrapped goals."""
        return self.step.QN if self.entry is None else self.entry.loop.QN

    def run(self, end: int, count: int, mask: bool = False):
        """The loop from `state` after `count` iterations until every row
        is done or the count reaches `end`: the count, and with mask=True
        (count, the done mask read with the loop's condition). The eager
        loop makes one host sync an iteration (and, under debug_mode,
        checks the state after each)."""
        if self.entry is not None:
            return _loop(self.entry.loop, self.step, end, count, mask)
        check = tracing.debug_enabled()
        state = self.state
        while count < end and not bool(state.done.all()):
            state = self.step(state, count)
            GRAPHS["eager:" + self.why] += 1
            if check:
                tracing.check_state(state, count)
            count += 1
        self.state = state
        return (count, state.done.cpu().numpy()) if mask else count

    def put(self, part, rows: torch.Tensor) -> None:
        """part, the state of the rows `rows`, written back into `state`:
        in place in the entry's static state; eagerly as new tensors (the
        eager state may alias a caller's tensor, as init_state's warm
        start)."""
        if self.entry is not None:
            for a, b in zip(fields(self.state), fields(part)):
                a.index_copy_(0, rows, b)
            return
        self.state = dataclasses.replace(self.state, **{
            f.name: getattr(self.state, f.name).index_copy(
                0, rows, getattr(part, f.name))
            for f in dataclasses.fields(part)})

    def hold(self) -> None:
        """Keep a graphed solve's entry the most recently used (:func:`hold`)
        while other entries are captured and replayed."""
        if self.entry is not None:
            hold(self.entry)


def run(step, state, it_limit: int, count: int = 0, k: int = CHUNK,
        mask: bool = False):
    """solver.run_until's loop: `state` advanced by `step` until every row
    is done or the count reaches it_limit, on the graphs of step (chunks
    of k) but in eager_reason's cases. Returns (state, count), and with
    mask=True the done mask read with the loop's condition (the compacted
    path's one read a chunk). The state returned is the call's own (never
    a graph buffer)."""
    why = _why(step)
    if why is not None:
        h = Handle(step, state, why)
        out = h.run(it_limit, count, mask)
        return (h.state, *out) if mask else (h.state, out)
    if count >= it_limit or bool(state.done.all()):
        return (state, count, state.done.cpu().numpy()) if mask else (
            state, count)
    with _open(step, layout(state), k,
               lambda: _solve_entry(step, state, k)) as (e, new):
        state, count, over = ready(e, new, step, state, it_limit, count)
        if over:
            return (state, count, state.done.cpu().numpy()) if mask else (
                state, count)
        out = _loop(e.loop, step, it_limit, count, mask)
        state = map_tensors(e.loop.state, torch.clone)
    return (state, *out) if mask else (state, out)


def _solve_in(g: Loop, given: bool, init) -> None:
    """solve-in: init (solver._init_batch) from the loaded Q0, goal and
    warm start into the static goal and state."""
    QN, state = init(g.step.robot, g.step.cfg, g.Q0, g.QN_in,
                     g.theta0 if given else None)
    g.QN.copy_(QN)
    for buf, v in zip(fields(g.state), fields(state)):
        buf.copy_(v)
    torch.logical_not(g.state.done, out=g.active)


def solve(step, theta0, restarts: int, shapes: tuple, init, finish,
          loop=None, k: int = CHUNK):
    """solver.solve_batch of step (built over the goal before wrapping):
    solve-in, the loop, solve-out, on the graphs of step but in
    eager_reason's cases. init(robot, cfg, Q0, QN, theta0) -> (QN, state)
    is solver._init_batch, finish(step, state, restarts) -> Solution its
    finalize (and choice of the best restart); shapes is the layout of
    init's state. loop(h, count) -> count runs the iterations through the
    :class:`Handle` h and leaves the last state in h.state (default: the
    loop to max_iterations, in chunks of k). A miss runs init and finish
    eagerly on the capture stream, then captures them. Returns (Solution,
    count); the Solution is the solve's own."""
    it_limit = step.cfg.max_iterations
    if loop is None:
        def loop(h, count):
            return h.run(it_limit, count)
    why = _why(step)
    if why is not None:
        QN, state = init(step.robot, step.cfg, step.Q0, step.QN, theta0)
        h = Handle(step.over(QN=QN), state, why)
        count = loop(h, 0)
        return finish(h.step, h.state, restarts), count
    dev = step.Q0.device
    given = theta0 is not None
    enter = "solve_in" + (":theta0" if given else "")
    leave = "solve_out" + (f":restarts={restarts}" if restarts > 1 else "")
    started = None

    def begin():
        return eagerly(dev, lambda: init(step.robot, step.cfg, step.Q0,
                                         step.QN, theta0))

    def build():
        nonlocal started
        started = begin()
        return _solve_entry(step, started[1], k, started[0])

    with _open(step, shapes, k, build) as (e, new):
        g, h = e.loop, Handle(step, entry=e)
        if enter in e.parts:
            load(e, [(g.QN_in, step.QN), *_pairs(g, step),
                     *([(g.theta0, theta0)] if given else [])],
                 _shared(step.world, step.world_batched), step.constraints)
            e.parts[enter].replay()
            count = loop(h, 0) if it_limit > 0 else 0
        else:
            QN, state = started if new else begin()
            state, count, over = ready(e, new, step, state, it_limit, 0, QN)
            if over and new:
                return eagerly(dev, lambda: finish(
                    step.over(QN=QN), state, restarts)), count
            if not over:
                count = loop(h, count)
            if given and g.theta0 is None:
                g.theta0 = theta0.clone()
            stage = _Stage(region="solve-in", owner=e,
                           fn=lambda e, t=given: _solve_in(e.loop, t, init))
            capture(stage, dev)
            e.parts[enter] = stage
        stage = e.parts.get(leave)
        if stage is None:
            sol = map_tensors(eagerly(dev, lambda: finish(
                g.step, g.state, restarts)), torch.clone)
            stage = _Stage(region="solve-out", owner=e,
                           fn=lambda e, R=restarts: finish(
                               e.loop.step, e.loop.state, R))
            capture(stage, dev)
            e.parts[leave] = stage
        else:
            stage.replay()
            sol = map_tensors(stage.out, torch.clone)
        return sol, count


def goal(fn, robot, world, cfg, q0, qN, below, above, u) -> torch.Tensor:
    """fn(robot, world, cfg, q0, qN, below, above, u) -> the goal [..., d]
    (api/plan.py's band) on a cached graph but in eager_reason's cases,
    the counterpart of JAX's ``_jitted_goal``: one entry per robot (by
    identity and version), world type and shapes, collision threshold and
    the arguments' shapes. A call copies its arguments (u, the band's
    uniforms, included: never frozen) and the world's values into the
    entry and replays it; a miss runs fn eagerly on the capture stream,
    then captures it. Returns the call's own tensor."""
    dev = q0.device
    if eager_reason(dev, robot, world=world) is not None:
        return fn(robot, world, cfg, q0, qN, below, above, u.to(dev))
    args = (q0, qN, below, above, u)

    def build():
        e = Entry(kind="goal_band", device=dev, batch=tuple(q0.shape),
                  robot=clone_with_mirrors(robot),
                  world=clone_with_mirrors(world),
                  static=[torch.empty(v.shape, dtype=v.dtype,
                                      device=dev).copy_(v) for v in args])
        e.parts["goal_band"] = _Stage(region="goal", owner=e, fn=lambda e: fn(
            e.robot, e.world, cfg, *e.static))
        return e

    with entry("goal_band", cfg.collision_threshold, dev,
               tuple((tuple(v.shape), v.dtype) for v in args),
               build=build, robot=robot, world=world) as (e, new):
        stage = e.parts["goal_band"]
        if new:
            out = eagerly(dev, lambda: stage.fn(e))
            capture(stage, dev)
        else:
            load(e, zip(e.static, args), world)
            stage.replay()
            out = stage.out.clone()
    return out

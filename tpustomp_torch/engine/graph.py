"""CUDA graphs of the solver: the port's counterpart of the JAX package's
compiled solve program.

JAX runs a batched solve as one device program, compiled once per (config,
shapes) and cached: ``_jitted_solve_batch`` (``tpustomp/api/plan.py:177-211``)
holds ``_init_batch``, the ``lax.while_loop`` of ``solver.solve_batch``
(``tpustomp/engine/solver.py:827-849``), ``_finalize_batch`` and
``select_best``; the compacted path runs ``_jitted_init_batch``, then
``_jitted_chunk_batch`` (``solver.py:900-919``, a ``while_loop`` bounded by
``chunk``) once a chunk, then ``_jitted_finalize_batch``. The port captures
the same program as CUDA graphs over static buffers, one cache entry a
solve shape, and replays them:

- The loop (:func:`run`, ``solver.run_until`` on the card). By default a
  chunk: one graph of :data:`CHUNK` iterations (the compacted path's
  ``chunk``), each under a conditional IF node (kernels/graph_if.py) whose
  condition ``ctl[0]`` is ``any(~done) & (count < limit)`` on the device,
  written before the first body and again at the end of each. A body draws
  its noise inside the graph from a generator of the entry's own, set to
  the noise source's state before the replays (the source's
  ``sampling.DrawPlan``; each captured draw has its own Philox offset, so
  the draws of the iterations that run are the eager loop's), then
  advances the state, copies it into the static state and counts
  ``ctl[1]``. Iterations past the end are skipped by the device. The host
  replays chunk j+1 before it reads chunk j's ``ctl`` (a copy to pinned
  memory and an event), so the device never waits for the host, and a
  solve makes at most ceil(iterations / CHUNK) + 1 reads, not one an
  iteration. A replay moves the generator by the whole chunk's draws, so
  the source's generator is then set to where the eager loop leaves it:
  its offset plus the iterations run times one iteration's offset
  advance (measured at the entry's first eager draw).
- The other route replays one iteration a replay (``advance`` only), with
  the draw on the host and one read of the loop's condition after it:
  the route of a caller's own noise_fn, which cannot be captured
  ("per_iteration:noise_fn"), and of :func:`per_iteration` around an entry
  point ("per_iteration:requested"), for comparisons. The route is chosen
  from the step before anything runs (:func:`route`); neither falls back
  to the other. A CHOMP iteration is two regions on this route: its
  gradient into a static buffer (the grad region, replayed under a
  ``chomp.grad`` span, whose CUDA events time it) and the update from
  it; the chunk's bodies keep the whole iteration.
- Solve-in and solve-out (:func:`solve`, ``solver.solve_batch`` on the
  card): two more regions of the entry, ``_init_batch`` from the loaded
  Q0/QN (and theta0) into the static state, and ``finalize`` (with
  restarts, the choice of the best) into a static ``Solution``. A graphed
  ``plan_batch`` is then its input copies, solve-in, the chunk replays,
  solve-out and one clone out.
- Capture (on a cache miss). The solve's own first iteration runs eagerly
  on the stream the loop is captured from: it builds the kernel libraries,
  settles every parameter route (kernels/rollout.py ``_launch_params``) and
  sets up that stream's cuBLAS workspace. A set built on the card defers
  its one device read to its second launch (a capture may not read), so
  while an eager iteration deferred one, one more runs ("param_read"): the
  graph then holds the parameter block, as the eager loop does from its
  second iteration. These iterations and the captures run the graph's own
  step, over copies of the robot, world, constraints and ``DeviceOps``
  (with their host copies). The parent regions are captured on a capture
  stream; a chunk's bodies on one body stream into one body pool of the
  chunk's own, so every body reuses the blocks the one before freed (a
  chunk's pool is about one iteration's). The solve-in and solve-out of a
  miss run eagerly on the capture stream and are captured after. A
  capture or a replay that raises is an error; nothing falls back.
- Cache. One entry per step kind, config, state and batch shapes, device,
  HyperParams or none, loop route (and the draw's shapes and cut), the
  robot and ``DeviceOps`` (their fields other than tensors, and each
  tensor's identity and version, ``_version``), and the world's and the
  constraints' types and shapes. The entry points hand the solver one
  device copy of equal CPU robots, worlds and constraints
  (``_tensors.shared_copy``). The cache holds the robot's and DeviceOps'
  tensors weakly: an entry whose tensors are gone is dropped at the next
  call. At most :data:`LIMIT` entries, least recently used first out; a
  dropped entry's pools go back to torch's allocator. The compacted
  path's buckets are entries of their own.
- Inputs: the world and the constraints, as JAX's jit takes them (every
  field of a world a traced operand, the Pallas kernel built from counts).
  A solve copies the shared world's tensors (an AnalyticWorld's four, a
  grid's grid, packed table, origin and resolution; a composite's grid
  where the world has rows) and the constraints' into the entry's own
  copies (:func:`_load_inputs`), each tensor only when it is not the one
  the copy last took, by identity and version, so a call with the world
  of the last copies nothing; the copies take their sources' host copies.
  The kernels read the grid and the corner table through pointers, which
  stay the copies'. The rest goes in the kernels' by-value parameter
  block, which a capture holds in each evaluator node: each captured
  evaluator launch on a block is recorded (kernels/graph_node.py), and
  after a load every node whose set's block (from the copies' host
  copies, or one device read) moved gets the new block in the
  instantiated graph (:func:`_rewrite`; ``GRAPHS["node_updates"]``). A
  set on the memory path packs its vector inside the graph, from the
  copies. An IncrementalSDF edited between plans, a moved box, a cone
  whose target moves: replays, no capture.
- Per-scenario worlds (``world_batched``: the MPC tick's, a batch's rows
  of ``solve_batch_compacted``). The leaves that carry the row axis (an
  AnalyticWorld's four, a composite's ``overlay``) are inputs of the
  graph, as Q0 and the state are: the key names them by type, shapes and
  dtypes only, and the loads copy them into contiguous static buffers
  before the first replay of every solve. A composite's grid is an input
  as a shared world is.
- What a graph freezes. The host's decisions at capture (parameter
  route, lane plan, joint types) come from the robot, which the key names
  by identity and version, and from shapes. A write that moves no version
  (through ``.data``, a DLPack alias, a custom CUDA op) is not seen, as it
  is not by the parameter block itself.
- Results never alias the graph: a solve returns copies.
- Counters. The kernel wrappers count host calls (``rollout.LAUNCHES``,
  ``PARAM_ROUTES``, ``LAYOUTS``, ``BODY_ORDER``, ``propose.LAUNCHES``,
  ``chomp_grad.LAUNCHES``). What a capture added is
  taken back; a region's replay adds it again, and a chunk adds one
  iteration's share times the iterations that ran (read with the loop's
  condition), so a graphed run counts what the eager loop counts.
  :data:`GRAPHS` counts regions captured and replayed, evictions,
  invalidations, the iterations each route ran ("chunk",
  "per_iteration:<reason>"), the host reads of the loop's condition
  ("flag_reads") and eager iterations by reason.
- Eager cases, decided before any capture (:func:`eager_reason`): a CPU
  step ("cpu"), ``utils.tracing.debug_mode`` ("debug_mode": the state is
  checked after every iteration), keyed tensors moved under
  ``torch.inference_mode`` ("inference_tensors": no version to key on), a
  robot whose joint types only the device holds ("joint_types_on_card":
  FK would read them inside the capture), and the caller's request
  ("requested": :func:`eager`, around any entry point, for comparisons).
- The MPC tick (engine/mpc.py ``_Tick``) is one cache entry of three
  regions over static buffers: the tick's own work before the solve, this
  module's loop, and its work after the solve; the same lock, LRU,
  counters, inputs and ordering event serve it. So does the goal band
  (:func:`goal`, api/plan.py resolve_goal_tolerance; JAX's
  ``_jitted_goal``): one region.

Graphed solves of one process run one at a time (a lock): a graph's static
buffers hold one solve. A solve loads them only after the work of the last
solve that used them (an event), so solves on different streams that share
a graph stay ordered on the device too.
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
                                     map_tensors)
from tpustomp_torch.engine.sampling import draw_plan
from tpustomp_torch.kernels import (chomp_grad, graph_if, graph_node, propose,
                                    rollout)
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
# iterations each route
# ran ("chunk", "per_iteration:noise_fn", "per_iteration:requested"); the
# host's reads of the loop's condition ("flag_reads"); and iterations run
# eagerly by reason: "first_iteration" (the iteration before a capture, or
# before replays from a state whose strides differ from the graph's),
# "param_read" (the one after a first iteration that deferred a parameter
# read) and the reasons of eager_reason.
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
             rollout.BODY_ORDER, propose.LAUNCHES, chomp_grad.LAUNCHES)


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


def eager_reason(step) -> str | None:
    """Why `step` runs in the eager loop, or None when it replays a graph.
    `step` may be any object with a Step's robot, world, world_batched,
    constraints, ops and Q0 (the MPC tick passes its own)."""
    if not _ENABLED.get():
        return "requested"
    if tracing.debug_enabled():
        return "debug_mode"
    if any(t.is_inference() for t in (*_keyed(step)[1], *_step_inputs(step))):
        return "inference_tensors"
    if not joint_types_on_host(step.robot):
        return "joint_types_on_card"
    if step.Q0.device.type != "cuda":
        return "cpu"
    return None


def route(step) -> str:
    """How a graphed loop of `step` runs: "chunk" (CHUNK iterations a
    replay under IF nodes, the draws in the graph), or one iteration a
    replay, by reason: "per_iteration:noise_fn" (a noise_fn without a
    DrawPlan: a caller's own draws stay on the host) or
    "per_iteration:requested" (inside :func:`per_iteration`)."""
    if _PER_ITERATION.get():
        return "per_iteration:requested"
    if step.kind != "chomp" and draw_plan(step.noise_fn) is None:
        return "per_iteration:noise_fn"
    return "chunk"


@dataclasses.dataclass(eq=False, kw_only=True)
class _Region:
    """One captured region: its CUDA graph, what one replay adds to each
    counter, its evaluator nodes and what its capture cost. `region` names
    it in the spans: solve-in, chunk, iteration, solve-out, goal, tick-in,
    tick-out."""

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
class _Stage(_Region):
    """A region that runs fn(entry) over an entry's static buffers and keeps
    what it returns: a solve's solve-in or solve-out."""

    entry: object
    fn: Callable
    out: object = None

    def body(self) -> None:
        self.out = self.fn(self.entry)

    def buffers(self) -> list:
        return self.entry.buffers()


@dataclasses.dataclass(eq=False, kw_only=True)
class _Graph(_Region):
    """One solve shape: its loop region (a chunk, or one iteration), its
    solve-in and solve-out stages and their static buffers."""

    key: tuple
    refs: tuple               # weak references to the key's tensors
    versions: tuple
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
    enter: dict = dataclasses.field(default_factory=dict)  # theta0? -> _Stage
    leave: dict = dataclasses.field(default_factory=dict)  # restarts -> _Stage
    step: object = None       # the Step over the buffers and copies
    grad: torch.Tensor | None = None  # ∇U between a CHOMP iteration's
    grad_region: object = None        # regions (per-iteration route)
    held: tuple = ()          # (weak ref, version) of the inputs loaded last
    released: object = None   # event after the last solve's use, or None

    def __post_init__(self) -> None:
        self.region = "chunk" if self.route == "chunk" else "iteration"

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
        self._advance(self._draw())
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

    def _draw(self):
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
        """Every static buffer: what a solve loads and the regions write."""
        rows = self.rows_world()
        return [*self.draws, *_fields(self.state), self.active,
                self.finished, self.ctl, self.limit, self.Q0, self.QN,
                self.QN_in, *self.full,
                *(() if self.rows is None else (self.rows,)),
                *(() if self.theta0 is None else (self.theta0,)),
                *(() if self.grad is None else (self.grad,)),
                *(() if self.hyper is None else _fields(self.hyper)),
                *(() if rows is None else _fields(rows))]

    def copies(self) -> tuple:
        """The graph's copies of the keyed inputs."""
        return (self.step.robot, _shared(self.step.world,
                                         self.step.world_batched),
                self.step.constraints, self.step.ops)

    def regions(self) -> tuple:
        grad = () if self.grad_region is None else (self.grad_region,)
        return (self, *grad, *self.enter.values(), *self.leave.values())

    def info(self) -> dict:
        regions = {"loop": self.cost()}
        if self.grad_region is not None:
            regions["grad"] = self.grad_region.cost()
        for given, r in self.enter.items():
            regions["solve_in" + (":theta0" if given else "")] = r.cost()
        for R, r in self.leave.items():
            regions["solve_out" + (f":restarts={R}" if R > 1 else "")] = \
                r.cost()
        return dict(kind=self.kind, route=self.route, k=self.k,
                    batch=tuple(self.Q0.shape),
                    static_bytes=_nbytes(self.buffers(), self.copies()),
                    **{k: sum(r[k] for r in regions.values())
                       for k in ("pool_bytes", "capture_ms",
                                 "instantiate_ms")},
                    replays=self.replays, regions=regions)


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


def _keyed(step) -> tuple[tuple, list]:
    """(skeleton, tensors): the structure of the step's robot, world,
    constraints and DeviceOps, and the tensors a graph names by identity
    and version, the robot's and DeviceOps'. The world and the constraints
    are named by type, shapes and dtypes: a shared world's tensors and the
    constraints' are the graph's inputs (:func:`_inputs`, loaded at each
    solve), a per-scenario world's rows are loaded like the state."""
    tensors = []
    skeleton = (_skeleton((step.robot, step.ops), tensors),
                _skeleton((_shared(step.world, step.world_batched),
                           tuple(step.constraints)), []),
                type(step.world).__qualname__,
                _skeleton(_rows(step.world, step.world_batched), []))
    return skeleton, tensors


def _inputs(world, batched: bool = False, constraints=()) -> list:
    """The tensors of the shared part of a world (a composite's grid, where
    the world has rows) and of the constraints, in the skeleton's order:
    what a call loads into its graph's copies (:func:`_load_inputs`)."""
    tensors = []
    _skeleton((_shared(world, batched), tuple(constraints)), tensors)
    return tensors


def _step_inputs(step) -> list:
    return _inputs(step.world, step.world_batched, step.constraints)


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
    entry.held = _held(values)
    return moved, _rewrite(entry) if moved else 0


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
    return tuple((tuple(v.shape), v.dtype) for v in _fields(state))


def key_of(step, shapes: tuple, how: str, k: int = CHUNK
           ) -> tuple[tuple, list]:
    """(key, tensors): the cache key of `step` run from a state of the
    given layout by the loop route `how` (chunks of k), and the tensors
    it names by identity (their versions are checked on a hit)."""
    skeleton, tensors = _keyed(step)
    plan = draw_plan(step.noise_fn) if how == "chunk" else None
    key = (step.kind, step.cfg, tuple(step.Q0.shape), step.Q0.device,
           step.hyper is None, step.world_batched, shapes, skeleton,
           tuple(map(id, tensors)), how,
           k if how == "chunk" else None,
           None if plan is None else plan.key())
    return key, tensors


def _fields(obj) -> list:
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


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
    """Free an entry's graphs and pools once the last solve that used it is
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
    """Evict least recently used entries down to LIMIT - 1, before a
    capture: one pool less."""
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
    over its regions, each region's under "regions") and the loop's
    replays."""
    with _LOCK:
        _purge()
        return [g.info() for g in _CACHE.values()]


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


def _record(r: _Region, body: Callable[[], None], device,
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


def _captured(r: _Region, device, body=None) -> None:
    """_record of r (its body, or `body`) as a span of its own."""
    with tracing.span("graph.capture", region=r.region) as s:
        _record(r, body or r.body, device)
        s.set(capture_ms=r.capture_ms, instantiate_ms=r.instantiate_ms)


def _record_loop(g: _Graph, device) -> None:
    """g's loop region captured: a chunk (its counts become one
    iteration's share, added per iteration run) or one iteration (CHOMP's
    as two regions, its gradient apart: the grad region)."""
    if g.route != "chunk":
        if g.grad is not None:
            g.grad_region = _Stage(region="grad", entry=g,
                                   fn=_Graph._grad)
            _record(g.grad_region, g.grad_region.body, device)
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


def _add_counts(per_it: tuple, n: int) -> None:
    for c, add in zip(_COUNTERS, per_it):
        for name, v in add.items():
            c[name] += v * n


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


def _buffers(step, state, key, tensors, how: str, k: int = CHUNK,
             QN=None, own=clone_with_mirrors) -> _Graph:
    """A graph's static buffers for `step` from `state` (QN: the wrapped
    goal where step.QN is the goal before wrapping), the loop route `how`
    in chunks of k, and its step over them and over `own`'s copies of the
    robot, world, constraints and DeviceOps (by default clones with their
    host copies: the graph holds nothing of the caller's but weak
    references, so it goes when they do, and its step keeps what the
    captured kernels read (the copies, and what building the step put on
    the device) for as long as it may replay)."""
    dev = step.Q0.device
    hyper = (None if step.hyper is None
             else map_tensors(step.hyper, torch.clone))
    plan = (draw_plan(step.noise_fn)
            if how == "chunk" and step.kind != "chomp" else None)
    cut = plan is not None and plan.cut()
    g = _Graph(key=key, refs=_refs(key, tensors),
               versions=tuple(t._version for t in tensors),
               kind=step.kind, route=how, k=k, Q0=step.Q0.clone(),
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
    g.held = _held(_step_inputs(step))
    return g


def _fits(g: _Graph, state) -> bool:
    """The state has the static state's strides, so the replayed kernels
    see the layout the eager loop's would."""
    return all(a.stride() == b.stride()
               for a, b in zip(_fields(g.state), _fields(state)))


def _wait(g, device) -> None:
    """The current stream waits for the last solve that used g's buffers
    (on whichever stream it ran)."""
    if g.released is not None:
        torch.cuda.current_stream(device).wait_event(g.released)


def _release(g, device) -> None:
    """Mark g's buffers as in use until the current stream's queued work
    is done."""
    if device.type == "cuda":
        g.released = torch.cuda.Event()
        g.released.record(torch.cuda.current_stream(device))


def _pairs(g: _Graph, step) -> list:
    """(buffer, value) pairs of what a solve loads besides its state and
    its inputs: Q0, HyperParams, world rows and the draw's rows."""
    pairs = [(g.Q0, step.Q0)]
    if step.hyper is not None:
        pairs += zip(_fields(g.hyper), _fields(step.hyper))
    rows = g.rows_world()
    if rows is not None:
        pairs += zip(_fields(rows), _fields(_rows(step.world, True)))
    if g.rows is not None:
        pairs.append((g.rows, draw_plan(step.noise_fn).index(g.rows.device)))
    return pairs


def _load(g: _Graph, step, state, QN=None) -> None:
    """The solve's state, Q0/QN (QN: the wrapped goal where step.QN is not
    yet), HyperParams, rows and inputs into the static buffers and copies,
    after the last solve that used them."""
    with tracing.span("graph.load") as s:
        _wait(g, g.Q0.device)
        pairs = [(g.QN, step.QN if QN is None else QN),
                 *zip(_fields(g.state), _fields(state)), *_pairs(g, step)]
        for buf, v in pairs:
            buf.copy_(v)
        n, updates = _load_inputs(g, _step_inputs(g.step), _step_inputs(step))
        torch.logical_not(g.state.done, out=g.active)
        s.set(inputs=n, node_updates=updates)


def _settle(g: _Graph, step, state, it_limit: int, count: int):
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


def _iterate(g: _Graph, step, it_limit: int, count: int) -> int:
    """Per-iteration replays from g's loaded state until every row is done
    or the count reaches it_limit: each the draw into g's buffers, one
    replay (a CHOMP iteration's grad region first, under a `chomp.grad`
    span) and the read of the loop's condition. Returns the count."""
    start = count
    while True:
        step.draw_into(count, g.active, g.draws)
        if g.grad_region is not None:
            with tracing.span("chomp.grad", device=True):
                g.grad_region.replay()
        g.replay()
        count += 1
        GRAPHS["flag_reads"] += 1
        if count >= it_limit or _finished(g):
            GRAPHS[g.route] += count - start
            return count


def _finished(g: _Graph) -> bool:
    """The host's read of the per-iteration loop's condition."""
    with tracing.span("graph.flag_wait"):
        return bool(g.finished)


class _Reads:
    """The host's reads of a chunk's condition: ctl copied to a pinned
    slot (two, taken in turn) behind an event after each replay, read only
    once the next chunk is queued; with `mask`, the done mask too."""

    def __init__(self, g: _Graph, mask: bool):
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


def _chunks(g: _Graph, step, it_limit: int, count: int, mask=False):
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
    _add_counts(g.per_it, n)
    GRAPHS["chunk"] += n
    if plan is not None:
        _rewind(g, plan.generator, n)
    return count, done


def _rewind(g: _Graph, generator, n: int) -> None:
    """`generator` moved as far as n eager iterations' draws move it (the
    chunk's replays moved g.gen by whole chunks). On the CPU, where only
    tests emulate a graph and a skipped body draws nothing, g.gen's state
    is already that."""
    if generator.device.type == "cuda":
        generator.set_offset(generator.get_offset() + n * g.inc)
    else:
        generator.set_state(g.gen.get_state())


def _loop(g: _Graph, step, it_limit: int, count: int, mask: bool = False):
    """g's loop from its loaded state: chunks or per-iteration replays.
    Returns the count, and with mask=True (count, the done mask read with
    the loop's condition)."""
    with tracing.span("graph.loop", route=g.route) as s:
        start, replays = count, g.replays
        if g.route == "chunk":
            count, done = _chunks(g, step, it_limit, count, mask)
        else:
            count = _iterate(g, step, it_limit, count)
            done = g.state.done.cpu().numpy() if mask else None
        s.set(chunks=g.replays - replays, iterations=count - start)
    return (count, done) if mask else count


def _ready(g: _Graph, new: bool, step, state, it_limit: int, count: int,
           QN=None):
    """Before g's loop replays from `state`: on a new entry (or a state of
    other strides) the eager iterations of _settle, and a new entry's loop
    captured and cached, unless the solve ended in them; then the state
    loaded. Returns (state, count, over): over, the solve ended eagerly
    (state is then its own, and a new entry not cached)."""
    if new or not _fits(g, state):
        if not new:
            _load(g, step, state, QN)     # Q0/QN/hyper/rows of this solve
        # a cached entry whose layout does not fit settles eagerly and
        # captures nothing: its iterations stay in the caller's span
        with (tracing.span("graph.capture", region=g.region) if new
              else tracing.OFF) as s:
            state, count, over = _settle(g, step, state, it_limit, count)
            if over:
                return state, count, True
            if new:
                _make_room()
                _record_loop(g, step.Q0.device)
                _CACHE[g.key] = g
                s.set(capture_ms=g.capture_ms,
                      instantiate_ms=g.instantiate_ms)
    _load(g, step, state, QN)
    return state, count, False


def _first_solve(g: _Graph, step, state, it_limit: int) -> int:
    """A whole solve of `step` from `state` that captures g's loop on its
    way and leaves its last state in g's static state (the MPC tick's
    first solve): its eager iterations (_settle), the capture, whether or
    not the solve ended in them, then replays. Returns the count."""
    count, over = 0, it_limit <= 0
    if not over:
        with tracing.span("graph.capture", region=g.region) as s:
            state, count, over = _settle(g, step, state, it_limit, 0)
            _record_loop(g, step.Q0.device)
            s.set(capture_ms=g.capture_ms, instantiate_ms=g.instantiate_ms)
    _load(g, step, state)
    if not over:
        count = _loop(g, step, it_limit, count)
    return count


def run(step, state, it_limit: int, count: int, k: int = CHUNK,
        mask: bool = False):
    """solver.run_until's loop on the graphs of step: (state, count), and
    with mask=True the done mask read with the loop's condition (the
    compacted path's one read a chunk of k). The state returned is the
    solve's own (a copy, never a graph buffer)."""
    if count >= it_limit or bool(state.done.all()):
        return (state, count, state.done.cpu().numpy()) if mask else (
            state, count)
    with _LOCK:
        with tracing.span("graph.lookup") as s:
            how = route(step)
            key, tensors = key_of(step, layout(state), how, k)
            _purge()
            g = _lookup(key, tensors)
            s.set(hit=g is not None)
        new = g is None
        if new:
            g = _buffers(step, state, key, tensors, how, k)
        state, count, over = _ready(g, new, step, state, it_limit, count)
        if over:
            return (state, count, state.done.cpu().numpy()) if mask else (
                state, count)
        count = _loop(g, step, it_limit, count, mask)
        out = map_tensors(g.state, torch.clone)
        _release(g, g.Q0.device)
        return (out, *count) if mask else (out, count)


@dataclasses.dataclass(eq=False, kw_only=True)
class _Goal(_Region):
    """The goal band's graph (api/plan.py resolve_goal_tolerance, JAX's
    ``_jitted_goal``): one region over static q0, qN, the band's rows and
    the uniforms, and the entry's copies of the robot and the world; `out`
    is the chosen goal."""

    region: str = "goal"
    key: tuple
    refs: tuple
    versions: tuple
    robot: object
    world: object
    cfg: object
    fn: Callable
    args: tuple               # q0, qN, below, above, u
    out: torch.Tensor | None = None
    held: tuple = ()
    released: object = None

    def body(self) -> None:
        self.out = self.fn(self.robot, self.world, self.cfg, *self.args)

    def buffers(self) -> list:
        return list(self.args)

    def regions(self) -> tuple:
        return (self,)

    def info(self) -> dict:
        return dict(kind="goal_band", route=None, k=None,
                    batch=tuple(self.args[0].shape),
                    static_bytes=_nbytes(self.buffers(),
                                         (self.robot, self.world)),
                    **self.cost(), regions={"goal_band": self.cost()})


def goal(fn, robot, world, cfg, q0, qN, below, above, u) -> torch.Tensor:
    """fn(robot, world, cfg, q0, qN, below, above, u) -> the goal [..., d]
    (api/plan.py's band) on a cached graph, the counterpart of JAX's
    ``_jitted_goal``: one entry per robot (by identity and version), world
    type and shapes, collision threshold and the arguments' shapes. A call
    copies its arguments (u, the band's uniforms, included: never frozen)
    and the world's values (_load_inputs) into the entry and replays it;
    a miss runs fn eagerly on the capture stream, then captures it.
    Returns the call's own tensor."""
    tensors = []
    skeleton = (_skeleton(robot, tensors), _skeleton(world, []))
    args = (q0, qN, below, above, u)
    inputs = _inputs(world)
    key = ("goal_band", skeleton, tuple(map(id, tensors)),
           cfg.collision_threshold, q0.device,
           tuple((tuple(v.shape), v.dtype) for v in args))
    dev = q0.device
    with _LOCK:
        with tracing.span("graph.lookup") as s:
            _purge()
            g = _lookup(key, tensors)
            s.set(hit=g is not None)
        if g is None:
            own = clone_with_mirrors
            g = _Goal(key=key, refs=_refs(key, tensors),
                      versions=tuple(t._version for t in tensors),
                      robot=own(robot), world=own(world), cfg=cfg, fn=fn,
                      args=tuple(torch.empty(v.shape, dtype=v.dtype,
                                             device=dev).copy_(v)
                                 for v in args), held=_held(inputs))
            out = _on(_stream(dev), lambda: fn(g.robot, g.world, cfg,
                                               *g.args))
            _make_room()
            _captured(g, dev)
            _CACHE[key] = g
        else:
            with tracing.span("graph.load") as s:
                _wait(g, dev)
                for buf, v in zip(g.args, args):
                    buf.copy_(v)
                n, updates = _load_inputs(g, _inputs(g.world), inputs)
                s.set(inputs=n, node_updates=updates)
            g.replay()
            out = g.out.clone()
        _release(g, dev)
        return out


def _solve_in(g: _Graph, given: bool, init) -> None:
    """solve-in: init (solver._init_batch) from the loaded Q0, goal and
    warm start into the static goal and state."""
    QN, state = init(g.step.robot, g.step.cfg, g.Q0, g.QN_in,
                     g.theta0 if given else None)
    g.QN.copy_(QN)
    for buf, v in zip(_fields(g.state), _fields(state)):
        buf.copy_(v)
    torch.logical_not(g.state.done, out=g.active)


def solve(step, theta0, restarts: int, shapes: tuple, init, finish,
          loop=None, k: int = CHUNK):
    """solver.solve_batch on the graphs of step (built over the goal
    before wrapping): solve-in, the loop, solve-out. init(robot, cfg, Q0,
    QN, theta0) -> (QN, state) is solver._init_batch, finish(step, state,
    restarts) -> Solution its finalize (and choice of the best restart);
    shapes is the layout of init's state. loop(g, count) -> count runs the
    iterations from the entry's loaded state and leaves the last in it
    (default: the loop to max_iterations, in chunks of k). A miss runs
    init and finish eagerly on the capture stream, then captures them.
    Returns (Solution, count); the Solution is the solve's own."""
    it_limit = step.cfg.max_iterations
    if loop is None:
        def loop(g, count):
            return _loop(g, step, it_limit, count)
    dev = step.Q0.device
    given = theta0 is not None
    with _LOCK:
        with tracing.span("graph.lookup") as s:
            how = route(step)
            key, tensors = key_of(step, shapes, how, k)
            _purge()
            g = _lookup(key, tensors)
            s.set(hit=g is not None)
        if g is not None and given in g.enter:
            with tracing.span("graph.load") as s:
                _wait(g, dev)
                for buf, v in [(g.QN_in, step.QN), *_pairs(g, step),
                               *([(g.theta0, theta0)] if given else [])]:
                    buf.copy_(v)
                n, updates = _load_inputs(g, _step_inputs(g.step),
                                          _step_inputs(step))
                s.set(inputs=n, node_updates=updates)
            g.enter[given].replay()
            count = loop(g, 0) if it_limit > 0 else 0
        else:
            QN, state = _on(_stream(dev), lambda: init(
                step.robot, step.cfg, step.Q0, step.QN, theta0))
            new = g is None
            if new:
                g = _buffers(step, state, key, tensors, how, k, QN=QN)
            count, over = 0, it_limit <= 0
            if not over:
                state, count, over = _ready(g, new, step, state, it_limit,
                                            0, QN)
            if over and g.key not in _CACHE:
                sol = _on(_stream(dev), lambda: finish(
                    step.over(QN=QN), state, restarts))
                return sol, count
            if over:
                _load(g, step, state, QN)
            else:
                count = loop(g, count)
            if given and g.theta0 is None:
                g.theta0 = theta0.clone()
            g.enter[given] = _Stage(
                region="solve-in", entry=g,
                fn=lambda e, t=given: _solve_in(e, t, init))
            _captured(g.enter[given], dev)
        out = g.leave.get(restarts)
        if out is None:
            sol = map_tensors(_on(_stream(dev), lambda: finish(
                g.step, g.state, restarts)), torch.clone)
            out = g.leave[restarts] = _Stage(
                region="solve-out", entry=g,
                fn=lambda e, R=restarts: finish(e.step, e.state, R))
            _captured(out, dev)
        else:
            out.replay()
            sol = map_tensors(out.out, torch.clone)
        _release(g, dev)
        return sol, count

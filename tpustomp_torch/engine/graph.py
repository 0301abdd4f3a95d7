"""CUDA graphs of the solver's iteration: the port's counterpart of the JAX
package's compiled solver program.

JAX runs a batched solve as one device program, compiled once per (config,
shapes) and cached: ``_jitted_solve_batch`` and ``_jitted_solve``
(``tpustomp/api/plan.py:168-211``, ``lru_cache(maxsize=32)``) around the
``lax.while_loop`` of ``solver.solve_batch``
(``tpustomp/engine/solver.py:827-848``), and ``_jitted_chunk_batch``
(``tpustomp/engine/solver.py:900-919``), the compacted path's chunk, one
program per bucket shape. The port captures one iteration,
``solver.Step.advance``, as a CUDA graph over static buffers and replays it
once an iteration. ``solver.run_until`` keeps the loop, the draw
(``noise_fn``, outside the graph, written into the graph's input buffer)
and the one read of the loop's condition an iteration, as JAX keeps its
condition outside the body (the graph writes the condition and the draw's
active rows itself). An iteration then costs the host the draw, one
replay and one copy of a flag to the host, instead of some 260 kernel
launches.

- Capture (:func:`run`, on a cache miss). The solve's own next iteration
  runs eagerly on the capture stream: it builds the kernel libraries,
  settles every parameter route (kernels/rollout.py ``_launch_params``)
  and sets up the stream's cuBLAS workspace. A set built on the card
  defers its one device read to its second launch (a capture may not
  read), so while an eager iteration deferred one, one more runs
  ("param_read"): the graph then holds the parameter block, as the eager
  loop does from its second iteration. These iterations and the capture
  run the graph's own step, over copies of the robot, world, constraints
  and ``DeviceOps`` (with their host copies). Then ``advance`` is captured on
  that stream, in a memory pool
  of its own, over static buffers: the state (advanced in place by copies
  at the end of the captured region), the draws, Q0/QN and the
  ``HyperParams`` rows. Replays run on the current stream. A capture or a
  replay that raises is an error; nothing falls back to the eager loop.
- Cache. One graph per step kind, config, state and batch shapes, device,
  HyperParams or none, and robot, world, constraints and ``DeviceOps``:
  their fields other than tensors, and each tensor's identity and version
  (``_version``), as ``_launch_params`` keys the parameter block. The
  entry points hand the solver one device copy of equal CPU robots,
  worlds and constraints (``_tensors.shared_copy``), so calls with objects
  built on the CPU hit too. The cache holds those tensors weakly: a graph
  whose tensors are gone is dropped at the next call. At most
  :data:`LIMIT` graphs, least recently used first out; a dropped graph's
  pool goes back to torch's allocator. The compacted path's buckets are
  graphs of their own (a batch size each).
- Per-scenario worlds (``world_batched``: the MPC tick's, a batch's rows
  of ``solve_batch_compacted``). The leaves that carry the row axis (an
  AnalyticWorld's four, a composite's ``overlay``) are inputs of the
  graph, as Q0 and the state are: the key names them by type, shapes and
  dtypes only, and :func:`_load` copies them into contiguous static
  buffers before the first replay of every solve. The rest of the world (a
  composite's grid and packed table) is keyed by identity and version, as
  a shared world is. The kernels read a row world's spheres and boxes
  through device pointers (``kernels/rollout.py`` ``_launch``:
  ``_prim_arrays``); ``_launch_params(shared=False)`` packs only the
  robot, a grid's origin and resolution and the constraints into the
  parameter block, so a replay sees every solve's rows.
- What a graph freezes. The kernels' parameter block is filled on the host
  at capture and passed by value, and the host's decisions (parameter
  route, lane plan, joint types) are taken then: from the robot, the
  shared world and the constraints, which the key names by identity and
  version, and from shapes. A new robot, shared world or constraint
  tensor, or a torch write to one (it moves the version), gets a new
  graph. A write that moves no version (through ``.data``, a DLPack
  alias, a custom CUDA op) is not seen, as it is not by the parameter
  block itself.
- Results never alias the graph: :func:`run` returns a copy of the static
  state, so a Solution survives the next replay of the same graph.
- Counters. The kernel wrappers count host calls (``rollout.LAUNCHES``,
  ``PARAM_ROUTES``, ``LAYOUTS``, ``BODY_ORDER``). What a capture added is
  taken back and added again at every replay, so a graphed run counts what
  the eager loop counts. :data:`GRAPHS` counts captures, replays,
  evictions, invalidations and eager iterations by reason.
- Eager cases, decided before any capture (:func:`eager_reason`): a CPU
  step ("cpu"), ``utils.tracing.debug_mode`` ("debug_mode": the state is
  checked after every iteration), keyed tensors moved under
  ``torch.inference_mode`` ("inference_tensors": no version to key on), a
  robot whose joint types only the device holds ("joint_types_on_card":
  FK would read them inside the capture), and the caller's request
  ("requested": :func:`eager`, around any entry point, for comparisons).
- The MPC tick (engine/mpc.py ``_Tick``) is one cache entry of three
  regions over static buffers: the tick's own work before the solve, this
  module's iteration graph, and its work after the solve; the same lock,
  LRU, counters and ordering event serve it.

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

import torch

from tpustomp_torch._tensors import clone_with_mirrors, map_tensors
from tpustomp_torch.kernels import rollout
from tpustomp_torch.robot.model import joint_types_on_host
from tpustomp_torch.utils import tracing
from tpustomp_torch.world.sdf import CompositeWorld

# Most graphs cached at once (a config-4 graph's pool is about a GB).
LIMIT = 8

# Captures (one a region: an MPC tick captures three), replays, graphs
# evicted (LIMIT), invalidated (a version moved) or dead (a tensor of the
# key is gone), and iterations run eagerly by reason: "first_iteration"
# (the iteration before a capture, or before replays from a state whose
# strides differ from the graph's), "param_read" (the one after a first
# iteration that deferred a parameter read) and the reasons of
# eager_reason.
GRAPHS = collections.Counter()

_ENABLED = contextvars.ContextVar("tpustomp_torch_graphs", default=True)
_CACHE: collections.OrderedDict = collections.OrderedDict()
_DEAD: list = []        # keys of graphs a tensor of which is gone
_STREAMS: dict = {}
_LOCK = threading.RLock()
_COUNTERS = (rollout.LAUNCHES, rollout.PARAM_ROUTES, rollout.LAYOUTS,
             rollout.BODY_ORDER)


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


def eager_reason(step) -> str | None:
    """Why `step` runs in the eager loop, or None when it replays a graph.
    `step` may be any object with a Step's robot, world, world_batched,
    constraints, ops and Q0 (the MPC tick passes its own)."""
    if not _ENABLED.get():
        return "requested"
    if tracing.debug_enabled():
        return "debug_mode"
    if any(t.is_inference() for t in _keyed(step)[1]):
        return "inference_tensors"
    if not joint_types_on_host(step.robot):
        return "joint_types_on_card"
    if step.Q0.device.type != "cuda":
        return "cpu"
    return None


@dataclasses.dataclass(eq=False, kw_only=True)
class _Region:
    """One captured region: its CUDA graph, what one replay adds to each
    counter, and what its capture cost."""

    graph: object = None      # torch.cuda.CUDAGraph
    counts: tuple = ()        # what one replay adds to each counter
    pool_bytes: int = 0
    capture_ms: float = 0.0
    instantiate_ms: float = 0.0
    replays: int = 0

    def replay(self) -> None:
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
class _Graph(_Region):
    """One captured iteration and its static buffers."""

    key: tuple
    refs: tuple               # weak references to the key's tensors
    versions: tuple
    kind: str
    Q0: torch.Tensor          # the static buffers: Q0/QN, HyperParams rows
    QN: torch.Tensor
    hyper: object
    state: object             # the static SolverState
    draws: tuple              # the draws' buffers (Step.draw_shapes)
    active: torch.Tensor      # ~state.done, for the next draw
    finished: torch.Tensor    # state.done.all(), the loop's condition
    step: object = None       # the Step over the buffers and copies
    released: object = None   # event after the last solve's use, or None

    def body(self) -> None:
        """The captured region: advance, the new state copied into the
        static state, then what the host reads before the next iteration
        (the draw's active rows, the loop's condition), so it launches
        nothing of its own for them."""
        draws = (self.draws[0] if self.kind == "stomp"
                 else self.draws if self.kind == "hmc" else None)
        new = self.step.advance(self.state, draws)
        for f in dataclasses.fields(self.state):
            getattr(self.state, f.name).copy_(getattr(new, f.name))
        torch.logical_not(self.state.done, out=self.active)
        self.finished.copy_(self.state.done.all())

    def rows(self):
        """The static buffers of a per-scenario world's rows, or None."""
        return _rows(self.step.world, self.step.world_batched)

    def buffers(self) -> list:
        """Every static buffer: what a solve loads and the region writes."""
        rows = self.rows()
        return [*self.draws, *_fields(self.state), self.active,
                self.finished, self.Q0, self.QN,
                *(() if self.hyper is None else _fields(self.hyper)),
                *(() if rows is None else _fields(rows))]

    def copies(self) -> tuple:
        """The graph's copies of the keyed inputs."""
        return (self.step.robot, _shared(self.step.world,
                                         self.step.world_batched),
                self.step.constraints, self.step.ops)

    def regions(self) -> tuple:
        return (self,)

    def info(self) -> dict:
        return dict(kind=self.kind, batch=tuple(self.Q0.shape),
                    static_bytes=_nbytes(self.buffers(), self.copies()),
                    **self.cost())


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
    and version: all of them but a per-scenario world's rows, which it
    names by type, shapes and dtypes (they are loaded like the state)."""
    tensors = []
    rows = _rows(step.world, step.world_batched)
    skeleton = (_skeleton((step.robot, _shared(step.world,
                                                step.world_batched),
                           step.constraints, step.ops), tensors),
                type(step.world).__qualname__, _skeleton(rows, []))
    return skeleton, tensors


def key_of(step, state) -> tuple[tuple, list]:
    """(key, tensors): the cache key of `step` run from `state` and the
    tensors it names by identity (their versions are checked on a hit)."""
    skeleton, tensors = _keyed(step)
    shapes = tuple((tuple(v.shape), v.dtype) for v in _fields(state))
    key = (step.kind, step.cfg, tuple(step.Q0.shape), step.Q0.device,
           step.hyper is None, step.world_batched, shapes, skeleton,
           tuple(map(id, tensors)))
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
            r.graph.reset()


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
    pool and static bytes, capture and instantiate ms and replays (an MPC
    tick's iteration graph's, with each region's under "regions")."""
    with _LOCK:
        _purge()
        return [g.info() for g in _CACHE.values()]


def _stream(device) -> torch.cuda.Stream:
    """The device's capture stream (one, so its cuBLAS workspace is set
    up once, by a warm-up outside any capture)."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _on(stream, fn):
    """fn() on `stream`, ordered after the current stream's work and before
    its later work; tensors it returns are marked as used there."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    for v in _fields(out):
        v.record_stream(cur)
    return out


def _capture(body: Callable[[], None], stream):
    """body() captured on `stream` into a new CUDA graph with a memory pool
    of its own: (graph, capture ms, instantiate ms, pool bytes)."""
    graph = torch.cuda.CUDAGraph()
    reserved = torch.cuda.memory_reserved(stream.device)
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
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
            raise
        t1 = time.perf_counter()
        graph.capture_end()             # instantiates
        t2 = time.perf_counter()
    cur.wait_stream(stream)
    return (graph, 1e3 * (t1 - t0), 1e3 * (t2 - t1),
            torch.cuda.memory_reserved(stream.device) - reserved)


def _snapshot() -> list[dict]:
    return [dict(c) for c in _COUNTERS]


def _record(r: _Region, body: Callable[[], None], device) -> None:
    """body() captured into the region r on the device's capture stream;
    what the capture counted moves to r's replays. The allocator's cached
    blocks are released first: a capture allocates new segments for its
    pool and may not release cached ones itself, not even the pools of
    dropped graphs, which torch frees only then."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    before = _snapshot()
    r.graph, r.capture_ms, r.instantiate_ms, r.pool_bytes = _capture(
        body, _stream(device))
    # the capture launched nothing: its counts move to the replays
    r.counts = tuple({k: c[k] - b[k] for k in c}
                     for c, b in zip(_COUNTERS, before))
    for c, b in zip(_COUNTERS, before):
        c.update(b)
    GRAPHS["captured"] += 1


def _static_world(world, batched: bool, own):
    """A graph's world: a per-scenario world's rows as contiguous static
    buffers (loaded by _load), the rest as `own` makes it."""
    rows = _rows(world, batched)
    if rows is None:
        return own(world)
    bufs = map_tensors(rows, lambda v: v.clone(
        memory_format=torch.contiguous_format))
    if isinstance(world, CompositeWorld):
        return CompositeWorld(grid=own(world.grid), overlay=bufs)
    return bufs


def _buffers(step, state, key, tensors, own=clone_with_mirrors) -> _Graph:
    """A graph's static buffers for `step` from `state`, and its step over
    them and over `own`'s copies of the robot, world, constraints and
    DeviceOps (by default clones with their host copies: the graph holds
    nothing of the caller's but weak references, so it goes when they do,
    and its step keeps what the captured kernels read (the copies, and
    what building the step put on the device) for as long as it may
    replay)."""
    hyper = (None if step.hyper is None
             else map_tensors(step.hyper, torch.clone))
    g = _Graph(key=key, refs=_refs(key, tensors),
               versions=tuple(t._version for t in tensors),
               kind=step.kind, Q0=step.Q0.clone(), QN=step.QN.clone(),
               hyper=hyper, state=map_tensors(state, torch.clone),
               draws=tuple(torch.empty(shape, dtype=torch.float32,
                                       device=step.Q0.device)
                           for shape in step.draw_shapes()),
               active=torch.empty_like(state.done),
               finished=torch.empty((), dtype=torch.bool,
                                    device=step.Q0.device))
    g.step = step.over(
        Q0=g.Q0, QN=g.QN, hyper=hyper, noise_fn=None,
        robot=own(step.robot),
        world=_static_world(step.world, step.world_batched, own),
        constraints=tuple(map(own, step.constraints)),
        ops=own(step.ops))
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


def _load(g: _Graph, step, state) -> None:
    """The solve's state, Q0/QN, HyperParams and world rows into the
    static buffers, after the last solve that used them."""
    _wait(g, g.Q0.device)
    pairs = [(g.Q0, step.Q0), (g.QN, step.QN),
             *zip(_fields(g.state), _fields(state))]
    if step.hyper is not None:
        pairs += zip(_fields(g.hyper), _fields(step.hyper))
    rows = g.rows()
    if rows is not None:
        pairs += zip(_fields(rows), _fields(_rows(step.world, True)))
    for buf, v in pairs:
        buf.copy_(v)
    torch.logical_not(g.state.done, out=g.active)


def _settle(g: _Graph, step, state, it_limit: int, count: int):
    """The solve's next iteration, run eagerly over g's step on the capture
    stream (it builds the kernels' libraries, settles their parameter
    routes and the stream's cuBLAS workspace), and one more while it
    deferred a parameter read: (state, count, whether the solve is
    over)."""
    stream = _stream(step.Q0.device)
    for reason in ("first_iteration", "param_read"):
        deferred = rollout.PARAM_READS["deferred"]
        state = _on(stream, lambda s=state, c=count: g.step.advance(
            s, step.draw(c, s.done)))
        count += 1
        GRAPHS["eager:" + reason] += 1
        if count >= it_limit or bool(state.done.all()):
            return state, count, True
        if rollout.PARAM_READS["deferred"] == deferred:
            break
    return state, count, False


def _iterate(g: _Graph, step, it_limit: int, count: int) -> int:
    """Replays from g's loaded state until every row is done or the count
    reaches it_limit: each the draw into g's buffers, one replay and the
    read of the loop's condition. Returns the count."""
    while True:
        step.draw_into(count, g.active, g.draws)
        g.replay()
        count += 1
        if count >= it_limit or bool(g.finished):
            return count


def _first_solve(g: _Graph, step, state, it_limit: int) -> None:
    """A whole solve of `step` from `state` that captures g on its way and
    leaves its last state in g's static state (the MPC tick's first
    solve): its eager iterations (_settle), g's capture, whether or not
    the solve ended in them, then replays."""
    count, over = 0, it_limit <= 0
    if not over:
        state, count, over = _settle(g, step, state, it_limit, 0)
        _record(g, g.body, step.Q0.device)
    _load(g, step, state)
    if not over:
        _iterate(g, step, it_limit, count)


def run(step, state, it_limit: int, count: int):
    """solver.run_until's loop on a graph of step.advance: (state, count).
    The state returned is the solve's own (a copy, never a graph buffer)."""
    if count >= it_limit or bool(state.done.all()):
        return state, count
    key, tensors = key_of(step, state)
    with _LOCK:
        _purge()
        g = _lookup(key, tensors)
        new = g is None
        if new:
            g = _buffers(step, state, key, tensors)
        if new or not _fits(g, state):
            if not new:
                _load(g, step, state)       # Q0/QN/hyper/rows of this solve
            state, count, over = _settle(g, step, state, it_limit, count)
            if over:
                return state, count
            if new:
                _make_room()
                _record(g, g.body, step.Q0.device)
                _CACHE[key] = g
        _load(g, step, state)
        count = _iterate(g, step, it_limit, count)
        out = map_tensors(g.state, torch.clone)
        _release(g, g.Q0.device)
        return out, count

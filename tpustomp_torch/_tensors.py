"""Frozen dataclasses of tensors: the port's stand-in for flax pytrees."""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import torch

# Host copies of the small tensors to_device moves from the CPU to another
# device (a robot's and a world's parameters), so a kernel launch can fill
# its parameter block without reading the device: id(device tensor) ->
# (weak reference, the tensor's version when moved, numpy copy). A tensor
# made on the device, or changed in place since (its version moved), has
# none; so has one moved under torch.inference_mode() (it keeps no version).
# Grids, other large tensors and bfloat16 ones (numpy has no such type) are
# not copied; the limit holds any one tensor of a set that fits the kernels'
# large parameter block (kernels/rollout.py _LARGE_PARAM_FLOATS).
MIRROR_MAX = 8192           # elements
_MIRRORS: dict[int, tuple] = {}


def map_tensors(obj, fn):
    """A copy of the frozen dataclass `obj` with fn applied to every tensor
    field, nested dataclasses included; other fields unchanged (the port's
    ``jax.tree.map``)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = map_tensors(v, fn)
    return dataclasses.replace(obj, **changes)


def fields(obj) -> list:
    """The values of the dataclass `obj`'s fields, in order."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def host_mirror(t: torch.Tensor):
    """The numpy copy of device tensor `t` kept when to_device moved it
    there, or None: no copy, or `t` changed in place since. A write that
    does not move `t._version` is not seen: through ``t.data``, a DLPack
    or other alias sharing its storage, or a kernel writing its pointer.
    The same holds for a set made on the device: kernels/rollout.py
    _launch_params reads its values once per version."""
    entry = _MIRRORS.get(id(t))
    if entry is None or entry[0]() is not t or entry[1] != t._version:
        return None
    return entry[2]


def _moved(v: torch.Tensor, device) -> torch.Tensor:
    out = v.to(device)
    if (out is not v and v.device.type == "cpu" and out.device.type != "cpu"
            and v.numel() <= MIRROR_MAX and v.dtype != torch.bfloat16
            and not out.is_inference()):
        _mirror(out, v.detach().numpy().copy())
    return out


def _mirror(t: torch.Tensor, mirror) -> None:
    """`mirror` as t's host copy at t's current version (none if None)."""
    key = id(t)
    if mirror is None:
        _MIRRORS.pop(key, None)
        return
    _MIRRORS[key] = (weakref.ref(t, lambda _, k=key: _MIRRORS.pop(k, None)),
                     t._version, mirror)


def _cloned(v: torch.Tensor) -> torch.Tensor:
    out = v.clone()
    mirror = host_mirror(v)
    if mirror is not None:
        _mirror(out, mirror)
    return out


def copy_with_mirror(dst: torch.Tensor, src: torch.Tensor) -> None:
    """src's values into dst, and src's host copy made dst's (none where
    src has none): a graph's copy of a world loaded from the caller's
    keeps the host copy its parameter block is filled from
    (engine/graph.py)."""
    dst.copy_(src)
    _mirror(dst, host_mirror(src))


def clone_with_mirrors(obj):
    """A copy of `obj` with every tensor cloned; a clone of a tensor with a
    host copy (host_mirror) has the same host copy."""
    return map_tensors(obj, _cloned)


def to_device(obj, device):
    """`obj` with every tensor moved to `device`; a small tensor moved off
    the CPU keeps its host copy (host_mirror)."""
    return map_tensors(obj, lambda v: _moved(v, device))


# to_host's least bytes of CUDA tensors for the pinned copy: below it (one
# query's answer, a few KB) the pageable copies cost less than the pinned
# allocations and their events
PINNED_MIN_BYTES = 1 << 20


def to_host(obj):
    """`obj` with every tensor on the host. When its CUDA tensors hold
    PINNED_MIN_BYTES or more, each is copied into page-locked memory from
    torch's caching host allocator, the copies queued on their device's
    current stream, then one wait for them: a pageable copy is staged by
    CUDA through a bounce buffer and waits at every tensor (8.5 MB of a
    CHOMP batch's answer: 3-13 ms against 0.33 ms pinned on an H100).
    Else as :func:`to_device`. The values are the same."""
    size = 0

    def count(v):
        nonlocal size
        if v.device.type == "cuda":
            size += v.numel() * v.element_size()
        return v

    map_tensors(obj, count)
    if size < PINNED_MIN_BYTES:
        return to_device(obj, "cpu")
    streams = {}

    def down(v):
        if v.device.type != "cuda":
            return v.to("cpu")
        streams[v.device] = torch.cuda.current_stream(v.device)
        return torch.empty(v.shape, dtype=v.dtype,
                           pin_memory=True).copy_(v, non_blocking=True)

    out = map_tensors(obj, down)
    for stream in streams.values():
        stream.synchronize()
    return out


# Device copies that shared_copy made of CPU objects (robots, worlds,
# constraints handed to the entry points): value key -> (weak references
# to the large CPU tensors it names by identity, the copy). At most
# SHARED_MAX, least recently used first out; an entry goes when one of its
# large CPU tensors does.
SHARED_MAX = 16
_SHARED: collections.OrderedDict = collections.OrderedDict()
_SHARED_LOCK = threading.Lock()


def _value_key(obj, large: list):
    """obj's structure with each CPU tensor replaced by its dtype, shape
    and bytes (those of MIRROR_MAX elements or fewer) or its identity and
    version (larger ones, appended to `large`); None when a tensor is off
    the CPU, has no version (inference_mode) or is bfloat16."""
    if isinstance(obj, torch.Tensor):
        if (obj.device.type != "cpu" or obj.is_inference()
                or obj.dtype == torch.bfloat16):
            return None
        if obj.numel() <= MIRROR_MAX:
            return (obj.dtype, tuple(obj.shape),
                    obj.detach().contiguous().numpy().tobytes())
        large.append(obj)
        return (obj.dtype, tuple(obj.shape), id(obj), obj._version)
    if dataclasses.is_dataclass(obj):
        parts = [type(obj).__qualname__]
        for f in dataclasses.fields(obj):
            part = _value_key(getattr(obj, f.name), large)
            if part is None and getattr(obj, f.name) is not None:
                return None
            parts.append(part)
        return tuple(parts)
    if isinstance(obj, (tuple, list)):
        parts = tuple(_value_key(v, large) for v in obj)
        return None if any(p is None and v is not None
                           for p, v in zip(parts, obj)) else parts
    return obj


def shared_copy(obj, device):
    """``obj.to(device)`` for a frozen dataclass of tensors, the same copy
    for every CPU object equal to one moved before: small tensors compared
    by value, large ones (a grid) by identity and version. Repeated calls
    with a robot or world built on the CPU then hand the solver the same
    device tensors, which its CUDA graphs key on (engine/graph.py). The
    copy is the solver's own and never changed in place; an object with a
    tensor off the CPU, or moved under inference_mode, is moved as
    ``to_device`` moves it."""
    device = torch.device(device)
    if device.type == "cpu":
        return to_device(obj, device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    large = []
    key = _value_key(obj, large)
    try:
        hash(key)
    except TypeError:                   # a field that does not hash
        key = None
    if key is None:
        return to_device(obj, device)
    key = (key, str(device))
    with _SHARED_LOCK:
        hit = _SHARED.get(key)
        if hit is not None and all(r() is t for r, t in zip(hit[0], large)):
            _SHARED.move_to_end(key)
            return hit[1]
        out = to_device(obj, device)
        while len(_SHARED) >= SHARED_MAX:
            _SHARED.popitem(last=False)
        _SHARED[key] = (tuple(weakref.ref(t, lambda _, k=key: _SHARED.pop(
            k, None)) for t in large), out)
        return out

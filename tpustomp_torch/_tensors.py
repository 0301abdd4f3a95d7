"""Frozen dataclasses of tensors: the port's stand-in for flax pytrees."""

from __future__ import annotations

import dataclasses
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
        key = id(out)
        _MIRRORS[key] = (weakref.ref(out, lambda _, k=key: _MIRRORS.pop(k,
                                                                        None)),
                         out._version, v.detach().numpy().copy())
    return out


def to_device(obj, device):
    """`obj` with every tensor moved to `device`; a small tensor moved off
    the CPU keeps its host copy (host_mirror)."""
    return map_tensors(obj, lambda v: _moved(v, device))

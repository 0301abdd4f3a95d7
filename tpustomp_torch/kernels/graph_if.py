"""Conditional IF nodes in a captured CUDA graph (``csrc/graph_if.cu``).

The solver's chunk of iterations (engine/graph.py) is k captured bodies,
each under an IF node whose condition is a device int32 the previous body
wrote: the counterpart of the condition of JAX's ``lax.while_loop``, read
on the device. torch builds without ``CUDAGraph.begin_capture_to_if_node``
(torch 2.11 among them) cannot express such a node, so the node is added
here through the CUDA runtime: :func:`begin` appends it to the graph the
parent stream is capturing and starts capturing a body stream into its
body graph; :func:`end` ends that. The library is built by nvcc from the
checkout at first use, as the rollout kernels are (kernels/rollout.py
``build``), with a plain C interface called through ctypes.

``NODES`` counts the IF nodes captured in this process.
"""

from __future__ import annotations

import ctypes

import torch

from tpustomp_torch.kernels import rollout

NODES = {"captured": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LOADED: set = set()      # device indices whose module is loaded
_TYPED: set = set()       # ids of the libraries whose entries are typed


def _library() -> ctypes.CDLL:
    lib = rollout.build(("graph_if",))[("graph_if", None)]
    if id(lib) not in _TYPED:
        _TYPED.add(id(lib))
        lib.graph_if_load.argtypes = [_I]
        lib.graph_if_begin.argtypes = [_I, _P, _P, _P]
        lib.graph_if_end.argtypes = [_I, _P]
        for fn in (lib.graph_if_load, lib.graph_if_begin, lib.graph_if_end):
            fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")


def load(device: torch.device) -> None:
    """Build the library and load its kernel on `device`, outside any
    capture."""
    index = torch.device(device).index or 0
    if index not in _LOADED:
        _check(_library().graph_if_load(index), "graph_if_load")
        _LOADED.add(index)


def begin(parent: torch.cuda.Stream, pred: torch.Tensor,
          body: torch.cuda.Stream) -> None:
    """While `parent` captures a graph: add an IF node on the device int32
    scalar `pred` (its body runs while it is nonzero) and start capturing
    `body` into the node's body."""
    if pred.dtype != torch.int32 or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError("an IF node's condition is a CUDA int32 scalar")
    _check(_library().graph_if_begin(pred.device.index, parent.cuda_stream,
                                     pred.data_ptr(), body.cuda_stream),
           "graph_if_begin")
    NODES["captured"] += 1


def end(body: torch.cuda.Stream) -> None:
    """End the capture of the IF node's body on `body`."""
    _check(_library().graph_if_end(body.device.index, body.cuda_stream),
           "graph_if_end")

"""The evaluators' parameter block in captured CUDA graphs
(``csrc/graph_node.cu``).

A rollout kernel takes the robot's, a shared world's and the constraints'
parameters by value (kernels/rollout.py ``_launch_params``: the 3 KB
block or the 31 KB large block), so a captured launch holds them in its
node. engine/graph.py keys a graph by the world's and the constraints'
shapes, as JAX's jit keys its compiled program, and loads their values at
each solve: the tensors are copied into the graph's own, and each node
whose block then differs gets the new one here.

While one of the solver's regions is captured (:func:`recording`), every
evaluator launch on a parameter block adds a :class:`Node`: the kernel
node the launch appended (:func:`record`, which checks that the node's
argument :data:`PAR` holds the block the launch filled) and the objects
its block was packed from. :func:`rewrite` writes a new block into the
instantiated graph's copy of the node (``cuGraphExecKernelNodeSetParams``).
The library is built by nvcc from the checkout at first use, as the
rollout kernels are (kernels/rollout.py ``build``), with a plain C
interface called through ctypes.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses

import numpy as np
import torch

from tpustomp_torch.kernels import rollout

# The rollout kernels' arguments (World, Chain, Par, Shape): their count
# and Par's place among them.
ARGS = 4
PAR = 2

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_LOADED: set = set()      # device indices the library is set up on
_TYPED: set = set()       # ids of the libraries whose entries are typed
_RECORDING = contextvars.ContextVar("tpustomp_torch_graph_nodes",
                                    default=None)


@dataclasses.dataclass(eq=False)
class Node:
    """An evaluator launch in a captured graph: its device, its kernel node
    (of the graph kept beside the instantiated one), the floats its block
    holds, the vector in it now, and (robot, world, shared, constraints),
    the objects its block is packed from (kernels/rollout.py
    ``block_params``)."""

    device: int
    handle: int
    floats: int
    params: np.ndarray
    args: tuple


def _library() -> ctypes.CDLL:
    lib = rollout.build(("graph_node",))[("graph_node", None)]
    if id(lib) not in _TYPED:
        _TYPED.add(id(lib))
        lib.graph_node_load.argtypes = [_I]
        lib.graph_node_last.argtypes = [_I, _P, ctypes.POINTER(_P)]
        lib.graph_node_param.argtypes = [_I, _P, _I, _P, _S]
        lib.graph_node_set_param.argtypes = [_I, _P, _P, _I, _I, _P]
        for fn in (lib.graph_node_load, lib.graph_node_last,
                   lib.graph_node_param,
                   lib.graph_node_set_param):
            fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def load(device: torch.device) -> None:
    """Build the library and initialise it on `device`, outside any
    capture."""
    index = torch.device(device).index or 0
    if index not in _LOADED:
        _check(_library().graph_node_load(index), "graph_node_load")
        _LOADED.add(index)


def _block(params: np.ndarray, floats: int) -> np.ndarray:
    """The block a launch fills from `params`: the vector, then zeros
    (csrc/rollout_common.cuh fill_block)."""
    out = np.zeros(floats, np.float32)
    out[:params.size] = params
    return out


@contextlib.contextmanager
def recording(nodes: list):
    """Inside the block, the evaluator launches captured on a parameter
    block append their Node to `nodes`."""
    token = _RECORDING.set(nodes)
    try:
        yield
    finally:
        _RECORDING.reset(token)


def record(stream: torch.cuda.Stream, route: str, params: np.ndarray,
           args: tuple) -> None:
    """After an evaluator launch on `stream` that filled a parameter block
    of `route` ("block" or "large_block") from `params`: while a region is
    recorded, its kernel node added to the record. Raises if the node's
    argument PAR does not hold that block."""
    nodes = _RECORDING.get()
    if nodes is None:
        return
    floats = (rollout._PARAM_FLOATS if route == "block"
              else rollout._LARGE_PARAM_FLOATS)
    lib, device = _library(), stream.device.index
    node = _P()
    _check(lib.graph_node_last(device, stream.cuda_stream,
                               ctypes.byref(node)), "graph_node_last")
    block = _block(params, floats)
    held = np.empty_like(block)
    _check(lib.graph_node_param(device, node, PAR, held.ctypes.data,
                                held.nbytes), "graph_node_param")
    if not np.array_equal(held.view(np.uint32), block.view(np.uint32)):
        raise RuntimeError("a captured evaluator node does not hold its "
                           f"parameter block in argument {PAR}")
    nodes.append(Node(device, node.value, floats, params.copy(), args))


def rewrite(exec_handle: int, node: Node, params: np.ndarray) -> None:
    """The instantiated graph's copy of `node` with the block of `params`:
    the graph's next replay launches it so."""
    block = _block(params, node.floats)
    _check(_library().graph_node_set_param(node.device, exec_handle,
                                           node.handle,
                                           ARGS, PAR, block.ctypes.data),
           "graph_node_set_param")
    node.params = params.copy()

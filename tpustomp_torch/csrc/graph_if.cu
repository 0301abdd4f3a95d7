// CUDA conditional IF nodes inside a stream capture, for the solver's
// graphed chunks of iterations (tpustomp_torch/engine/graph.py).
//
// torch builds that predate CUDAGraph.begin_capture_to_if_node cannot put
// a node of the captured graph under a device-side condition, so this file
// does what that method does: while `parent` is capturing a graph, it
// appends a one-thread kernel that copies a device int into a conditional
// handle, then a conditional IF node on that handle, and starts capturing
// `body` into the IF node's body graph. Whatever is launched on `body`
// until graph_if_end runs at a replay only if the int was nonzero when the
// replay reached the node. It is read on the device, so a replay never
// waits for the host.
//
// Plain C interface (ctypes); returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

// The condition of `handle` for this launch of the graph: *pred != 0.
__global__ void graph_if_set(cudaGraphConditionalHandle handle,
                             const int* pred) {
  cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
}

extern "C" int graph_if_load(int device) {
  // Loads graph_if_set's module outside any capture (a lazy load inside
  // one is not allowed).
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, graph_if_set);
}

extern "C" int graph_if_begin(int device, cudaStream_t parent,
                              const int* pred, cudaStream_t body) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, nullptr,
                               nullptr);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  graph_if_set<<<1, 1, 0, parent>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the node depends on what the parent captured last: the kernel above
  e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                               &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  // the parent's next work waits for the node, whether or not it runs
  e = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_if_end(int device, cudaStream_t body) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGraph_t graph;   // the IF node's body graph, owned by the node
  return cudaStreamEndCapture(body, &graph);
}

// The evaluators' kernel nodes in a captured CUDA graph, for the solver's
// graphs (tpustomp_torch/engine/graph.py): their by-value parameter block
// rewritten in the instantiated graph when the world or the constraints a
// graph was captured with take new values of the same shapes.
//
// The rollout kernels take (World, Chain, Par, Shape); Par is the robot's,
// a shared world's and the constraints' parameters, filled on the host at
// the launch and copied into the node by the capture. graph_node_last
// returns the kernel node a launch just appended to the graph a stream
// captures (the capture's sole dependency, read with
// cudaStreamGetCaptureInfo as graph_if_begin reads it).
// graph_node_param copies one argument's bytes out of a node (the capture
// checks its block is there), and graph_node_set_param writes a new value
// of that argument into the instantiated graph's copy of the node
// (cuGraphExecKernelNodeSetParams): the next replay launches with it; a
// replay already queued does not see it.
//
// The node's parameters are read and written through the driver API: the
// node was launched by another library's runtime, whose kernel handles
// this library's runtime does not know; the driver's CUfunction is the
// same for both. The driver's entry points are looked up through the
// runtime, so nothing links libcuda.
//
// Plain C interface (ctypes); returns a cudaError_t or a CUresult, 0 on
// success.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

using GetParams = CUresult (*)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
using SetParams = CUresult (*)(CUgraphExec, CUgraphNode,
                               const CUDA_KERNEL_NODE_PARAMS*);

// The kernels' argument count, the most this file copies
constexpr int kMaxArgs = 16;

template <class Fn>
cudaError_t entry(const char* name, Fn* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                   cudaEnableDefault, &found);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                          &found);
#endif
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess || p == nullptr)
    return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<Fn>(p);
  return cudaSuccess;
}

// The node's parameters, with its argument array (owned by the node).
int node_params(CUgraphNode node, CUDA_KERNEL_NODE_PARAMS* p) {
  static GetParams get = nullptr;
  if (get == nullptr) {
    cudaError_t e = entry("cuGraphKernelNodeGetParams", &get);
    if (e != cudaSuccess) return e;
  }
  std::memset(p, 0, sizeof(*p));
  CUresult r = get(node, p);
  if (r != CUDA_SUCCESS) return r;
  return p->kernelParams == nullptr ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" int graph_node_load(int device) {
  // Initialises this library's runtime and looks the driver's entry
  // points up outside any capture.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  GetParams get;
  e = entry("cuGraphKernelNodeGetParams", &get);
  if (e != cudaSuccess) return e;
  SetParams set;
  return entry("cuGraphExecKernelNodeSetParams", &set);
}

extern "C" int graph_node_last(int device, cudaStream_t stream,
                               void** node) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &deps,
                               &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  if (n_deps != 1) return cudaErrorInvalidValue;
  cudaGraphNodeType type;
  e = cudaGraphNodeGetType(deps[0], &type);
  if (e != cudaSuccess) return e;
  if (type != cudaGraphNodeTypeKernel) return cudaErrorInvalidValue;
  *node = deps[0];
  return 0;
}

extern "C" int graph_node_param(int device, void* node, int index,
                                void* out, size_t size) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  CUDA_KERNEL_NODE_PARAMS p;
  int r = node_params((CUgraphNode)node, &p);
  if (r != 0) return r;
  std::memcpy(out, p.kernelParams[index], size);
  return 0;
}

extern "C" int graph_node_set_param(int device, void* exec, void* node,
                                    int n_args, int index,
                                    const void* value) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n_args < 1 || n_args > kMaxArgs || index < 0 || index >= n_args)
    return cudaErrorInvalidValue;
  static SetParams set = nullptr;
  if (set == nullptr) {
    e = entry("cuGraphExecKernelNodeSetParams", &set);
    if (e != cudaSuccess) return e;
  }
  CUDA_KERNEL_NODE_PARAMS p;
  int r = node_params((CUgraphNode)node, &p);
  if (r != 0) return r;
  // the node's arguments, one of them replaced; the driver copies them
  void* args[kMaxArgs];
  for (int i = 0; i < n_args; ++i) args[i] = p.kernelParams[i];
  args[index] = const_cast<void*>(value);
  p.kernelParams = args;
  p.extra = nullptr;
  return set((CUgraphExec)exec, (CUgraphNode)node, &p);
}

// The propose stage of the time-major STOMP step, for Hopper (sm_90a):
// from the sampling GEMM's output to the evaluator's input, in one pass.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses this stage of
// tpustomp/engine/solver.py make_step_batch_tm (sample_noise_tm's scale by
// sigma, the add to theta, the joint-limit clip and the two
// concatenations) into one pass. Written out in PyTorch it is six launches
// and seven passes over the step's largest tensors: eps * sigma,
// theta + eps, a torch.cat along the innermost axis of pieces 1, K and Kr
// wide (two of them strided permutes), clamp, where, and a second cat.
// This kernel reads each input once and writes each output once:
//
//   cand [N, d, B, C], C = 1 + K + Kr, contiguous: slot 0 is theta, slots
//     1..K are theta + sigma * eps, the last Kr slots the reused rollouts;
//     every slot clipped to [lower, upper] where the joint is limited, as
//     torch.where(limited, torch.clamp(x, lower, upper), x) does (a NaN
//     passes through, as torch.clamp passes it);
//   full [d, T, B*C], T = N + 2, contiguous: row 0 is Q0 and row T-1 is
//     QN, broadcast over the C slots; the rows between are cand
//     transposed.
//
// Bitwise today's ops: the multiply and the add are rounded each
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract them into an FMA),
// and the clip is ::min(::max(v, lower), upper) after the NaN test, as
// torch's CUDA clamp computes it.
//
// What bounds it on the H100: bytes. At the config-4 shape (N 100, d 7,
// B 1,024, K 50, Kr 5) it reads 161 MB and writes 324 MB (0.145 ms at
// 3.35 TB/s); at the config-5 shape (N 50, B 10,000, K 16, Kr 4) 294 MB
// and 600 MB (0.27 ms). For a fixed (n, j) both outputs are one run of
// B*C contiguous floats, and eps one run of B*K: a block takes a tile of
// one row's columns, neighbouring threads on neighbouring columns, so the
// loads of eps and both stores coalesce. A thread takes kIlp groups of
// VEC consecutive columns, loads them all before it stores any, and
// stores a group as one float4 where a row is a whole number of float4s
// (VEC = 4; else VEC = 1, kIlp 4): on an H100 the float4 form took 0.188
// ms at the config-4 shape and 0.375 at config 5, the scalar one 0.211
// and 0.407, both above 2, 8 or 16 columns a thread. The strided inputs
// (theta [b, n, j], reuse [b, kr, n, j], Q0 / QN [b, j]; any strides) are
// about a tenth of the bytes and are re-read by the d rows of one
// waypoint, which L2 serves. Rows run on grid.y (looped past 65,535); at
// B = 1 a row is one block of 32 threads, so the grid still spreads over
// N*d + 2d blocks (2.9 us, against 12.6 for the six ops it replaces).
//
// Plain C interface (ctypes); returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

struct Args {
  const float* eps;      // [N, d, B, K], contiguous
  const float* sigma;    // [B, d], contiguous
  const float* theta;    // [B, N, d], strides th_*
  const float* reuse;    // [B, Kr, N, d], strides ru_*
  const float* q0;       // [B, d], strides q0_*
  const float* qn;       // [B, d], strides qn_*
  const float* lower;    // [d]
  const float* upper;    // [d]
  const uint8_t* limited;  // [d], bool
  float* cand;           // [N, d, B, C]
  float* full;           // [d, T, B*C]
  long long th_b, th_n, th_j;
  long long ru_b, ru_k, ru_n, ru_j;
  long long q0_b, q0_j, qn_b, qn_j;
  int N, d, B, K, Kr;
};

// torch.clamp(v, lo, hi) as torch's CUDA kernel computes it
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// VEC consecutive columns from `col` of one row: the group's first slot
// (b, c) by one division, the rest by stepping c
template <int VEC, class At>
__device__ __forceinline__ void group(int col, int C, At at, float* v) {
  int b = col / C;
  int c = col - b * C;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    v[e] = at(b, c);
    if (++c == C) {
      c = 0;
      ++b;
    }
  }
}

template <int VEC, int kIlp>
__global__ void __launch_bounds__(kThreads) propose_kernel(const Args a) {
  const int C = 1 + a.K + a.Kr;
  const int W = a.B * C;                 // columns of a row (checked < 2^31)
  const int T = a.N + 2;
  const int data_rows = a.N * a.d;
  const int rows = data_rows + 2 * a.d;
  const int col0 = (blockIdx.x * blockDim.x * kIlp + threadIdx.x) * VEC;
  const int stride = blockDim.x * VEC;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    float v[kIlp][VEC];
    float* cand = nullptr;
    float* full;
    if (row < data_rows) {
      const int n = row / a.d;
      const int j = row - n * a.d;
      const bool lim = a.limited[j] != 0;
      const float lo = a.lower[j], hi = a.upper[j];
      const float* eps = a.eps + static_cast<size_t>(row) * a.B * a.K;
      const float* theta = a.theta + n * a.th_n + j * a.th_j;
      const float* reuse = a.reuse + n * a.ru_n + j * a.ru_j;
      const auto at = [&](int b, int c) {
        float x;
        if (c == 0) {
          x = theta[b * a.th_b];
        } else if (c <= a.K) {
          const float e = __fmul_rn(
              eps[static_cast<size_t>(b) * a.K + (c - 1)],
              a.sigma[b * a.d + j]);
          x = __fadd_rn(theta[b * a.th_b], e);
        } else {
          x = reuse[b * a.ru_b + (c - 1 - a.K) * a.ru_k];
        }
        return lim ? clip(x, lo, hi) : x;
      };
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int col = col0 + i * stride;
        if (col < W) group<VEC>(col, C, at, v[i]);
      }
      cand = a.cand + static_cast<size_t>(row) * W;
      full = a.full + (static_cast<size_t>(j) * T + n + 1) * W;
    } else {
      // the endpoints' rows of full: Q0 at t = 0, QN at t = T - 1
      const int r = row - data_rows;
      const int side = r / a.d;
      const int j = r - side * a.d;
      const float* q = side == 0 ? a.q0 + j * a.q0_j : a.qn + j * a.qn_j;
      const long long qb = side == 0 ? a.q0_b : a.qn_b;
      const auto at = [&](int b, int) { return q[b * qb]; };
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int col = col0 + i * stride;
        if (col < W) group<VEC>(col, C, at, v[i]);
      }
      full = a.full
          + (static_cast<size_t>(j) * T + (side == 0 ? 0 : T - 1)) * W;
    }
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const int col = col0 + i * stride;
      if (col >= W) continue;
      if constexpr (VEC == 4) {
        const float4 w = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
        if (cand != nullptr) *reinterpret_cast<float4*>(cand + col) = w;
        *reinterpret_cast<float4*>(full + col) = w;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (cand != nullptr) cand[col + e] = v[i][e];
          full[col + e] = v[i][e];
        }
      }
    }
  }
}

template <int VEC, int kIlp>
cudaError_t launch(const Args& a, int W, int rows, cudaStream_t stream) {
  // fewer threads where a row is short (B = 1: one warp a row)
  const int groups = (W + VEC * kIlp - 1) / (VEC * kIlp);
  const int threads = (groups + 31) / 32 * 32;
  const dim3 block(threads < kThreads ? threads : kThreads);
  const int per_block = static_cast<int>(block.x) * VEC * kIlp;
  const dim3 grid((W + per_block - 1) / per_block,
                  rows < kMaxGridY ? rows : kMaxGridY);
  propose_kernel<VEC, kIlp><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int propose_load(int device) {
  // Loads the kernel's module outside any capture (a lazy load inside one
  // is not allowed); the caller's current device is kept.
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, propose_kernel<4, 2>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, propose_kernel<1, 4>);
  cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}

extern "C" int propose_launch(
    const float* eps, const float* sigma, const float* theta,
    const float* reuse, const float* q0, const float* qn, const float* lower,
    const float* upper, const uint8_t* limited, float* cand, float* full,
    long long th_b, long long th_n, long long th_j, long long ru_b,
    long long ru_k, long long ru_n, long long ru_j, long long q0_b,
    long long q0_j, long long qn_b, long long qn_j, int N, int d, int B,
    int K, int Kr, cudaStream_t stream) {
  const Args a{eps,  sigma, theta, reuse, q0,   qn,   lower, upper,
               limited, cand, full, th_b, th_n, th_j, ru_b, ru_k,
               ru_n, ru_j, q0_b, q0_j, qn_b, qn_j, N,    d,
               B,    K,    Kr};
  const int W = B * (1 + K + Kr);
  const int rows = N * d + 2 * d;
  if (W == 0 || rows == 0) return cudaSuccess;
  const bool aligned = reinterpret_cast<uintptr_t>(cand) % 16 == 0
      && reinterpret_cast<uintptr_t>(full) % 16 == 0;
  if (W % 4 == 0 && aligned) return launch<4, 2>(a, W, rows, stream);
  return launch<1, 4>(a, W, rows, stream);
}

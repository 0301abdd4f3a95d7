// PI²'s tail in the time-major STOMP step, for Hopper (sm_90a): from the
// per-timestep costs of the noisy candidates to the probability-weighted
// update before the smoothing matrix M, in one pass.
//
// Replaces no Pallas kernel. The JAX package computes this tail in plain
// jnp (tpustomp/engine/solver.py make_step_batch_tm, tpustomp/engine/pi2.py
// update_tm_cand), which XLA fuses. Written out in PyTorch it was the
// largest op of the MPC fleet's tick: torch.flip, torch.cumsum's scan
// (about 46 times its bytes' time at the config-5 shape) and torch.flip
// again, then amin, amax, four elementwise passes, exp, two sums over the
// rollouts, a batched GEMV over a strided slice of the candidates and the
// subtraction of theta times the probabilities' sum. Per scenario b:
//
//   S[k, t]  = S_all[b, 1 + k, t] (+ w_ctrl * ctrl_all[b, 1 + k, t]),
//              k < K (the noisy slots), t < T = N + 2;
//   cumulative: S[k, t] = sum of S[k, t'] over t' >= t (the goal endpoint
//              included), summed in double from t = T - 1 down, as
//              torch's CPU cumsum accumulates a float tensor; "local"
//              leaves S as it is;
//   for each interior t = 1..N, over the K slots: lo, hi the min and max
//              (a NaN propagates, as torch.amin / amax propagate it),
//              e_k = exp(-h_b * ((S_k - lo) / (hi - lo + 1e-8))),
//              P_k = e_k / sum(e), psum = sum(P);
//   out[n, j, b] = sum_k P[k, n + 1] * cand[n, j, b, k] - theta[n, j, b]
//              * psum[n + 1],                              n < N, j < d.
//
// Each elementwise step is rounded on its own (__fsub_rn, __fmul_rn, ...)
// in engine/pi2.py's order; the sums over k run in another order than
// torch's reductions, so the result is not bitwise the plain ops (the card
// tests hold it to a float64 evaluation, beside the plain ops' distance).
//
// What bounds it on the H100: bytes, about one multiply-add a candidate
// float read. At the config-5 shape (B 10,000, K 20, T 52, d 7) it reads
// 42 MB of S, 280 MB of candidates and 14 MB of theta and writes 14 MB
// (0.105 ms at 3.35 TB/s); at config 4 (B 1,024, K 55, T 102) about
// 186 MB (0.056 ms). A block owns nb consecutive scenarios and a run of
// waypoints, so each byte is read once:
//   1. it stages its scenarios' S columns in shared memory (8 loads in
//      flight a thread; odd row stride, so the scan's rows and the
//      columns' slots are read without bank conflicts), a tile of tt
//      columns at a time from t = T - 1 down, carrying each row's double
//      sum from tile to tile (tt = T unless a scenario's K x T floats pass
//      the block's budget: long trajectories or many rollouts take tiles,
//      the same sums in the same order);
//   2. one thread a row runs the suffix sum; `lanes` threads a column
//      (b, t), a power of two from K alone (K / lanes at most 16 slots a
//      thread: 2 at K = 20, 4 at K = 55), the min, max, exp and the two
//      sums, folded by shuffles, writing P over S in place;
//   3. each warp takes groups of 8 outputs (j, b) of one waypoint n, b
//      fastest: lane k reads cand[n, j, b, k] (a contiguous run of K floats
//      an output, neighbouring outputs on neighbouring runs, strided by
//      C = K + 1 in place: no copy of the slice; each output's offset from
//      a per-block table), multiplies by P from shared memory, and the 8
//      sums are folded over the warp in 9 shuffles (3 halving steps, then
//      2), every output by the same tree; lanes 0, 4, ..., 28 subtract
//      theta * psum (both read before the candidates) and store.
// The wrapper (kernels/pi2.py _plan) chooses nb, tt and the waypoint
// split from B, K, T, d and the card's SM count: scenarios to a block up
// to 28 KB of shared memory, and where the batch gives fewer blocks than 4
// an SM (B = 1) the waypoints split over blocks, each summing the
// cost-to-go above its run again. Every split, tile and nb gives the same
// bits. On an H100 at 700 W: 0.331 ms at config 5 (32 % of the bound;
// the plain ops 2.72 ms), 0.131 ms at config 4 (0.610), 0.015 ms at B = 1
// (0.046), from a graph of 10 calls (chip_smoke.py [pi2:*]).
//
// Plain C interface (ctypes); returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                 // outputs a warp folds at once
constexpr int kStage = 8;                 // a thread's loads in flight
constexpr float kEps = 1e-8f;             // engine/pi2.py _EPS
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 227 * 1024;      // a block's most on an H100

struct Args {
  const float* s;      // S_all [B, 1 + K, T], strides s_b, s_c, s_t
  const float* ctrl;   // ctrl_all [B, 1 + K, T] or null, strides c_*
  const float* cand;   // the noisy slots [N, d, B, K], strides k_*
  const float* theta;  // [N, d, B], strides t_*
  const float* h;      // [B], stride h_b (0: one value for every row)
  float* out;          // [N, d, B], contiguous
  long long s_b, s_c, s_t, c_b, c_c, c_t;
  long long k_n, k_j, k_b, k_k, t_n, t_j, t_b, h_b;
  float w_ctrl;
  int B, K, T, d;
  int nb;       // scenarios a block
  int tt;       // S columns a tile
  int n_split;  // waypoints a block (blockIdx.y takes the run)
  int lanes;    // threads a column of P (a power of two, at most 32)
};

// torch.amin / amax of a column: a NaN anywhere makes the result NaN
__device__ __forceinline__ float nan_min(float m, float x) {
  return (isnan(m) || m <= x) ? m : x;
}

__device__ __forceinline__ float nan_max(float m, float x) {
  return (isnan(m) || m >= x) ? m : x;
}

// One halving step of the warp fold: lanes with `off` set keep the upper
// half of acc, the others the lower half, each adding its partner's copy
template <int kHalf>
__device__ __forceinline__ void fold(float* acc, int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? acc[i] : acc[i + kHalf];
    const float keep = upper ? acc[i + kHalf] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// q = j * nb + b for b < nb: (j, b) by a float reciprocal and one
// correction, exact for q < 2^22 (every index here is below a block's
// shared memory in floats)
__device__ __forceinline__ void split(int q, int nb, float inv_nb, int& j,
                                      int& b) {
  j = static_cast<int>((static_cast<float>(q) + 0.5f) * inv_nb);
  b = q - j * nb;
  if (b < 0) {
    --j;
    b += nb;
  } else if (b >= nb) {
    ++j;
    b -= nb;
  }
}

template <bool kCumulative>
__global__ void __launch_bounds__(kThreads, 4) pi2_kernel(const Args a) {
  extern __shared__ double smem[];
  const int K = a.K, T = a.T, N = T - 2, d = a.d;
  const int ts = a.tt | 1;                  // odd row stride of the stage
  const int b0 = blockIdx.x * a.nb;
  const int nb = min(a.nb, a.B - b0);
  const int n_lo = blockIdx.y * a.n_split;
  const int n_hi = min(N, n_lo + a.n_split);     // waypoints [n_lo, n_hi)
  if (n_lo >= n_hi) return;                       // uniform in the block
  double* carry = smem;                           // [nb * K]
  long long* qoff = reinterpret_cast<long long*>(carry + a.nb * K);
  float* s = reinterpret_cast<float*>(qoff + a.nb * d);   // [nb * K][ts]
  float* psum = s + a.nb * K * ts;                // [nb][tt]
  int* qp = reinterpret_cast<int*>(psum + a.nb * a.tt);  // [nb * d]
  const int rows = nb * K;
  const int per_col = d * nb;           // a waypoint's outputs (j, b)
  const float inv_k = 1.0f / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kCumulative) {
    for (int r = threadIdx.x; r < rows; r += kThreads) carry[r] = 0.0;
  }
  // output q = j * nb + b of any waypoint: its candidates' offset from the
  // waypoint's, and its probabilities' row in the stage
  for (int q = threadIdx.x; q < per_col; q += kThreads) {
    const int j = q / nb;
    const int b = q - j * nb;
    qoff[q] = j * a.k_j + (b0 + b) * a.k_b;
    qp[q] = b * K * ts;
  }
  // the block's interior timesteps t = n + 1 lie in [n_lo + 1, n_hi]; the
  // cost-to-go there sums every column from T - 1 down
  const int t_stop = n_lo + 1;
  const int t_top = kCumulative ? T : n_hi + 1;
  for (int t1 = t_top; t1 > t_stop; t1 -= a.tt) {
    const int t0 = max(t1 - a.tt, t_stop);
    const int cols = t1 - t0;
    __syncthreads();                  // the last tile is no longer read
    // 1. stage S (and the weighted control cost) of columns [t0, t1):
    //    consecutive threads on consecutive columns of a row, 8 loads in
    //    flight a thread
    const int total = rows * cols;
    const float inv_cols = 1.0f / cols;
    for (int i0 = threadIdx.x; i0 < total; i0 += kStage * kThreads) {
      float v[kStage];
      int at[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = min(i0 + u * kThreads, total - 1);
        int r, c, b, k;
        split(i, cols, inv_cols, r, c);
        split(r, K, inv_k, b, k);
        const long long bb = b0 + b;
        const long long t = t0 + c;
        v[u] = a.s[bb * a.s_b + (k + 1) * a.s_c + t * a.s_t];
        if (a.ctrl != nullptr) {
          v[u] = __fadd_rn(v[u], __fmul_rn(a.w_ctrl, a.ctrl[
              bb * a.c_b + (k + 1) * a.c_c + t * a.c_t]));
        }
        at[u] = r * ts + c;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        if (i0 + u * kThreads < total) s[at[u]] = v[u];
      }
    }
    __syncthreads();
    // 2. the cost-to-go: each row's suffix sum, in double, from the right
    if (kCumulative) {
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        double acc = carry[r];
        float* row = s + r * ts;
#pragma unroll 4
        for (int c = cols - 1; c >= 0; --c) {
          acc += static_cast<double>(row[c]);
          row[c] = static_cast<float>(acc);
        }
        carry[r] = acc;
      }
      __syncthreads();
    }
    // the tile's columns inside the block's run (none in a tile above it)
    const int tb = min(t1, n_hi + 1);
    if (t0 >= tb) continue;
    const int ncols = tb - t0;
    // 3. P over S in place, `lanes` threads a column (b, t): each takes
    //    the slots k = l, l + lanes, ..., then the column's threads fold
    //    by shuffles (lanes from K alone: the same tree for every plan)
    const int L = a.lanes, li = threadIdx.x & (L - 1), head = lane & ~(L - 1);
    for (int i0 = 0; i0 < nb * ncols; i0 += kThreads / L) {
      const int i = i0 + threadIdx.x / L;
      const bool on = i < nb * ncols;       // every thread runs the folds
      const int b = on ? i / ncols : 0;
      const int c = on ? i - b * ncols : 0;
      float* col = s + b * K * ts + c;
      const int kn = on ? K : 0;
      float lo = INFINITY, hi = -INFINITY;
      for (int k = li; k < kn; k += L) {
        const float x = col[k * ts];
        lo = nan_min(lo, x);
        hi = nan_max(hi, x);
      }
      for (int off = L >> 1; off >= 1; off >>= 1) {
        lo = nan_min(lo, __shfl_xor_sync(kFull, lo, off));
        hi = nan_max(hi, __shfl_xor_sync(kFull, hi, off));
      }
      // one value for the column's threads (min and max of a +0 and a -0
      // may differ by the order of their operands)
      lo = __shfl_sync(kFull, lo, head);
      hi = __shfl_sync(kFull, hi, head);
      const float den = __fadd_rn(__fsub_rn(hi, lo), kEps);
      const float nh = on ? -a.h[static_cast<long long>(b0 + b) * a.h_b]
                          : 0.0f;
      float sum = 0.0f;
      for (int k = li; k < kn; k += L) {
        const float e = expf(
            __fmul_rn(nh, __fdiv_rn(__fsub_rn(col[k * ts], lo), den)));
        col[k * ts] = e;
        sum = __fadd_rn(sum, e);
      }
      for (int off = L >> 1; off >= 1; off >>= 1) {
        sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
      }
      float ps = 0.0f;
      for (int k = li; k < kn; k += L) {
        const float p = __fdiv_rn(col[k * ts], sum);
        col[k * ts] = p;
        ps = __fadd_rn(ps, p);
      }
      for (int off = L >> 1; off >= 1; off >>= 1) {
        ps = __fadd_rn(ps, __shfl_xor_sync(kFull, ps, off));
      }
      if (on && li == 0) psum[b * a.tt + c] = ps;
    }
    __syncthreads();
    // 4. the probability-weighted candidates of waypoints n = t - 1: the
    //    outputs of a waypoint, q = j * nb + b (b fastest), in groups of 8
    const int groups = (per_col + kGroup - 1) / kGroup;
    const float inv_nb = 1.0f / nb;
    // the output this lane stores after the fold (lanes 0, 4, ..., 28)
    const int mine = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2
        + ((lane >> 2) & 1);
    for (int q0 = warp; q0 < ncols * groups; q0 += kWarps) {
      const int c = q0 / groups;
      const int g = q0 - c * groups;
      const long long n = t0 + c - 1;
      const float* col = a.cand + n * a.k_n;
      // θ and the probabilities' sum of the stored output, read before
      // the candidates so that their latency overlaps
      int mj = 0, mb = 0;
      float th = 0.0f, ps = 0.0f;
      const bool writer = (lane & 3) == 0 && g * kGroup + mine < per_col;
      if (writer) {
        split(g * kGroup + mine, nb, inv_nb, mj, mb);
        th = a.theta[n * a.t_n + mj * a.t_j + (b0 + mb) * a.t_b];
        ps = psum[mb * a.tt + c];
      }
      float acc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) acc[u] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        const long long koff = k * a.k_k;
        const int kp = k * ts + c;
        float x[kGroup], p[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int q = g * kGroup + u;
          x[u] = 0.0f;
          p[u] = 0.0f;
          if (q < per_col && k < K) {
            x[u] = __ldg(col + qoff[q] + koff);
            p[u] = s[qp[q] + kp];
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) acc[u] = fmaf(p[u], x[u], acc[u]);
      }
      fold<4>(acc, lane, 16);
      fold<2>(acc, lane, 8);
      fold<1>(acc, lane, 4);
      acc[0] += __shfl_xor_sync(kFull, acc[0], 2);
      acc[0] += __shfl_xor_sync(kFull, acc[0], 1);
      if (writer) {
        a.out[(n * d + mj) * a.B + b0 + mb] =
            __fsub_rn(acc[0], __fmul_rn(th, ps));
      }
    }
  }
}

size_t smem_bytes(int nb, int K, int tt, int d) {
  return static_cast<size_t>(nb)
      * (8u * K + 4u * static_cast<size_t>(K) * (tt | 1) + 4u * tt
         + 12u * d);
}

}  // namespace

extern "C" int pi2_load(int device) {
  // Loads the kernels' module outside any capture (a lazy load inside one
  // is not allowed) and lets them take the card's most shared memory (the
  // plan asks above 48 KB only for a scenario whose K rows of 8 bytes and
  // one column do not fit 28 KB); the caller's current device is kept.
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pi2_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(pi2_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  }
  cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}

extern "C" int pi2_launch(
    const float* s, const float* ctrl, const float* cand, const float* theta,
    const float* h, float* out, long long s_b, long long s_c, long long s_t,
    long long c_b, long long c_c, long long c_t, long long k_n,
    long long k_j, long long k_b, long long k_k, long long t_n,
    long long t_j, long long t_b, long long h_b, float w_ctrl,
    int cumulative, int B, int K, int T, int d, int nb, int tt, int n_split,
    int splits, int lanes, cudaStream_t stream) {
  if (B == 0 || T < 3 || d == 0) return cudaSuccess;
  const Args a{s,   ctrl, cand, theta, h,   out, s_b, s_c, s_t,
               c_b, c_c,  c_t,  k_n,   k_j, k_b, k_k, t_n, t_j,
               t_b, h_b,  w_ctrl, B,   K,   T,   d,   nb,  tt,
               n_split, lanes};
  const size_t smem = smem_bytes(nb, K, tt, d);
  if (smem > static_cast<size_t>(kSmemMax) || lanes < 1 || lanes > 32
      || (lanes & (lanes - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((B + nb - 1) / nb, splits);
  if (cumulative) {
    pi2_kernel<true><<<grid, kThreads, smem, stream>>>(a);
  } else {
    pi2_kernel<false><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// Shared skeleton of the fused rollout evaluators for Hopper (sm_90a):
// rollout_analytic.cu (sphere/box worlds) and rollout_grid.cu (voxel grid,
// optionally with a sphere/box overlay). Both are this one template,
// evaluate<World>, with a different distance policy.
//
// Per candidate trajectory c and waypoint t it computes forward kinematics
// down the joint chain, the world position of every sphere body, the signed
// distance of each body's center under the World policy, the CHOMP
// potential of (dist - radius - clearance) times the body's workspace speed
// (central difference over t, one-sided at both ends), and writes
//     q_obs[t, c]            = dt * sum_b potential_b(t) * speed_b(t)
//     margin_part[chunk, c]  = min over b and this chunk's t of dist_b - radius_b
// Numerics follow tpustomp_torch/costs/obstacle.py (the plain version the
// kernels are held to): accurate sincosf/sqrtf and IEEE division (no fast
// math); nvcc's default FMA contraction moves results by about 1 ULP per
// composed joint.
//
// Layout and work split (what each kernel's header says bounds it is its
// own):
//   * One thread walks one candidate over a chunk of waypoints. Its frame
//     (R, p) lives in registers; each link's bodies are placed while the
//     frame is live.
//   * The time coupling (speed at t needs positions at t-1 and t+1) is a
//     3-slot sliding window of body positions in shared memory, laid out
//     [slot][body][xyz][thread] so a warp's accesses are bank-conflict free.
//   * The waypoint axis is cut into chunks (grid.y) so small batches still
//     fill the 132 SMs; each chunk recomputes the FK of its 1-waypoint halo
//     on either side. Per-chunk margins are min-reduced by the wrapper.
//   * Inputs are time-major [d, T, C] and cost rows [T, C]: consecutive
//     threads touch consecutive candidates, so loads and stores coalesce.
//   * Robot and world parameters (a few hundred floats) are staged once per
//     block in shared memory and read as warp-uniform broadcasts.
//   * Per-row worlds (one set of spheres/boxes per scenario, batched MPC)
//     cannot be staged that way: their primitives stay in global memory as
//     [rows, ns, 4] and [rows, nx, 6], and candidate c reads row
//     c / cands_per_row through the read-only path (RowPrims below). The
//     same primitives_dist does the arithmetic for both.
//   * Inactive rows (finished scenarios) write zeros and skip all work.
// Joint type and axis are read at run time; bodies must be link-sorted (the
// wrapper sorts robots that are not, on the device).
//
// Packed parameter layout (float32; built by kernels/rollout.py:pack_params):
//   [0, 9)            base rotation, row-major
//   [9, 12)           base position
//   12 + 16*j + ...   joint j: type (0 revolute, 1 prismatic), axis[3],
//                     offset[3], fixed rotation[9] row-major
//   PB = 12 + 16*d    body_start[d+1]: bodies of joint j are
//                     [body_start[j], body_start[j+1]) (link-sorted)
//   PB + d + 1 + 4*b  body b: offset[3], radius
//   W = PB + d + 1 + 4*nb: the world section, read by the World policy:
//     4 per sphere (center[3], radius), then 6 per box (center[3], half[3]),
//     then for grid worlds the grid origin[3] and resolution. A per-row
//     world holds no primitives here (ns = nx = 0 in this section).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rollout {

constexpr int kBlock = 64;          // threads (candidates) per block
constexpr float kBig = 1e6f;        // empty-set distance, as the reference

__device__ __forceinline__ void place_bodies(
    const float* P, int b_lo, int b_hi, int body_base, const float R[9],
    const float p[3], float* win_slot) {
  // win_slot points at [slot][0][0][tid]; stride between scalars is kBlock
  for (int b = b_lo; b < b_hi; ++b) {
    const float* B = P + body_base + 4 * b;
    const float o0 = B[0], o1 = B[1], o2 = B[2];
    float* w = win_slot + (b * 3) * kBlock;
    w[0] = p[0] + R[0] * o0 + R[1] * o1 + R[2] * o2;
    w[kBlock] = p[1] + R[3] * o0 + R[4] * o1 + R[5] * o2;
    w[2 * kBlock] = p[2] + R[6] * o0 + R[7] * o1 + R[8] * o2;
  }
}

// Forward kinematics of candidate c at waypoint t; writes every body's
// world position into the window slot.
__device__ __forceinline__ void fk_bodies(
    const float* P, const float* __restrict__ cand, int c, int t, int C,
    int T, int d, int skip_rotf, float* win_slot) {
  float R[9], p[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = P[k];
  p[0] = P[9]; p[1] = P[10]; p[2] = P[11];
  const int body_start = 12 + 16 * d;
  const int body_base = body_start + d + 1;
  for (int j = 0; j < d; ++j) {
    const float* J = P + 12 + 16 * j;
    const float o0 = J[4], o1 = J[5], o2 = J[6];
    p[0] = p[0] + R[0] * o0 + R[1] * o1 + R[2] * o2;
    p[1] = p[1] + R[3] * o0 + R[4] * o1 + R[5] * o2;
    p[2] = p[2] + R[6] * o0 + R[7] * o1 + R[8] * o2;
    if (!skip_rotf) {
      float Rn[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          Rn[3 * i + k] = R[3 * i] * J[7 + k] + R[3 * i + 1] * J[10 + k]
                          + R[3 * i + 2] * J[13 + k];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
    const float x = J[1], y = J[2], z = J[3];
    const float q = cand[((size_t)j * T + t) * C + c];
    if (J[0] != 0.0f) {
      // prismatic: translate along the world-frame axis, rotation unchanged
      const float aw0 = R[0] * x + R[1] * y + R[2] * z;
      const float aw1 = R[3] * x + R[4] * y + R[5] * z;
      const float aw2 = R[6] * x + R[7] * y + R[8] * z;
      p[0] = p[0] + aw0 * q;
      p[1] = p[1] + aw1 * q;
      p[2] = p[2] + aw2 * q;
    } else {
      // revolute: R <- R @ rodrigues(axis, q)
      float s, co;
      sincosf(q, &s, &co);
      const float oc = 1.0f - co;
      const float G[9] = {co + x * x * oc,     x * y * oc - z * s, x * z * oc + y * s,
                          y * x * oc + z * s,  co + y * y * oc,    y * z * oc - x * s,
                          z * x * oc - y * s,  z * y * oc + x * s, co + z * z * oc};
      float Rn[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          Rn[3 * i + k] = R[3 * i] * G[k] + R[3 * i + 1] * G[3 + k]
                          + R[3 * i + 2] * G[6 + k];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
    place_bodies(P, (int)P[body_start + j], (int)P[body_start + j + 1],
                 body_base, R, p, win_slot);
  }
}

struct SharedLoad {
  __device__ __forceinline__ float operator()(const float* p) const {
    return *p;
  }
};
struct ReadOnlyLoad {   // global memory through the read-only (L1) path
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldg(p);
  }
};

// Min signed distance to ns spheres (S: 4 floats each, center[3] and
// radius) and nx boxes (X: 6 floats each, center[3] and half[3]); kBig
// when there are none. Load says how S and X are read; the arithmetic is
// the same for shared and per-row worlds.
template <class Load>
__device__ __forceinline__ float primitives_dist(
    Load ld, const float* S, int ns, const float* X, int nx, float x0,
    float x1, float x2) {
  float dist = kBig;
  for (int s = 0; s < ns; ++s) {
    const float* P = S + 4 * s;
    const float r0 = x0 - ld(P), r1 = x1 - ld(P + 1), r2 = x2 - ld(P + 2);
    dist = fminf(dist, sqrtf(r0 * r0 + r1 * r1 + r2 * r2) - ld(P + 3));
  }
  for (int k = 0; k < nx; ++k) {
    const float* B = X + 6 * k;
    const float q0 = fabsf(x0 - ld(B)) - ld(B + 3);
    const float q1 = fabsf(x1 - ld(B + 1)) - ld(B + 4);
    const float q2 = fabsf(x2 - ld(B + 2)) - ld(B + 5);
    const float w0 = fmaxf(q0, 0.0f), w1 = fmaxf(q1, 0.0f),
                w2 = fmaxf(q2, 0.0f);
    const float outside = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
    const float inside = fminf(fmaxf(fmaxf(q0, q1), q2), 0.0f);
    dist = fminf(dist, outside + inside);
  }
  return dist;
}

// One thread's view of a primitive set: a callable distance.
template <class Load>
struct Prims {
  const float* S;
  int ns;
  const float* X;
  int nx;
  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    return primitives_dist(Load{}, S, ns, X, nx, x0, x1, x2);
  }
};

// The shared primitive set in the world section W of the staged parameters.
__device__ __forceinline__ Prims<SharedLoad> shared_prims(const float* W,
                                                          int ns, int nx) {
  return Prims<SharedLoad>{W, ns, W + 4 * ns, nx};
}

// Per-row primitive sets in global memory: spheres [rows, ns, 4], boxes
// [rows, nx, 6]; candidate c reads row c / per_row.
struct RowPrims {
  const float* spheres;
  const float* boxes;
  int ns, nx, per_row;
  __device__ __forceinline__ Prims<ReadOnlyLoad> at(int c) const {
    const size_t r = (size_t)(c / per_row);
    return Prims<ReadOnlyLoad>{spheres + r * 4 * ns, ns, boxes + r * 6 * nx,
                               nx};
  }
};

// The kernel body. World is a policy with
//   __device__ Dist at(const float* W, int c) const
// binding candidate c's distance once per thread: Dist is callable as
// dist(x0, x1, x2), the signed distance at a body center (W: the world
// section of the shared-memory parameters).
template <class World>
__device__ __forceinline__ void evaluate(
    const World& world, const float* __restrict__ cand,   // [d, T, C]
    const float* __restrict__ params, int n_params,
    const uint8_t* __restrict__ active,                   // [C] or nullptr
    float* __restrict__ q_obs,                            // [T, C]
    float* __restrict__ margin_part,                      // [n_chunks, C]
    int C, int T, int d, int nb, float dt, float clearance, int skip_rotf,
    int t_chunk) {
  extern __shared__ float smem[];
  float* P = smem;
  const int n_params_pad = (n_params + 31) & ~31;
  float* win = smem + n_params_pad;          // [3][nb][3][kBlock]
  for (int i = threadIdx.x; i < n_params; i += kBlock) P[i] = params[i];
  __syncthreads();

  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= C) return;                        // ragged edge: masked, not padded
  const int chunk = blockIdx.y;
  const int t0 = chunk * t_chunk;
  const int t1 = min(T, t0 + t_chunk);
  if (active != nullptr && !active[c]) {
    for (int t = t0; t < t1; ++t) q_obs[(size_t)t * C + c] = 0.0f;
    margin_part[(size_t)chunk * C + c] = 0.0f;
    return;
  }

  const int body_base = 12 + 17 * d + 1;
  const float* W = P + body_base + 4 * nb;
  const auto dist_at = world.at(W, c);
  const int slot_stride = nb * 3 * kBlock;
  float* my_win = win + threadIdx.x;
  const float inv_dt = 1.0f / dt;
  const float inv_2dt = 1.0f / (2.0f * dt);

  float margin = kBig;
  int have = (t0 > 0 ? t0 - 1 : 0) - 1;      // last waypoint placed so far
  for (int t = t0; t < t1; ++t) {
    const int need = min(t + 1, T - 1);
    while (have < need) {
      ++have;
      fk_bodies(P, cand, c, have, C, T, d, skip_rotf,
                my_win + (have % 3) * slot_stride);
    }
    const float* cur = my_win + (t % 3) * slot_stride;
    const float* prv = my_win + ((t + 2) % 3) * slot_stride;  // t - 1
    const float* nxt = my_win + ((t + 1) % 3) * slot_stride;  // t + 1
    float acc = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const int o = b * 3 * kBlock;
      const float x0 = cur[o], x1 = cur[o + kBlock], x2 = cur[o + 2 * kBlock];
      float v0, v1, v2;
      if (t == 0) {
        v0 = (nxt[o] - x0) * inv_dt;
        v1 = (nxt[o + kBlock] - x1) * inv_dt;
        v2 = (nxt[o + 2 * kBlock] - x2) * inv_dt;
      } else if (t == T - 1) {
        v0 = (x0 - prv[o]) * inv_dt;
        v1 = (x1 - prv[o + kBlock]) * inv_dt;
        v2 = (x2 - prv[o + 2 * kBlock]) * inv_dt;
      } else {
        v0 = (nxt[o] - prv[o]) * inv_2dt;
        v1 = (nxt[o + kBlock] - prv[o + kBlock]) * inv_2dt;
        v2 = (nxt[o + 2 * kBlock] - prv[o + 2 * kBlock]) * inv_2dt;
      }
      const float speed = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
      const float dist = dist_at(x0, x1, x2);
      const float radius = P[body_base + 4 * b + 3];
      const float d_sig = dist - radius - clearance;
      float pot;
      if (d_sig < 0.0f) {
        pot = -d_sig + 0.5f * clearance;
      } else if (d_sig <= clearance) {
        const float e = d_sig - clearance;
        pot = e * e / (2.0f * clearance);
      } else {
        pot = 0.0f;
      }
      acc += pot * speed;
      margin = fminf(margin, dist - radius);
    }
    q_obs[(size_t)t * C + c] = acc * dt;
  }
  margin_part[(size_t)chunk * C + c] = margin;
}

// Dynamic shared memory of one block: the padded parameters plus the
// window. Above 48 KB the kernel must opt in (cudaFuncSetAttribute).
inline size_t smem_bytes(int n_params, int nb) {
  return (size_t)(((n_params + 31) & ~31) + 3 * nb * 3 * kBlock)
         * sizeof(float);
}

template <class Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace rollout

// Shared skeleton of the fused rollout evaluators for Hopper (sm_90a):
// rollout_analytic.cu (sphere/box worlds) and rollout_grid.cu (voxel grid,
// optionally with a sphere/box overlay). Both are this one template,
// evaluate<World, Chain>, with a different distance policy; the Chain
// policy walks the robot's joints (see "Joint chains" below).
//
// Per candidate trajectory c and waypoint t it computes forward kinematics
// down the joint chain, the world position of every sphere body, the signed
// distance of each body's center under the World policy, the CHOMP
// potential of (dist - radius - clearance) times the body's workspace speed
// (central difference over t, one-sided at both ends), and writes
//     q_obs[t, c]            = dt * sum_b potential_b(t) * speed_b(t)
//     margin_part[seg, c]    = min over b and this segment's t of dist_b - radius_b
// and, when the caller passes an ee buffer (the TPU kernel's ee_out), the
// last joint's frame per waypoint, 12 planes of [T, C]:
//     ee[k, t, c]  k = 0..2 position, k = 3..11 rotation (row-major)
// Numerics follow tpustomp_torch/costs/obstacle.py (the plain version the
// kernels are held to): accurate sincosf/sqrtf and IEEE division (no fast
// math); nvcc's default FMA contraction moves results by about 1 ULP per
// composed joint.
//
// Work split. Each (candidate, waypoint) is a serial chain of d frame
// products and nb distances, so the card is kept busy by many resident
// warps, and what limits residency is registers, not shared memory:
//   * One warp walks one candidate along the waypoint axis. The axis is cut
//     into segments of seg_len <= kSegMax owned waypoints (the wrapper's
//     segment plan, grid.y). Lane l computes the FK of waypoint
//     t0 - 1 + l: lanes 1..seg_len own their waypoint, lane 0 and lane
//     seg_len + 1 are the 1-waypoint halo on either side (their FK is
//     recomputed by the neighbouring segment). Lanes past the halo repeat
//     its last waypoint and write nothing.
//   * Bodies are placed one at a time while the frame is live; the
//     neighbours' positions at t - 1 and t + 1 come from the adjacent lanes
//     (__shfl_up_sync / __shfl_down_sync). Speed, distance, potential and
//     the sum over bodies (b = 0..nb-1, as the plain version) stay in the
//     owning lane. The segment's margin is a warp min-reduction.
//   * A block is kCands warps: kCands candidates (32 bytes per joint and
//     waypoint) by one segment. The [d, T, C] tile comes into shared memory
//     with coalesced loads and is read transposed (row pitch kPitch: no bank
//     conflicts); q_obs, ee and margins go out through the same kind of
//     staging, so every 32-byte sector is read and written whole.
//   * Robot parameters (a few hundred floats) are staged once per block in
//     shared memory and read as warp-uniform broadcasts.
//   * A warp's candidate has one world. A world whose spheres and boxes
//     fit the kernel's register budget (with_register_counts; each kernel
//     file sets its budget in floats) runs with its counts compiled in and
//     its primitives in registers, loaded once per warp as warp-uniform
//     broadcasts: from the
//     staged parameters for a shared world, from the row c / cands_per_row
//     of [rows, ns, 4] / [rows, nx, 6] for per-row worlds. A larger world
//     reads them through the same pointers at every use. Shared and
//     per-row worlds of the same counts take the same instantiation and run
//     the same code (primitives_dist), so they agree bit for bit.
//   * A warp whose candidate is inactive (a finished scenario) writes zeros
//     and does no other work; no lane waits on another candidate.
//   * ee is the (R, p) in registers after the joint loop, before ee_offset
//     (the position constraint applies it): 48 bytes of stores per
//     (candidate, waypoint) and no arithmetic, so q_obs and margin are the
//     same with or without it.
// Bodies must be link-sorted (the wrapper sorts robots that are not, on the
// device).
//
// Joint chains (the TPU kernel's static_joints, rollout_pallas.py:372-391,
// 536-571). A library built without ROLLOUT_CHAIN runs RuntimeChain: joint
// type and axis read from the parameters at run time, a branch per joint,
// loops to the run-time d and body_start. A library built with
// -DROLLOUT_CHAIN=chain_<skip_rotf>_<type>_<ax>_<ay>_<az>_<n_bodies>_...
// (five codes a joint, -1 spelled n1; kernels/rollout.py chain_of and
// _nvcc_flags) runs that robot's StaticChain: the joint and
// body loops unrolled, each joint's type resolved, and each axis component
// coded 0, +1, -1 or kOther and folded as the reference's _cmul/_csum fold
// it (a prismatic joint skips sincosf and translates along the live
// components only; a revolute joint builds only the live entries of G and
// multiplies R·G over them; a kOther value is read from the parameters).
// Offsets, fixed rotations and bodies stay run-time values in both.
//
// Packed parameter layout (float32; built by kernels/rollout.py:pack_params):
//   [0, 9)            base rotation, row-major
//   [9, 12)           base position
//   12 + 16*j + ...   joint j: type (0 revolute, 1 prismatic), axis[3],
//                     offset[3], fixed rotation[9] row-major
//   PB = 12 + 16*d    body_start[d+1]: bodies of joint j are
//                     [body_start[j], body_start[j+1]) (link-sorted; the
//                     static chain has them compiled in)
//   PB + d + 1 + 4*b  body b: offset[3], radius
//   W = PB + d + 1 + 4*nb: the world section, read by the World policy:
//     4 per sphere (center[3], radius), then 6 per box (center[3], half[3]),
//     then for grid worlds the grid origin[3] and resolution. A per-row
//     world holds no primitives here (ns = nx = 0 in this section).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace rollout {

constexpr int kWarp = 32;              // lanes: one waypoint each
constexpr int kCands = 8;              // candidates per block, one warp each
constexpr int kBlock = kWarp * kCands;
constexpr int kPitch = kCands + 1;     // staging row pitch (odd: no conflicts)
constexpr int kSegMax = kWarp - 2;     // owned waypoints: a halo lane each side
constexpr int kAny = -1;               // a primitive count known at run time
constexpr float kBig = 1e6f;           // empty-set distance, as the reference
constexpr unsigned kFull = 0xffffffffu;

struct Deref {                         // registers or shared memory
  __device__ __forceinline__ float operator()(const float* p) const {
    return *p;
  }
};
struct ReadOnly {                      // global memory through the L1 path
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldg(p);
  }
};

// Min signed distance to ns spheres (S: 4 floats each, center[3] and
// radius) and nx boxes (X: 6 floats each, center[3] and half[3]); kBig
// when there are none. NS and NX are the counts at compile time (the loops
// unroll, so S and X may be register arrays) or kAny (the run-time ns, nx);
// Load says how S and X are read. The arithmetic is the same for every
// instantiation and every kind of world.
template <int NS, int NX, class Load>
__device__ __forceinline__ float primitives_dist(
    Load ld, const float* S, int ns, const float* X, int nx, float x0,
    float x1, float x2) {
  if (NS != kAny) ns = NS;
  if (NX != kAny) nx = NX;
  float dist = kBig;
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    const float* P = S + 4 * s;
    const float r0 = x0 - ld(P), r1 = x1 - ld(P + 1), r2 = x2 - ld(P + 2);
    dist = fminf(dist, sqrtf(r0 * r0 + r1 * r1 + r2 * r2) - ld(P + 3));
  }
#pragma unroll
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

// One warp's primitive set, a callable distance. Counts known at compile
// time: the primitives are copied into registers once, through Load.
template <int NS, int NX, class Load>
struct Prims {
  float s[NS > 0 ? 4 * NS : 1], x[NX > 0 ? 6 * NX : 1];
  __device__ __forceinline__ Prims(const float* S, int, const float* X,
                                   int) {
    const Load ld{};
#pragma unroll
    for (int i = 0; i < 4 * NS; ++i) s[i] = ld(S + i);
#pragma unroll
    for (int i = 0; i < 6 * NX; ++i) x[i] = ld(X + i);
  }
  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    return primitives_dist<NS, NX>(Deref{}, s, NS, x, NX, x0, x1, x2);
  }
};

// A world above the register budget: read through Load at every use.
template <class Load>
struct Prims<kAny, kAny, Load> {
  const float* S;
  int ns;
  const float* X;
  int nx;
  __device__ __forceinline__ Prims(const float* S_, int ns_, const float* X_,
                                   int nx_)
      : S(S_), ns(ns_), X(X_), nx(nx_) {}
  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    return primitives_dist<kAny, kAny>(Load{}, S, ns, X, nx, x0, x1, x2);
  }
};

// The shared primitive set in the world section W of the staged parameters.
template <int NS, int NX>
struct SharedPrims {
  int ns, nx;
  __device__ __forceinline__ Prims<NS, NX, Deref> at(const float* W,
                                                     int) const {
    return Prims<NS, NX, Deref>(W, ns, W + 4 * ns, nx);
  }
};

// Per-row primitive sets in global memory: spheres [rows, ns, 4], boxes
// [rows, nx, 6]; candidate c reads row c / per_row.
template <int NS, int NX>
struct RowPrims {
  const float* spheres;
  const float* boxes;
  int ns, nx, per_row;
  __device__ __forceinline__ Prims<NS, NX, ReadOnly> at(const float*,
                                                        int c) const {
    const size_t r = (size_t)(c / per_row);
    return Prims<NS, NX, ReadOnly>(spheres + r * 4 * ns, ns,
                                   boxes + r * 6 * nx, nx);
  }
};

template <int NS, int NX>
struct Counts {
  static constexpr int ns = NS, nx = NX;
};

// launch(Counts<ns, nx>{}), the world's own counts compiled in, when its
// primitives fit in Floats registers (4 a sphere, 6 a box): one
// instantiation per such pair of counts (S, X walk them).
// launch(Counts<kAny, kAny>{}) for a larger world. Shared and per-row
// worlds take the same instantiation.
template <int Floats, int S = 0, int X = 0, class F>
inline int with_register_counts(int ns, int nx, F launch) {
  if constexpr (4 * S + 6 * X <= Floats) {
    if (ns == S && nx == X) return launch(Counts<S, X>{});
    return with_register_counts<Floats, S, X + 1>(ns, nx, launch);
  } else if constexpr (X > 0) {
    return with_register_counts<Floats, S + 1, 0>(ns, nx, launch);
  } else {
    return launch(Counts<kAny, kAny>{});
  }
}

// Shared memory of one block, in floats: the padded parameters, the joint
// tile [d][kWarp][kPitch], the cost rows [kWarp][kPitch], kWarp margin
// slots, and with ee the frame [12][kWarp][kPitch].
inline size_t smem_floats(int n_params, int d, bool ee) {
  return (size_t)((n_params + 31) & ~31) + (size_t)(d + 1) * kWarp * kPitch
         + kWarp + (ee ? 12 * kWarp * kPitch : 0);
}

// ---- Joint chains -----------------------------------------------------------
// A chain's walk(P, q_of, R, p, body) runs the FK of one waypoint from the
// base frame (R, p): for each joint j it moves the frame to the joint's
// origin, applies the joint's motion at q_of[j * kWarp * kPitch], then calls
// body(b) for each body b on that joint with the frame live. It has d, nb
// and skip_rotf (every fixed rotation is the identity: R·RotFixed skipped).

// p += R · offset, then R = R · RotFixed unless skip_rotf; J: joint j's
// parameters.
__device__ __forceinline__ void joint_origin(const float* J, bool skip_rotf,
                                             float (&R)[9], float (&p)[3]) {
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
}

// Joint type and axis read at run time (robots without a static chain, and
// robots with body_counts=None, which the wrapper sorts on the device).
struct RuntimeChain {
  int d, nb, skip_rotf;

  template <class Body>
  __device__ __forceinline__ void walk(const float* P, const float* q_of,
                                       float (&R)[9], float (&p)[3],
                                       Body& body) const {
    const int body_start = 12 + 16 * d;
    for (int j = 0; j < d; ++j) {
      const float* J = P + 12 + 16 * j;
      joint_origin(J, skip_rotf, R, p);
      const float x = J[1], y = J[2], z = J[3];
      const float q = q_of[j * kWarp * kPitch];
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
      const int b_hi = (int)P[body_start + j + 1];
      for (int b = (int)P[body_start + j]; b < b_hi; ++b) body(b);
    }
  }
};

// The code of an axis component, or of a product of two, in a static chain:
// exactly 0, +1 or -1, or kOther (a value read from the parameters at run
// time, as the TPU kernel multiplies its Python float).
constexpr int kOther = 2;
__host__ __device__ constexpr int code_mul(int a, int b) {
  return (a == 0 || b == 0) ? 0
         : (a == kOther || b == kOther) ? kOther : a * b;
}
__host__ __device__ constexpr int code_neg(int a) {
  return a == kOther ? kOther : -a;
}

// k·e with k folded by its code K (the reference's _cmul): e, -e or k·e.
template <int K>
__device__ __forceinline__ float cmul(float k, float e) {
  static_assert(K == 1 || K == -1 || K == kOther, "a zero term is dropped");
  if constexpr (K == 1) return e;
  else if constexpr (K == -1) return -e;
  else return k * e;
}

// The sum, left to right, of the terms k_i·e_i whose code K_i is not 0 (the
// reference's _csum); at least one term is live.
template <int K0, int K1, int K2 = 0>
__device__ __forceinline__ float csum(float k0, float e0, float k1, float e1,
                                      float k2 = 0.0f, float e2 = 0.0f) {
  static_assert(K0 != 0 || K1 != 0 || K2 != 0, "an empty sum is folded out");
  float s = 0.0f;
  if constexpr (K0 != 0) s = cmul<K0>(k0, e0);
  if constexpr (K1 != 0) {
    if constexpr (K0 != 0) s = s + cmul<K1>(k1, e1);
    else s = cmul<K1>(k1, e1);
  }
  if constexpr (K2 != 0) {
    if constexpr (K0 != 0 || K1 != 0) s = s + cmul<K2>(k2, e2);
    else s = cmul<K2>(k2, e2);
  }
  return s;
}

// An off-diagonal entry of G: k_oc·oc + k_s·s; absent (0 here, never read)
// when both codes are 0.
template <int Koc, int Ks>
__device__ __forceinline__ float g_off(float k_oc, float oc, float k_s,
                                       float s) {
  if constexpr (Koc == 0 && Ks == 0) return 0.0f;
  else return csum<Koc, Ks>(k_oc, oc, k_s, s);
}

// One joint of a static chain: its type (0 revolute, 1 prismatic), the
// codes of its axis, and the number of bodies it carries.
template <int Type, int AX, int AY, int AZ, int NBodies>
struct Joint {
  static constexpr int n_bodies = NBodies;

  // The joint's motion at q; J[1..3] is the axis (read where kOther).
  __device__ __forceinline__ static void move(const float* J, float q,
                                              float (&R)[9], float (&p)[3]) {
    const float x = J[1], y = J[2], z = J[3];
    if constexpr (Type != 0) {
      // prismatic: translate along the live components, rotation unchanged
      if constexpr (AX != 0 || AY != 0 || AZ != 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          p[i] = p[i] + csum<AX, AY, AZ>(x, R[3 * i], y, R[3 * i + 1], z,
                                         R[3 * i + 2]) * q;
      }
    } else {
      // revolute: R <- R @ G, G = rodrigues(axis, q) with its live terms
      constexpr int XX = code_mul(AX, AX), YY = code_mul(AY, AY),
                    ZZ = code_mul(AZ, AZ), XY = code_mul(AX, AY),
                    XZ = code_mul(AX, AZ), YZ = code_mul(AY, AZ);
      // which entries of G are live: kOther (multiplied) or 0 (absent)
      constexpr int L[9] = {
          kOther, (XY || AZ) ? kOther : 0, (XZ || AY) ? kOther : 0,
          (XY || AZ) ? kOther : 0, kOther, (YZ || AX) ? kOther : 0,
          (XZ || AY) ? kOther : 0, (YZ || AX) ? kOther : 0, kOther};
      float s, co;
      sincosf(q, &s, &co);
      const float oc = 1.0f - co;
      const float G[9] = {
          csum<1, XX>(1.0f, co, x * x, oc),
          g_off<XY, code_neg(AZ)>(x * y, oc, -z, s),
          g_off<XZ, AY>(x * z, oc, y, s),
          g_off<XY, AZ>(y * x, oc, z, s),
          csum<1, YY>(1.0f, co, y * y, oc),
          g_off<YZ, code_neg(AX)>(y * z, oc, -x, s),
          g_off<XZ, code_neg(AY)>(z * x, oc, -y, s),
          g_off<YZ, AX>(z * y, oc, x, s),
          csum<1, ZZ>(1.0f, co, z * z, oc)};
      float Rn[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Rn[3 * i] = csum<L[0], L[3], L[6]>(G[0], R[3 * i], G[3], R[3 * i + 1],
                                           G[6], R[3 * i + 2]);
        Rn[3 * i + 1] = csum<L[1], L[4], L[7]>(
            G[1], R[3 * i], G[4], R[3 * i + 1], G[7], R[3 * i + 2]);
        Rn[3 * i + 2] = csum<L[2], L[5], L[8]>(
            G[2], R[3 * i], G[5], R[3 * i + 1], G[8], R[3 * i + 2]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
  }
};

// A robot compiled in: the joint loop and each joint's body loop unrolled.
template <int SkipRotf, class... Joints>
struct StaticChain {
  static constexpr int d = sizeof...(Joints);
  static constexpr int nb = (0 + ... + Joints::n_bodies);
  static constexpr int skip_rotf = SkipRotf;

  template <class Body>
  __device__ __forceinline__ void walk(const float* P, const float* q_of,
                                       float (&R)[9], float (&p)[3],
                                       Body& body) const {
    step<0, 0, Joints...>(P, q_of, R, p, body);
  }

 private:
  template <int J, int B, class First, class... Rest, class Body>
  __device__ __forceinline__ static void step(const float* P,
                                              const float* q_of,
                                              float (&R)[9], float (&p)[3],
                                              Body& body) {
    const float* Jp = P + 12 + 16 * J;
    joint_origin(Jp, SkipRotf != 0, R, p);
    First::move(Jp, q_of[J * kWarp * kPitch], R, p);
#pragma unroll
    for (int b = B; b < B + First::n_bodies; ++b) body(b);
    if constexpr (sizeof...(Rest) > 0)
      step<J + 1, B + First::n_bodies, Rest...>(P, q_of, R, p, body);
  }
};

// ChainOf<skip_rotf, type, ax, ay, az, n_bodies, ...>::type: the
// StaticChain of the codes the wrapper passes as -DROLLOUT_CHAIN (five a
// joint).
template <class Chain, int... Codes>
struct AppendJoints {
  static_assert(sizeof...(Codes) == 0, "five codes a joint");
  using type = Chain;
};
template <int S, class... Js, int Ty, int X, int Y, int Z, int N,
          int... More>
struct AppendJoints<StaticChain<S, Js...>, Ty, X, Y, Z, N, More...> {
  using type = typename AppendJoints<
      StaticChain<S, Js..., Joint<Ty, X, Y, Z, N>>, More...>::type;
};
template <int SkipRotf, int... Codes>
struct ChainOf {
  using type = typename AppendJoints<StaticChain<SkipRotf>, Codes...>::type;
};

// The codes of -DROLLOUT_CHAIN=chain_<code>_<code>..., one identifier (nvcc
// splits a definition's value at commas), a negative code written n<abs>:
// how many there are in its spelling s, and the i-th.
__host__ __device__ constexpr int chain_codes(const char* s) {
  int n = 0;
  for (; *s; ++s) n += *s == '_';
  return n;
}
__host__ __device__ constexpr int chain_code(const char* s, int i) {
  for (int k = -1; k < i; ++s)
    if (*s == '_') ++k;
  const int sign = *s == 'n' ? -1 : 1;
  if (*s == 'n') ++s;
  int v = 0;
  for (; *s >= '0' && *s <= '9'; ++s) v = 10 * v + (*s - '0');
  return sign * v;
}
#ifdef ROLLOUT_CHAIN
#define ROLLOUT_SPELL2(x) #x
#define ROLLOUT_SPELL(x) ROLLOUT_SPELL2(x)
template <int... I>
typename ChainOf<chain_code(ROLLOUT_SPELL(ROLLOUT_CHAIN), I)...>::type
chain_of_codes(
    std::integer_sequence<int, I...>);
using CompiledChain = decltype(chain_of_codes(std::make_integer_sequence<
    int, chain_codes(ROLLOUT_SPELL(ROLLOUT_CHAIN))>{}));
#endif

// launch(chain) with the chain this library was built for: the robot's
// StaticChain under -DROLLOUT_CHAIN (cudaErrorInvalidValue when d, nb or
// skip_rotf disagree with it), else RuntimeChain.
template <class F>
inline int with_chain(int d, int nb, int skip_rotf, F launch) {
#ifdef ROLLOUT_CHAIN
  using Chain = CompiledChain;
  static_assert(Chain::d > 0, "ROLLOUT_CHAIN names no joint");
  if (d != Chain::d || nb != Chain::nb || skip_rotf != Chain::skip_rotf)
    return (int)cudaErrorInvalidValue;
  return launch(Chain{});
#else
  return launch(RuntimeChain{d, nb, skip_rotf});
#endif
}

// The kernel body; launched as a grid of (ceil(C / kCands), segments)
// blocks of kBlock threads. World is a policy with
//   __device__ Dist at(const float* W, int c) const
// binding candidate c's distance once per warp: Dist is callable as
// dist(x0, x1, x2), the signed distance at a body center (W: the world
// section of the shared-memory parameters). Chain is RuntimeChain or a
// StaticChain (with_chain).
template <class World, class Chain>
__device__ __forceinline__ void evaluate(
    const World& world, const Chain& chain,
    const float* __restrict__ cand,                       // [d, T, C]
    const float* __restrict__ params, int n_params,
    const uint8_t* __restrict__ active,                   // [C] or nullptr
    float* __restrict__ q_obs,                            // [T, C]
    float* __restrict__ margin_part,                      // [segments, C]
    float* __restrict__ ee,                               // [12, T, C] or nullptr
    int C, int T, float dt, float clearance, int seg_len) {
  const int d = chain.d, nb = chain.nb;
  extern __shared__ float smem[];
  float* P = smem;
  float* tile = smem + ((n_params + 31) & ~31);   // [d][kWarp][kPitch]
  float* q_st = tile + d * kWarp * kPitch;        // [kWarp][kPitch]
  float* m_st = q_st + kWarp * kPitch;            // [kCands]
  float* ee_st = m_st + kWarp;                    // [12][kWarp][kPitch]

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int c0 = blockIdx.x * kCands;
  const int seg = blockIdx.y;
  const int t0 = seg * seg_len;
  const int n_own = min(seg_len, T - t0);
  const int n_rows = n_own + 2;                   // with the two halo lanes

  for (int i = threadIdx.x; i < n_params; i += kBlock) P[i] = params[i];
  // the joint tile: thread (l, cc) loads waypoint t0 - 1 + l (clamped) of
  // candidate c0 + cc for every joint; a warp reads 4 whole sectors a joint
  if (threadIdx.x < n_rows * kCands) {
    const int l = threadIdx.x / kCands, cc = threadIdx.x % kCands;
    const int ci = c0 + cc;
    if (ci < C && (active == nullptr || active[ci])) {
      const int t = min(max(t0 - 1 + l, 0), T - 1);
      const float* src = cand + (size_t)t * C + ci;
      float* dst = tile + l * kPitch + cc;
      for (int j = 0; j < d; ++j)
        dst[j * kWarp * kPitch] = src[(size_t)j * T * C];
    }
  }
  __syncthreads();

  const int c = c0 + warp;
  const int t = t0 - 1 + lane;
  const bool own = lane >= 1 && lane <= n_own;
  float* q_at = q_st + lane * kPitch + warp;
  float* ee_at = ee_st + lane * kPitch + warp;    // frame k at k * kWarp * kPitch
  if (c < C && active != nullptr && !active[c]) {
    *q_at = 0.0f;
    if (ee != nullptr)
      for (int k = 0; k < 12; ++k) ee_at[k * kWarp * kPitch] = 0.0f;
    if (lane == 0) m_st[warp] = 0.0f;
  } else if (c < C) {
    const int body_start = 12 + 16 * d;
    const int body_base = body_start + d + 1;
    const auto dist_at = world.at(P + body_base + 4 * nb, c);
    const float* q_of = tile + min(lane, n_rows - 1) * kPitch + warp;
    const float inv_dt = 1.0f / dt;
    const float inv_2dt = 1.0f / (2.0f * dt);
    float R[9], p[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = P[k];
    p[0] = P[9]; p[1] = P[10]; p[2] = P[11];
    float acc = 0.0f, margin = kBig;
    // one body of the current joint, with the joint's frame (R, p) live
    auto body = [&](int b) {
      const float* Bd = P + body_base + 4 * b;
      const float e0 = Bd[0], e1 = Bd[1], e2 = Bd[2];
      const float x0 = p[0] + R[0] * e0 + R[1] * e1 + R[2] * e2;
      const float x1 = p[1] + R[3] * e0 + R[4] * e1 + R[5] * e2;
      const float x2 = p[2] + R[6] * e0 + R[7] * e1 + R[8] * e2;
      // the body at t - 1 and t + 1: the neighbouring lanes
      const float u0 = __shfl_up_sync(kFull, x0, 1);
      const float u1 = __shfl_up_sync(kFull, x1, 1);
      const float u2 = __shfl_up_sync(kFull, x2, 1);
      const float n0 = __shfl_down_sync(kFull, x0, 1);
      const float n1 = __shfl_down_sync(kFull, x1, 1);
      const float n2 = __shfl_down_sync(kFull, x2, 1);
      if (own) {
        float v0, v1, v2;
        if (t == 0) {
          v0 = (n0 - x0) * inv_dt;
          v1 = (n1 - x1) * inv_dt;
          v2 = (n2 - x2) * inv_dt;
        } else if (t == T - 1) {
          v0 = (x0 - u0) * inv_dt;
          v1 = (x1 - u1) * inv_dt;
          v2 = (x2 - u2) * inv_dt;
        } else {
          v0 = (n0 - u0) * inv_2dt;
          v1 = (n1 - u1) * inv_2dt;
          v2 = (n2 - u2) * inv_2dt;
        }
        const float speed = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
        const float dist = dist_at(x0, x1, x2);
        const float radius = Bd[3];
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
    };
    chain.walk(P, q_of, R, p, body);
    *q_at = acc * dt;
    if (ee != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) ee_at[k * kWarp * kPitch] = p[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) ee_at[(3 + k) * kWarp * kPitch] = R[k];
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2)
      margin = fminf(margin, __shfl_xor_sync(kFull, margin, o));
    if (lane == 0) m_st[warp] = margin;
  }
  __syncthreads();

  // the owned waypoints of the tile, 32 bytes (kCands candidates) a row
  const size_t plane = (size_t)T * C;
  if (threadIdx.x < n_own * kCands) {
    const int l = threadIdx.x / kCands, cc = threadIdx.x % kCands;
    const int ci = c0 + cc;
    if (ci < C) {
      const size_t o = (size_t)(t0 + l) * C + ci;
      const int s = (l + 1) * kPitch + cc;
      q_obs[o] = q_st[s];
      if (ee != nullptr)
        for (int k = 0; k < 12; ++k)
          ee[k * plane + o] = ee_st[k * kWarp * kPitch + s];
    }
  }
  if (threadIdx.x < kCands && c0 + (int)threadIdx.x < C)
    margin_part[(size_t)seg * C + c0 + threadIdx.x] = m_st[threadIdx.x];
}

// Checks the segment length and opts the kernel in to its shared memory
// above 48 KB (cudaFuncSetAttribute); returns a cudaError_t.
template <class Kernel>
inline int prepare(Kernel kernel, size_t smem, int seg_len) {
  if (seg_len < 1 || seg_len > kSegMax) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace rollout

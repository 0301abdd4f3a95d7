// CHOMP's functional gradient ∇U for Hopper (sm_90a): point Jacobians, the
// SDF gradient, the curvature term, the damped pseudo-inverse and the Jᵀ sum
// in one pass over θ, with the smoothness term added in the epilogue.
//
// Replaces no Pallas kernel: the JAX package computes this gradient in XLA
// (tpustomp/engine/chomp.py obstacle_functional_gradient + chomp_gradient),
// which fuses it on the TPU. Written out in PyTorch
// (tpustomp_torch/engine/chomp.py, the plain version this kernel is held to)
// it is some thirty passes over the point Jacobians [B, T, nb, 3, d] (105 MB
// at config 3's B = 1,024, T = 102, 12 bodies, 7 joints) and their
// neighbours: fk_frames' stacks, rodrigues, the mask's where, the cross
// products, the 3x3 system's G, the stacks of the solve and the Jᵀ sum.
// This kernel reads θ [B, N, d], Q0 and QN [B, d] and the smoothness term
// S = R θ + R_bias [q0; qN] [B, N, d] (a torch.matmul outside), and writes
//     out[b, n] = w_obs * g_obs[b, n] + w_smooth * S[b, n]     (n = t - 1)
// for the interior waypoints t = 1..N of the full trajectory (Q0, θ, QN),
// with g_obs the plain version's, term for term:
//   x_b        body b's world position (fk_frames, then its offset);
//   J_b        its point Jacobian: column i is w_i × (x_b − p_i) for a
//              revolute joint, w_i for a prismatic one, for i <= link(b)
//              (p_i the joint's origin after its motion, w_i its world axis);
//   v, a       workspace velocity and acceleration: central differences
//              over t, one-sided at both ends of the trajectory;
//   d, ∇d      the world's signed distance and its gradient at x_b (the
//              World policies below: world/sdf.py sdf_grad);
//   ws         with use_curvature
//                speed · (P(φ'(d_sig) ∇d) − φ(d_sig) κ) · dt,
//                P(u) = u − x̂ (x̂·u), x̂ = v / (speed + 1e-6),
//                κ = P(a) / (speed² + 1e-6),
//              else φ'(d_sig) ∇d · speed · dt; d_sig = d − radius − clearance;
//   f          with use_pseudo_inverse (J Jᵀ + ridge·I)⁻¹ ws, the
//              closed-form adjugate of engine/chomp.py _dls_solve3 in its
//              multiply-add order, else ws;
//   g_obs[i]   Σ over bodies of f · J_b[:, i].
// Every division the plain version makes is an IEEE division here too;
// nvcc's FMA contraction and the order of the sums over bodies and joints
// move results by a few ULP, more where the plain version is at a tie (two
// primitives or two box faces equally near: the argmin's gradient jumps).
// The epilogue rounds its product and sum each (__fmul_rn, __fadd_rn), as
// torch's elementwise ops do.
//
// What bounds it on the H100: instruction issue. Per waypoint the work is
// the FK chain (as K3's) plus, for each of nb bodies, its Jacobian columns
// (up to d crosses), the SDF gradient, the curvature term and the 3x3
// solve: ~5,000 float operations at config 3, 0.5 GFLOP a call, against 6
// MB of input and 3 MB of output. The design keeps every intermediate in
// registers and reads each input once:
//   * A warp walks a window of 32 consecutive (row, waypoint) pairs laid
//     end to end over the rows: lanes 2..29 own their waypoint, lanes 0, 1,
//     30 and 31 are the halo the differences need (each owned again by a
//     neighbouring window). Velocity and acceleration come from the
//     neighbouring lanes' body positions and velocities by __shfl_up/down
//     (no FK is computed twice in a window); a row boundary inside a window
//     needs no halo, because t = 0 and t = T − 1 take one-sided
//     differences toward their own row and own no output.
//   * Each lane walks its waypoint's chain once (rollout_common.cuh's joint
//     chain: the robot's StaticChain under -DROLLOUT_CHAIN, its joint and
//     body loops unrolled and its axes folded; RuntimeChain otherwise),
//     keeping each joint's origin and world axis as the walk passes it, so
//     a body's Jacobian columns are formed where the body is placed, from
//     registers (the static chain) or the lane's stack (the runtime chain,
//     up to kRuntimeJoints joints).
//   * The lane sums its d-vector of g_obs over the bodies in registers and
//     stores it once, with the epilogue: no atomics, so a replay is bitwise
//     the run before it.
//   * The robot and a shared world take the evaluators' parameter routes
//     (rollout_common.cuh with_params: the by-value 3 KB or 31 KB block,
//     the primitive counts compiled in where they fit; or device memory,
//     staged in shared memory), so a captured launch's block is rewritten
//     by engine/graph.py like the evaluators' (its arguments are (World,
//     Chain, Par, Shape) as theirs, kernels/graph_node.py ARGS and PAR).
//   * A library holds one world kind and one pair of primitive counts, its
//     three parameter routes (with_built_params below): kernels/chomp_grad.py
//     builds it with -DCHOMP_GRAD_GRID (0 an AnalyticWorld, 1 a GridSDF or
//     a CompositeWorld), -DCHOMP_GRAD_NS and -DCHOMP_GRAD_NX (the world's
//     sphere and box counts where they fit kAnalyticFloats or
//     kOverlayFloats, else -1: read at run time), so a checkout's first
//     solve compiles three instantiations, not every pair of counts.
// This file adds no code to the evaluator kernels: rollout_common.cuh is
// only included.
//
// Plain C interface (ctypes); returns a cudaError_t, 0 on success.

#if !defined(CHOMP_GRAD_GRID) || !defined(CHOMP_GRAD_NS) || \
    !defined(CHOMP_GRAD_NX)
#error "build with -DCHOMP_GRAD_GRID, -DCHOMP_GRAD_NS and -DCHOMP_GRAD_NX"
#endif

#include "rollout_common.cuh"

namespace {

using rollout::kAny;
using rollout::kBig;
using rollout::kFull;
using rollout::kOther;

constexpr int kWarp = 32;
constexpr int kThreads = 128;                     // 4 warps, a window each
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kHalo = 2;                          // lanes on either side
constexpr int kOwn = kWarp - 2 * kHalo;           // owned lanes a window
constexpr int kRuntimeJoints = 32;                // the runtime chain's most
constexpr float kTiny = 1e-12f;                   // world/sdf.py's tiny
constexpr float kSpeedEps = 1e-6f;                // engine/chomp.py _SPEED_EPS
// Worlds within these floats of primitives run with their counts compiled
// in, as the evaluators' (rollout_analytic.cu, rollout_grid.cu).
constexpr int kAnalyticFloats = 16;
constexpr int kOverlayFloats = 4;

struct Shape {
  const float* theta;    // [B, N, d], strides th_*
  const float* q0;       // [B, d], strides q0_*
  const float* qn;       // [B, d], strides qn_*
  const float* smooth;   // [B, N, d], contiguous
  float* out;            // [B, N, d], contiguous
  long long th_b, th_n, th_j, q0_b, q0_j, qn_b, qn_j;
  int B, N, n_params;
  // the plain version's float32 constants: dt, 2·dt, clearance (eps),
  // 0.5·eps, the potential's denominators (eps, 2·eps; 1 where eps <= 0),
  // the ridge and the two weights
  float dt, two_dt, eps, half_eps, den, quad_den, ridge, w_obs, w_smooth;
  int curvature, pinv;
};

// A distance and its gradient.
struct DistGrad {
  float d, g0, g1, g2;
};

// torch.sign: -1, 0 or +1 (NaN passes)
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// safe_norm: 0 at 0, the square root above
__device__ __forceinline__ float safe_norm3(float a, float b, float c) {
  const float sq = a * a + b * b + c * c;
  return sq > 0.0f ? sqrtf(sq) : sq * 0.0f;
}

// The min-composed SDF of ns spheres (S: center[3], radius) and nx boxes
// (X: center[3], half[3]) with the argmin primitive's gradient (the first
// on ties), world/sdf.py _analytic_sdf_grad: a sphere's rel / ‖rel‖; a box
// outside (max(q, 0) ⊙ sign(rel)) / ‖max(q, 0)‖, inside a unit step toward
// its nearest face, shared among tied faces. kBig and 0 without any.
template <int NS, int NX, class Load>
__device__ __forceinline__ DistGrad prims_grad(Load ld, const float* S,
                                               int ns, const float* X, int nx,
                                               float x0, float x1, float x2) {
  if (NS != kAny) ns = NS;
  if (NX != kAny) nx = NX;
  DistGrad r{kBig, 0.0f, 0.0f, 0.0f};
  bool any = false;
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    const float* P = S + 4 * s;
    const float r0 = x0 - ld(P), r1 = x1 - ld(P + 1), r2 = x2 - ld(P + 2);
    const float norm = safe_norm3(r0, r1, r2);
    const float ds = norm - ld(P + 3);
    if (!any || ds < r.d) {
      const float den = norm + kTiny;
      r = DistGrad{ds, r0 / den, r1 / den, r2 / den};
      any = true;
    }
  }
#pragma unroll
  for (int k = 0; k < nx; ++k) {
    const float* P = X + 6 * k;
    const float r0 = x0 - ld(P), r1 = x1 - ld(P + 1), r2 = x2 - ld(P + 2);
    const float q0 = fabsf(r0) - ld(P + 3);
    const float q1 = fabsf(r1) - ld(P + 4);
    const float q2 = fabsf(r2) - ld(P + 5);
    const float w0 = fmaxf(q0, 0.0f), w1 = fmaxf(q1, 0.0f),
                w2 = fmaxf(q2, 0.0f);
    const float outside = safe_norm3(w0, w1, w2);
    const float q_max = fmaxf(fmaxf(q0, q1), q2);
    const float db = outside + fminf(q_max, 0.0f);
    if (!any || db < r.d) {
      const float s0 = sign_of(r0), s1 = sign_of(r1), s2 = sign_of(r2);
      if (outside > 0.0f) {
        const float den = outside + kTiny;
        r = DistGrad{db, w0 * s0 / den, w1 * s1 / den, w2 * s2 / den};
      } else {
        const float f0 = q0 == q_max ? 1.0f : 0.0f;
        const float f1 = q1 == q_max ? 1.0f : 0.0f;
        const float f2 = q2 == q_max ? 1.0f : 0.0f;
        const float n = fmaxf(f0 + f1 + f2, 1.0f);
        r = DistGrad{db, f0 / n * s0, f1 / n * s1, f2 / n * s2};
      }
      any = true;
    }
  }
  return r;
}

template <int NS, int NX, class Load>
struct PrimsGradAt {
  const float* S;
  int ns;
  const float* X;
  int nx;
  __device__ __forceinline__ DistGrad operator()(float x0, float x1,
                                                 float x2) const {
    return prims_grad<NS, NX>(Load{}, S, ns, X, nx, x0, x1, x2);
  }
};

// An AnalyticWorld shared by every row: its primitives in the world
// section W of the parameters, at fixed offsets where the counts are
// compiled in.
template <int NS, int NX>
struct AnalyticGrad {
  int ns, nx;
  __device__ __forceinline__ PrimsGradAt<NS, NX, rollout::Deref> at(
      const float* W) const {
    return {W, ns, W + (NS == kAny ? 4 * ns : 4 * NS), nx};
  }
};

// The shared grid: dense [X, Y, Z], or the packed corner table [X*Y*Z, 8]
// read as two float4 a sample (world/sdf.py GridSDF.packed).
struct GridDims {
  const float* grid;
  const float4* packed;
  int X, Y, Z;
  float hi0, hi1, hi2;              // shape - 1.000001, in float32
};

// The trilinear sample and its analytic gradient, world/sdf.py
// _grid_sample(with_grad=True) step by step: g = (x - origin) / resolution,
// the clip, the cell clipped to [0, dim - 2], interpolation along z, then
// y, then x; the gradient's differences times 1 / resolution.
struct GridGradSample {
  GridDims dims;
  const float* G;                   // origin[3], resolution: parameters

  __device__ __forceinline__ DistGrad operator()(float x0, float x1,
                                                 float x2) const {
    const float res = G[3];
    float g0 = (x0 - G[0]) / res;
    float g1 = (x1 - G[1]) / res;
    float g2 = (x2 - G[2]) / res;
    g0 = fminf(fmaxf(g0, 0.0f), dims.hi0);
    g1 = fminf(fmaxf(g1, 0.0f), dims.hi1);
    g2 = fminf(fmaxf(g2, 0.0f), dims.hi2);
    const int Y = dims.Y, Z = dims.Z;
    const int i0 = min(max((int)floorf(g0), 0), dims.X - 2);
    const int i1 = min(max((int)floorf(g1), 0), Y - 2);
    const int i2 = min(max((int)floorf(g2), 0), Z - 2);
    const float fx = g0 - (float)i0;
    const float fy = g1 - (float)i1;
    const float fz = g2 - (float)i2;
    const int base = (i0 * Y + i1) * Z + i2;
    float c000, c001, c010, c011, c100, c101, c110, c111;
    if (dims.packed != nullptr) {
      const float4 a = __ldg(dims.packed + 2 * (size_t)base);
      const float4 b = __ldg(dims.packed + 2 * (size_t)base + 1);
      c000 = a.x; c001 = a.y; c010 = a.z; c011 = a.w;
      c100 = b.x; c101 = b.y; c110 = b.z; c111 = b.w;
    } else {
      const float* grid = dims.grid;
      const int sy = Z, sx = Y * Z;
      c000 = __ldg(grid + base);
      c001 = __ldg(grid + base + 1);
      c010 = __ldg(grid + base + sy);
      c011 = __ldg(grid + base + sy + 1);
      c100 = __ldg(grid + base + sx);
      c101 = __ldg(grid + base + sx + 1);
      c110 = __ldg(grid + base + sx + sy);
      c111 = __ldg(grid + base + sx + sy + 1);
    }
    const float ux = 1.0f - fx, uy = 1.0f - fy, uz = 1.0f - fz;
    const float c00 = c000 * uz + c001 * fz;
    const float c01 = c010 * uz + c011 * fz;
    const float c10 = c100 * uz + c101 * fz;
    const float c11 = c110 * uz + c111 * fz;
    const float c0 = c00 * uy + c01 * fy;
    const float c1 = c10 * uy + c11 * fy;
    const float inv_res = 1.0f / res;
    return DistGrad{
        c0 * ux + c1 * fx, (c1 - c0) * inv_res,
        ((c01 - c00) * ux + (c11 - c10) * fx) * inv_res,
        (((c001 - c000) * uy + (c011 - c010) * fy) * ux
         + ((c101 - c100) * uy + (c111 - c110) * fy) * fx) * inv_res};
  }
};

// The grid's distance and gradient, min-composed with the overlay for a
// composite world: the grid's gradient where it is nearer or tied.
template <class Overlay>
struct GridGradPoint {
  GridGradSample sample;
  Overlay overlay;
  int composite;
  __device__ __forceinline__ DistGrad operator()(float x0, float x1,
                                                 float x2) const {
    DistGrad r = sample(x0, x1, x2);
    if (!composite) return r;
    const DistGrad a = overlay(x0, x1, x2);
    const float d = fminf(r.d, a.d);
    if (!(r.d <= a.d)) r = a;
    r.d = d;
    return r;
  }
};

// A GridSDF, or a CompositeWorld whose overlay is in the parameters.
template <int NS, int NX>
struct GridGrad {
  GridDims dims;
  int ns, nx, composite;
  __device__ __forceinline__ auto at(const float* W) const {
    const PrimsGradAt<NS, NX, rollout::Deref> overlay{
        W, ns, W + (NS == kAny ? 4 * ns : 4 * NS), nx};
    const int floats = NS == kAny ? 4 * ns + 6 * nx : 4 * NS + 6 * NX;
    return GridGradPoint<decltype(overlay)>{{dims, W + floats}, overlay,
                                            composite};
  }
};

// ---- The chain walk with each joint's frame --------------------------------
// Walk<Chain>::walk(chain, P, q, qs, R, p, lane) runs one waypoint's FK
// from the base frame (R, p), joint j's angle at q[j * qs]: at each joint
// it moves the frame to the joint's origin, takes the joint's world axis
// (the plain version's R_mid · axis), applies the motion, hands the lane
// the joint's frame (lane.frame(j, axis, p, prismatic)) and then each body
// on the joint (lane.body(b, j)). rollout_common.cuh's joint_origin and
// Joint::move do the arithmetic, as in the evaluators' walk.

template <class Joint>
struct JointAxis;
template <int Ty, int AX, int AY, int AZ, int NB>
struct JointAxis<rollout::Joint<Ty, AX, AY, AZ, NB>> {
  static constexpr bool kPrismatic = Ty != 0;
  // R · axis over the axis's live components (J[1..3] read where kOther)
  __device__ __forceinline__ static void world(const float* J,
                                               const float (&R)[9],
                                               float (&aw)[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if constexpr (AX != 0 || AY != 0 || AZ != 0)
        aw[i] = rollout::csum<AX, AY, AZ>(J[1], R[3 * i], J[2], R[3 * i + 1],
                                          J[3], R[3 * i + 2]);
      else
        aw[i] = 0.0f;
    }
  }
};

template <class Chain>
struct Walk;

template <int SkipRotf, class... Joints>
struct Walk<rollout::StaticChain<SkipRotf, Joints...>> {
  static constexpr int kJoints = sizeof...(Joints);

  template <class Lane>
  __device__ __forceinline__ static void walk(
      const rollout::StaticChain<SkipRotf, Joints...>&, const float* P,
      const float* q, long long qs, float (&R)[9], float (&p)[3],
      Lane& lane) {
    step<0, 0, Joints...>(P, q, qs, R, p, lane);
  }

 private:
  template <int J, int B, class First, class... Rest, class Lane>
  __device__ __forceinline__ static void step(const float* P, const float* q,
                                              long long qs, float (&R)[9],
                                              float (&p)[3], Lane& lane) {
    using Axis = JointAxis<First>;
    const float* Jp = P + 12 + 16 * J;
    rollout::joint_origin(Jp, SkipRotf != 0, R, p);
    float aw[3];
    Axis::world(Jp, R, aw);
    First::move(Jp, q[J * qs], R, p);
    lane.frame(J, aw, p, Axis::kPrismatic);
#pragma unroll
    for (int b = B; b < B + First::n_bodies; ++b) lane.body(b, J);
    if constexpr (sizeof...(Rest) > 0)
      step<J + 1, B + First::n_bodies, Rest...>(P, q, qs, R, p, lane);
  }
};

template <>
struct Walk<rollout::RuntimeChain> {
  static constexpr int kJoints = kRuntimeJoints;

  template <class Lane>
  __device__ __forceinline__ static void walk(
      const rollout::RuntimeChain& chain, const float* P, const float* q,
      long long qs, float (&R)[9], float (&p)[3], Lane& lane) {
    // every axis component read at run time, as RuntimeChain reads them
    using Revolute = rollout::Joint<0, kOther, kOther, kOther, 0>;
    using Prismatic = rollout::Joint<1, kOther, kOther, kOther, 0>;
    const int body_start = 12 + 16 * chain.d;
    for (int j = 0; j < chain.d; ++j) {
      const float* J = P + 12 + 16 * j;
      rollout::joint_origin(J, chain.skip_rotf, R, p);
      float aw[3];
      JointAxis<Revolute>::world(J, R, aw);
      const bool prismatic = J[0] != 0.0f;
      if (prismatic)
        Prismatic::move(J, q[j * qs], R, p);
      else
        Revolute::move(J, q[j * qs], R, p);
      lane.frame(j, aw, p, prismatic);
      const int b_hi = (int)P[body_start + j + 1];
      for (int b = (int)P[body_start + j]; b < b_hi; ++b) lane.body(b, j);
    }
  }
};

// f(i) for each joint i <= j: unrolled over the static chain's KJ joints
// (j is then a constant and the arrays stay in registers), a loop to j on
// the runtime chain.
template <int KJ, class F>
__device__ __forceinline__ void for_joints(int j, F&& f) {
  if constexpr (KJ == kRuntimeJoints) {
    for (int i = 0; i <= j; ++i) f(i);
  } else {
#pragma unroll
    for (int i = 0; i < KJ; ++i)
      if (i <= j) f(i);
  }
}

// One lane's waypoint: the joints' frames as the walk passes them, and
// the gradient it sums over the bodies.
template <int KJ, class Dist>
struct GradLane {
  const Dist& dist;
  const float* bodies;              // offset[3], radius per body
  const Shape& s;
  const float (&R)[9];              // the walk's frame, live at body()
  const float (&p)[3];
  bool own;
  int t, T;
  float jp[KJ][3];                  // joint origins after their motion
  float jw[KJ][3];                  // joint world axes
  bool prismatic[KJ];
  float g[KJ];

  __device__ __forceinline__ void frame(int j, const float (&aw)[3],
                                        const float (&pj)[3], bool prism) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      jp[j][k] = pj[k];
      jw[j][k] = aw[k];
    }
    prismatic[j] = prism;
  }

  // joint i's Jacobian column at the body's position x
  __device__ __forceinline__ void column(int i, const float (&x)[3],
                                         float (&c)[3]) const {
    const float a0 = jw[i][0], a1 = jw[i][1], a2 = jw[i][2];
    if (prismatic[i]) {
      c[0] = a0;
      c[1] = a1;
      c[2] = a2;
    } else {
      const float r0 = x[0] - jp[i][0], r1 = x[1] - jp[i][1],
                  r2 = x[2] - jp[i][2];
      c[0] = a1 * r2 - a2 * r1;
      c[1] = a2 * r0 - a0 * r2;
      c[2] = a0 * r1 - a1 * r0;
    }
  }

  // body b on joint j: its workspace force, mapped to the joints i <= j
  __device__ __forceinline__ void body(int b, int j) {
    const float* Bd = bodies + 4 * b;
    const float e0 = Bd[0], e1 = Bd[1], e2 = Bd[2];
    float x[3], v[3], a[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      x[i] = p[i] + R[3 * i] * e0 + R[3 * i + 1] * e1 + R[3 * i + 2] * e2;
    // velocity from the lanes at t - 1 and t + 1, one-sided at the ends
    const bool first = t == 0, last = t == T - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float up = __shfl_up_sync(kFull, x[i], 1);
      const float dn = __shfl_down_sync(kFull, x[i], 1);
      v[i] = first ? (dn - x[i]) / s.dt
             : last ? (x[i] - up) / s.dt : (dn - up) / s.two_dt;
    }
    // acceleration at an owned (interior) waypoint: the central difference
    // of the neighbouring lanes' velocities
    if (s.curvature) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float up = __shfl_up_sync(kFull, v[i], 1);
        const float dn = __shfl_down_sync(kFull, v[i], 1);
        a[i] = (dn - up) / s.two_dt;
      }
    }
    if (!own) return;
    const float speed = safe_norm3(v[0], v[1], v[2]);
    const DistGrad dg = dist(x[0], x[1], x[2]);
    const float grad[3] = {dg.g0, dg.g1, dg.g2};
    const float d_sig = dg.d - Bd[3] - s.eps;
    const float pd = d_sig < 0.0f ? -1.0f
                     : d_sig <= s.eps ? (d_sig - s.eps) / s.den : 0.0f;
    float ws[3];
    if (s.curvature) {
      const float sp = speed + kSpeedEps;
      float xh[3], u[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xh[i] = v[i] / sp;
        u[i] = pd * grad[i];
      }
      const float xu = xh[0] * u[0] + xh[1] * u[1] + xh[2] * u[2];
      const float xa = xh[0] * a[0] + xh[1] * a[1] + xh[2] * a[2];
      const float sp2 = speed * speed + kSpeedEps;
      const float e = d_sig - s.eps;
      const float pot = d_sig < 0.0f ? -d_sig + s.half_eps
                        : d_sig <= s.eps ? e * e / s.quad_den : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float kappa = (a[i] - xh[i] * xa) / sp2;
        ws[i] = speed * ((u[i] - xh[i] * xu) - pot * kappa) * s.dt;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) ws[i] = pd * grad[i] * speed * s.dt;
    }
    float f[3] = {ws[0], ws[1], ws[2]};
    if (s.pinv) {
      // J Jᵀ over the live columns, then engine/chomp.py _dls_solve3
      float G00 = 0.0f, G01 = 0.0f, G02 = 0.0f, G11 = 0.0f, G12 = 0.0f,
            G22 = 0.0f;
      for_joints<KJ>(j, [&](int i) {
        float c[3];
        column(i, x, c);
        G00 += c[0] * c[0];
        G01 += c[0] * c[1];
        G02 += c[0] * c[2];
        G11 += c[1] * c[1];
        G12 += c[1] * c[2];
        G22 += c[2] * c[2];
      });
      const float ga = G00 + s.ridge, gp = G01, gq = G02;
      const float gd = G11 + s.ridge, gr = G12, gf = G22 + s.ridge;
      const float A = gd * gf - gr * gr;
      const float Bc = gq * gr - gp * gf;
      const float C = gp * gr - gq * gd;
      const float D = ga * gf - gq * gq;
      const float E = gp * gq - ga * gr;
      const float F = ga * gd - gp * gp;
      const float det = ga * A + gp * Bc + gq * C;
      f[0] = (A * ws[0] + Bc * ws[1] + C * ws[2]) / det;
      f[1] = (Bc * ws[0] + D * ws[1] + E * ws[2]) / det;
      f[2] = (C * ws[0] + E * ws[1] + F * ws[2]) / det;
    }
    for_joints<KJ>(j, [&](int i) {
      float c[3];
      column(i, x, c);
      g[i] += f[0] * c[0] + f[1] * c[1] + f[2] * c[2];
    });
  }
};

template <class Chain>
constexpr int grad_min_blocks() {
  return Walk<Chain>::kJoints == kRuntimeJoints ? 2 : 4;
}

// The kernel: one window of kOwn waypoints a warp, blocks of kThreads.
template <class World, class Chain, class Par>
__global__ void __launch_bounds__(kThreads, grad_min_blocks<Chain>())
chomp_grad_kernel(const World world, const Chain chain,
                  const __grid_constant__ Par par,
                  const __grid_constant__ Shape s) {
  extern __shared__ float smem[];
  const float* P;
  if constexpr (Par::kStaged) {
    for (int i = threadIdx.x; i < s.n_params; i += kThreads)
      smem[i] = par.p[i];
    __syncthreads();
    P = smem;
  } else {
    P = par.v;
  }
  const int d = chain.d, nb = chain.nb;
  const int T = s.N + 2;
  const int n_pairs = s.B * T;
  const int w = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (w * kOwn >= n_pairs) return;                  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const int f = w * kOwn - kHalo + lane;
  const int fc = min(max(f, 0), n_pairs - 1);
  const int b = fc / T;
  const int t = fc - b * T;
  const bool own = lane >= kHalo && lane < kHalo + kOwn && f < n_pairs
                   && t >= 1 && t <= T - 2;
  // the waypoint's joints: Q0, a row of θ or QN
  const float* q;
  long long qs;
  if (t == 0) {
    q = s.q0 + b * s.q0_b;
    qs = s.q0_j;
  } else if (t == T - 1) {
    q = s.qn + b * s.qn_b;
    qs = s.qn_j;
  } else {
    q = s.theta + b * s.th_b + (t - 1) * s.th_n;
    qs = s.th_j;
  }
  float R[9], p[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = P[k];
  p[0] = P[9];
  p[1] = P[10];
  p[2] = P[11];
  const int body_base = 12 + 16 * d + d + 1;
  const auto dist = world.at(P + body_base + 4 * nb);
  // the lane's arrays start at zero (the aggregate's omitted members)
  GradLane<Walk<Chain>::kJoints, decltype(dist)> g{dist, P + body_base, s,
                                                    R, p, own, t, T};
  Walk<Chain>::walk(chain, P, q, qs, R, p, g);
  if (own) {
    const size_t o = ((size_t)b * s.N + (t - 1)) * d;
#pragma unroll
    for (int k = 0; k < d; ++k)
      s.out[o + k] = __fadd_rn(__fmul_rn(s.w_obs, g.g[k]),
                               __fmul_rn(s.w_smooth, s.smooth[o + k]));
  }
}

// launch(Counts, Par) on the parameters' route, as rollout_common.cuh
// with_params, with the counts this library was built for on the blocks:
// one instantiation a route.
template <class F>
int with_built_params(const float* params, int n_params, int host_params,
                      F launch) {
  using Built = rollout::Counts<CHOMP_GRAD_NS, CHOMP_GRAD_NX>;
  if (!host_params)
    return launch(rollout::Counts<kAny, kAny>{}, rollout::ParamPtr{params});
  if (n_params <= rollout::kParamFloats) {
    rollout::ParamBlock block;
    rollout::fill_block(block, params, n_params);
    return launch(Built{}, block);
  }
  if (n_params > rollout::kLargeParamFloats) return (int)cudaErrorInvalidValue;
  rollout::LargeParamBlock block;
  rollout::fill_block(block, params, n_params);
  return launch(Built{}, block);
}

// Launches the kernel over the B·(N + 2) waypoints, or with a non-null
// `resident` loads it and writes its resident blocks per SM instead.
template <class Kernel, class... Args>
int launch(Kernel kernel, int staged, const Shape& s, void* stream,
           int* resident, Args&&... args) {
  const size_t smem = (size_t)staged * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (resident != nullptr) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         kThreads, smem);
  }
  const long long windows = ((long long)s.B * (s.N + 2) + kOwn - 1) / kOwn;
  const long long blocks = (windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      args..., s);
  return cudaGetLastError();
}

}  // namespace

// world_kind: 0 an AnalyticWorld (its primitives in params), 1 a GridSDF,
// 2 a CompositeWorld (the overlay's primitives in params); the library's
// CHOMP_GRAD_GRID, NS and NX must match it. params: the
// packed parameters of kernels/rollout.py pack_params (robot, world), a
// host pointer to n_params floats when host_params is 1, else a device
// pointer (the memory path). The grid: dense grid, packed corner table
// (32-byte aligned rows, or null), X, Y, Z, hi[3]; unused for an analytic
// world. d, nb and skip_rotf must match the library's chain
// (rollout_common.cuh with_chain); the runtime chain takes at most
// kRuntimeJoints joints. With a non-null `resident` nothing is launched:
// the kernel the launch would take is loaded and its resident blocks per
// SM written there.
extern "C" int chomp_grad_launch(
    const float* theta, const float* q0, const float* qn, const float* smooth,
    float* out, long long th_b, long long th_n, long long th_j,
    long long q0_b, long long q0_j, long long qn_b, long long qn_j,
    const float* params, int n_params, int host_params, const float* grid,
    const float* packed, int X, int Y, int Z, float hi0, float hi1,
    float hi2, int world_kind, int B, int N, int d, int nb, int ns, int nx,
    int skip_rotf, float dt, float two_dt, float eps, float half_eps,
    float den, float quad_den, float ridge, float w_obs, float w_smooth,
    int curvature, int pinv, void* stream, int* resident) {
  const Shape s{theta, q0,   qn,   smooth, out,  th_b,     th_n,
                th_j,  q0_b, q0_j, qn_b,   qn_j, B,        N,
                n_params, dt, two_dt, eps, half_eps, den, quad_den,
                ridge, w_obs, w_smooth, curvature, pinv};
  constexpr int kFits = CHOMP_GRAD_GRID ? kOverlayFloats : kAnalyticFloats;
  static_assert(CHOMP_GRAD_NS == kAny
                    ? CHOMP_GRAD_NX == kAny
                    : CHOMP_GRAD_NS >= 0 && CHOMP_GRAD_NX >= 0 &&
                          4 * CHOMP_GRAD_NS + 6 * CHOMP_GRAD_NX <= kFits,
                "counts compiled in must fit the kernel's budget");
  if (world_kind < 0 || world_kind > 2 ||
      (world_kind != 0) != (CHOMP_GRAD_GRID != 0))
    return cudaErrorInvalidValue;
  if (CHOMP_GRAD_NS != kAny && (ns != CHOMP_GRAD_NS || nx != CHOMP_GRAD_NX))
    return cudaErrorInvalidValue;
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    using Chain = decltype(chain);
    if (d > Walk<Chain>::kJoints) return (int)cudaErrorInvalidValue;
    return with_built_params(
        params, n_params, host_params, [&](auto k, const auto& par) {
          using K = decltype(k);
          using Par = std::decay_t<decltype(par)>;
#if CHOMP_GRAD_GRID
          using World = GridGrad<K::ns, K::nx>;
          const GridDims dims{grid, reinterpret_cast<const float4*>(packed),
                              X, Y, Z, hi0, hi1, hi2};
          const World world{dims, ns, nx, world_kind == 2 ? 1 : 0};
#else
          using World = AnalyticGrad<K::ns, K::nx>;
          const World world{ns, nx};
#endif
          return launch(chomp_grad_kernel<World, Chain, Par>,
                        Par::kStaged ? n_params : 0, s, stream, resident,
                        world, chain, par);
        });
  });
}

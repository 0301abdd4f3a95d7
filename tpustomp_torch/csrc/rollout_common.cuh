// Shared skeleton of the fused rollout evaluators for Hopper (sm_90a):
// rollout_analytic.cu (sphere/box worlds) and rollout_grid.cu (voxel grid,
// optionally with a sphere/box overlay). Both are this one template,
// evaluate<World, Chain, Par>, with a different distance policy; the Chain
// policy walks the robot's joints (see "Joint chains" below) and Par says
// where the launch-uniform parameters live.
//
// Per candidate trajectory c and waypoint t it computes forward kinematics
// down the joint chain, the world position of every sphere body, the signed
// distance of each body's center under the World policy, the CHOMP
// potential of (dist - radius - clearance) times the body's workspace speed
// (central difference over t, one-sided at both ends), and writes
//     q_obs[t, c]            = dt * sum_b potential_b(t) * speed_b(t)
//     margin_part[slab, c]   = min over b and this slab's t of dist_b - radius_b
// and, when the caller passes an ee buffer (the TPU kernel's ee_out), the
// last joint's frame per waypoint, 12 planes of [T, C]:
//     ee[k, t, c]  k = 0..2 position, k = 3..11 rotation (row-major)
// or, when it passes a q_con buffer (the constraint route), the Cartesian
// constraints' cost on that frame, one plane of [T, C]:
//     q_con[t, c]  = sum over the n_con constraints of weight * excess^2
// Numerics follow tpustomp_torch/costs/obstacle.py (the plain version the
// kernels are held to): accurate sincosf/sqrtf and IEEE division (no fast
// math); nvcc's default FMA contraction moves results by about 1 ULP per
// composed joint. No tensor cores: each (candidate, waypoint) is a chain of
// 3x3 fp32 products, far below wgmma's 64-row tile, and TF32 would break
// the 1e-5 tolerance.
//
// What bounds it: instruction issue. Each (candidate, waypoint) is a serial
// chain of d frame products and nb distances (~2,000 instructions on
// arm_7dof), so the schedulers' issue slots are the scarce resource, and
// every lane that computes an FK nobody reads, and every operand fetched by
// its own instruction, costs them. The design:
//   * Lane plan (kernels/rollout.py _plan, replayed on the CPU by
//     tests/test_torch_segments.py). A block holds `cpb` consecutive
//     candidates (1..kMaxCands) and one slab of the waypoint axis (one slab
//     unless the tile would not fit: long trajectories).
//     Its active candidates' waypoints are laid end to end, candidate-major,
//     with the slab's halo waypoints (t_lo - 1 and t_hi, where they exist)
//     in place: n_seq rows a candidate. Warps take windows of that flat
//     sequence in turn: window k puts flat position 30k - 1 + l on lane l,
//     lanes 1..30 are its core and lanes 0 and 31 the halo (each computed
//     again as a neighbouring window's core). A core lane owns its waypoint
//     when it lies in [t_lo, t_hi). Its neighbours t - 1 and t + 1 are the
//     adjacent lanes (__shfl_up/down_sync): a candidate boundary inside a
//     window needs no halo, because t = 0 and t = T - 1 take one-sided
//     differences toward their own candidate. The wrapper picks cpb so
//     that the block's windows fill whole rounds of its 8 warps (a warp
//     that idles in the last round still holds its registers): at T = 102
//     7 candidates are 24 windows, 3 rounds, 1.076 lane slots per owned
//     waypoint, against 1.255 for the segment plan this replaced and for 8
//     candidates (28 windows: half the warps idle in the 4th round); at
//     T = 52 9 candidates, 16 windows, 1.094 against 1.231. With the ee
//     frame it takes at least 8 (8 at T = 102, 9 at T = 52), so the
//     frame's 12 planes go out in rows of mostly whole 32-byte sectors;
//     the constraint route plans as without ee.
//   * Activity skip: the lanes go over the block's active candidates only
//     (a ballot of the mask), so masked rows cost no FK; they are written
//     as zeros.
//   * Staging: the block's [d, rows, cpb] joint tile comes into shared
//     memory, and q_obs, ee and the per-waypoint margins go out through the
//     same kind of staging; a warp then min-reduces each candidate's margin
//     over the slab. The tile is read from either layout the callers hold
//     (Shape::cand_major), by the same loop with the layout's strides: the
//     time-major [d, T, C], a warp's loads then rows of cpb consecutive
//     candidates; or the candidate-major [C, T, d] (the TPU's K4, every
//     _evaluate of the solver), a warp's loads then about 5 rows of each of
//     cpb candidates, each row d contiguous floats, so the first joint's
//     load touches about 2 sectors a candidate and the other d - 1 joints
//     hit the same L1 lines: every byte comes from device memory once, and
//     no copy kernel runs before the launch. Everything after the stage is
//     the same, so the results are bitwise those of the time-major launch
//     on the same candidates. A stage that read each candidate's contiguous
//     run (n_seq * d floats) by consecutive threads and stored it
//     transposed was built first: its second loop tipped two 80-register
//     instantiations of the URDF chain into an 18-byte spill, in each of
//     four arrangements (out of line, its Shape argument put a 120-byte
//     stack frame in every kernel). Vector or 1-D bulk loads do not fit
//     either layout: a candidate's run starts at ((c0 + c) * T + a) * d
//     floats, 16-byte aligned for no fixed share of the candidates.
//   * Launch-uniform data in the constant bank (Par = ParamBlock): the
//     robot's parameters and a shared world's primitives are a
//     __grid_constant__ kernel parameter of kParamFloats floats, filled on
//     the host (kernels/rollout.py _launch_params: from the host mirrors of
//     the robot and world, or for a set without them from one read of its
//     device-packed vector per set of tensors and versions, at the set's
//     second launch), so FFMA reads
//     joint offsets, fixed rotations, body offsets and radii, and box or
//     sphere primitives as constant-bank operands: no shared-memory load
//     and no register for them. A set above kParamFloats and within
//     kLargeParamFloats (a robot of about 150 bodies or more, a world of
//     about 100 boxes) takes Par = LargeParamBlock, the same by-value
//     parameter at the 32 KB that CUDA 12.1+ allows, with the world's
//     counts compiled in as on the 3 KB block (with_params); the main
//     paths keep the 3 KB block, so their launches copy no larger payload.
//     Par = ParamPtr, the memory path, is left to sets above the large
//     block, to tensors moved under torch.inference_mode() (no version
//     counter, so no read may be cached) and to the first launch of a set
//     without host copies (no host sync for a set used once): the
//     parameters are staged once per block in shared memory, with the
//     world's counts read at run time.
//   * Per-row worlds (RowPrims): a row within the kernel's budget
//     (with_register_counts) is staged per block in shared memory, one row
//     a candidate column, and read with its counts compiled in (a window
//     may span two rows); a larger row is read from global memory at every
//     use. Holding the row in registers, as the segment plan did, took 16
//     of them and with the window loop's state cost a block of residency.
//   * __launch_bounds__ min-blocks per instantiation (kernel_min_blocks),
//     measured with ptxas: 4 (64 registers) where the kernel fits them
//     without a spill, 3 where it does not (worlds of run-time counts,
//     empty worlds, chains with fixed rotations or more than 7 joints).
//     The memory path's staged pointer costs no block of its own (no spill
//     at 80 registers, nvcc 12.9; it took one before, 72-93 registers).
//   * ee is the (R, p) in registers after the joint loop, before ee_offset
//     (the position constraint applies it): 48 bytes of stores per
//     (candidate, waypoint) and no arithmetic, so q_obs and margin are the
//     same with or without it.
//   * The constraint route (constraint_cost below) is what the ee frame's
//     one consumer, the solver's constraint tail (costs/constraints.py
//     constraint_cost_tm), computes from it, run on the (R, p) still in
//     registers: one plane of 4 bytes per (candidate, waypoint) goes out
//     instead of twelve, the block stages 3 planes instead of 14 (so the
//     lane plan and residency are those without ee), and the tail's ~30
//     elementwise passes over [T, C] are gone from the solver's loop. Its
//     arithmetic runs after the costs' and touches none of their
//     registers, so q_obs and margin are again the same with or without it.
// The arithmetic per (candidate, waypoint) is the segment plan's, operation
// for operation and body for body, so q_obs and margin are bitwise those of
// the kernels this replaced. cp.async / TMA for the joint tile is not used:
// it is 164 MB at config 4's shape, ~0.05 ms at 3.35 TB/s of a ~1 ms launch.
// Bodies must be link-sorted (the wrapper sorts robots that are not).
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
// Packed parameter layout (float32; kernels/rollout.py pack_params on the
// device, _host_params on the host):
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
//   the last kConFloats*n_con floats: the constraint section (constraint
//     route only), kConFloats per constraint: type (0 orientation, 1
//     position), a[3], b[3], tolerance, weight; an orientation constraint's
//     a is its axis_local and b its target_world, a position constraint's
//     a is the robot's ee_offset and b its target_world.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace rollout {

constexpr int kWarp = 32;              // lanes: one (candidate, waypoint) each
constexpr int kWarps = 8;              // warps a block
constexpr int kBlock = kWarp * kWarps;
constexpr int kCore = kWarp - 2;       // owned lanes a window: a halo each side
constexpr int kMaxCands = 16;          // candidates a block at most
constexpr int kParamFloats = 768;      // the parameter block: 3 KB, within
                                       // the classic 4 KB of kernel parameters
constexpr int kLargeParamFloats = 7936;  // the large block: 31 KB, within
                                       // the 32,764 bytes of CUDA 12.1+ with
                                       // ~1 KB left for the other parameters
constexpr int kAny = -1;               // a primitive count known at run time
constexpr int kRowFloats = 16;         // a staged per-row world, at most
constexpr int kConFloats = 9;          // a constraint in the parameters
constexpr float kBig = 1e6f;           // empty-set distance, as the reference
constexpr unsigned kFull = 0xffffffffu;

struct Deref {                         // constant bank, registers or shared
  __device__ __forceinline__ float operator()(const float* p) const {
    return *p;
  }
};
struct ReadOnly {                      // global memory through the L1 path
  __device__ __forceinline__ float operator()(const float* p) const {
    return __ldg(p);
  }
};

// ---- Where the parameters live ---------------------------------------------
// bind(smem, n) returns the pointer the block reads its parameters through;
// a staged policy copies them into smem (the caller synchronises).

// The robot and a shared world's primitives, by value: a __grid_constant__
// kernel parameter of N floats, read as constant-bank operands.
template <int N>
struct ParamArray {
  static constexpr int kFloats = N;
  float v[N];
  static constexpr bool kStaged = false;
  __device__ __forceinline__ const float* bind(float*, int) const {
    return v;
  }
};
// The main paths' block (3 KB), and the large block (31 KB) for a set
// above it: one launch copies its whole parameter, so the main paths keep
// the small one.
struct ParamBlock : ParamArray<kParamFloats> {};
struct LargeParamBlock : ParamArray<kLargeParamFloats> {};

// The memory path: n parameters in device memory, staged once per block.
struct ParamPtr {
  const float* p;
  static constexpr bool kStaged = true;
  __device__ __forceinline__ const float* bind(float* smem, int n) const {
    for (int i = threadIdx.x; i < n; i += kBlock) smem[i] = p[i];
    return smem;
  }
};

// ---- Worlds of spheres and boxes --------------------------------------------

// Min signed distance to ns spheres (S: 4 floats each, center[3] and
// radius) and nx boxes (X: 6 floats each, center[3] and half[3]); kBig
// when there are none. NS and NX are the counts at compile time (the loops
// unroll, so S and X may be register arrays or constant-bank offsets) or
// kAny (the run-time ns, nx); Load says how S and X are read. The
// arithmetic is the same for every instantiation and every kind of world.
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

// A primitive set read through Load at every use: from the constant bank
// (a shared world in the parameter block), shared memory (a staged row, the
// memory path) or global memory (a per-row world above the budget).
template <int NS, int NX, class Load>
struct PrimsAt {
  const float* S;
  int ns;
  const float* X;
  int nx;
  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    return primitives_dist<NS, NX>(Load{}, S, ns, X, nx, x0, x1, x2);
  }
};

// __launch_bounds__ min-blocks (resident blocks of 256 threads an SM), set
// from ptxas -v: 4 (64 registers) when the world and the chain each fit it
// (kMinBlocks 4), one block fewer for each that does not (kMinBlocks 3):
// every instantiation built for arm_7dof, the URDF torso arm and the
// runtime chain then has no spill. A world of compiled counts fits 4;
// run-time counts and the empty world do not. Where the parameters live
// costs no block (the memory path's staged pointer fits, nvcc 12.9).
template <int NS, int NX>
constexpr int min_blocks() {
  return (NS == kAny || NS + NX == 0) ? 3 : 4;
}
template <class World, class Chain>
constexpr int kernel_min_blocks() {
  return 4 - (World::kMinBlocks < 4) - (Chain::kMinBlocks < 4);
}

// A world policy has stage(rows, c0, n_c), run by every thread of the
// block before the first __syncthreads (a per-row world copies its rows
// there), and at(W, c, row): candidate c's distance, with W the world
// section of the parameters and row its column's staged row.

// The shared primitive set in the world section W of the parameters (the
// counts compiled in where known, so every read is at a fixed offset).
template <int NS, int NX>
struct SharedPrims {
  static constexpr int kMinBlocks = min_blocks<NS, NX>();
  int ns, nx;
  // floats of primitives before what follows them in W
  __device__ __forceinline__ int floats() const {
    return NS == kAny ? 4 * ns + 6 * nx : 4 * NS + 6 * NX;
  }
  __device__ __forceinline__ void stage(float*, int, int) const {}
  __device__ __forceinline__ PrimsAt<NS, NX, Deref> at(const float* W, int,
                                                       const float*) const {
    return {W, ns, W + (NS == kAny ? 4 * ns : 4 * NS), nx};
  }
};

// Per-row primitive sets in global memory: spheres [rows, ns, 4], boxes
// [rows, nx, 6]; candidate c reads row c / per_row. Compiled counts stage
// each column's row in shared memory (kStaged floats: spheres, then boxes).
template <int NS, int NX>
struct RowPrims {
  static constexpr int kMinBlocks = min_blocks<NS, NX>();
  static constexpr int kStaged = NS == kAny ? 0 : 4 * NS + 6 * NX;
  static_assert(kStaged <= kRowFloats, "a staged row above kRowFloats");
  const float* spheres;
  const float* boxes;
  int ns, nx, per_row;
  __device__ __forceinline__ void stage(float* rows, int c0, int n_c) const {
    if constexpr (kStaged > 0) {
      for (int i = threadIdx.x; i < n_c * kStaged; i += kBlock) {
        const int col = i / kStaged, k = i % kStaged;
        const size_t r = (size_t)((c0 + col) / per_row);
        rows[col * kRowFloats + k] =
            k < 4 * NS ? spheres[r * 4 * NS + k]
                       : boxes[r * 6 * NX + k - 4 * NS];
      }
    }
  }
  __device__ __forceinline__ auto at(const float*, int c,
                                     const float* row) const {
    if constexpr (NS == kAny) {
      const size_t r = (size_t)(c / per_row);
      return PrimsAt<kAny, kAny, ReadOnly>{spheres + r * 4 * ns, ns,
                                           boxes + r * 6 * nx, nx};
    } else {
      return PrimsAt<NS, NX, Deref>{row, NS, row + 4 * NS, NX};
    }
  }
};

template <int NS, int NX>
struct Counts {
  static constexpr int ns = NS, nx = NX;
};

// launch(Counts<ns, nx>{}), the world's own counts compiled in, when its
// primitives fit in Floats (4 a sphere, 6 a box): one instantiation per
// such pair of counts (S, X walk them). launch(Counts<kAny, kAny>{}) for a
// larger world. Shared and per-row worlds take the same counts.
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

// launch(Counts, Par) for a launch whose parameters are on the host
// (host_params: n_params host floats, copied here into the by-value
// parameter) or in device memory (the memory path). Both blocks get the
// counts of with_register_counts: a robot above the 3 KB block on a world
// within the budget (a dual-arm or mobile robot on the tabletop) ran
// 1.3-1.6x slower on the large block at run-time counts (robots of 159,
// 210 and 489 bodies, C = 57,344 and 1,024, H100). The memory path (sets
// above the large block, tensors without a version counter, a set's first
// launch without host copies) gets the run-time counts: one instantiation
// a chain and world kind. The arithmetic per primitive is the same either
// way; only the loop over primitives is rolled.
template <class Block>
inline void fill_block(Block& block, const float* params, int n_params) {
  for (int i = 0; i < n_params; ++i) block.v[i] = params[i];
  for (int i = n_params; i < Block::kFloats; ++i) block.v[i] = 0.0f;
}
template <int Floats, class F>
inline int with_params(const float* params, int n_params, int host_params,
                       int ns, int nx, F launch) {
  if (!host_params) return launch(Counts<kAny, kAny>{}, ParamPtr{params});
  if (n_params <= kParamFloats) {
    ParamBlock block;
    fill_block(block, params, n_params);
    return with_register_counts<Floats>(
        ns, nx, [&](auto k) { return launch(k, block); });
  }
  if (n_params > kLargeParamFloats) return (int)cudaErrorInvalidValue;
  LargeParamBlock block;
  fill_block(block, params, n_params);
  return with_register_counts<Floats>(
      ns, nx, [&](auto k) { return launch(k, block); });
}

// ---- The launch's shape and buffers -----------------------------------------
struct Shape {
  const float* cand;            // [d, T, C], or [C, T, d] with cand_major
  const uint8_t* active;        // [C] or nullptr
  float* q_obs;                 // [T, C]
  float* margin_part;           // [n_slab, C]
  float* ee;                    // [12, T, C] or nullptr
  float* q_con;                 // [T, C] or nullptr: the constraint route
  int C, T, n_params, cpb, n_slab;
  int n_con;                    // constraints: the parameters' last section
  int cand_major;               // cand is candidate-major [C, T, d] (K4)
  float dt, clearance;
};

// Slab s of the waypoint axis: owned [t_lo, t_hi), rows [a, b) with the
// halo waypoints that exist; L = ceil(T / n_slab) owned a slab.
struct Slab {
  int t_lo, t_hi, a, n_seq, n_own;
  __host__ __device__ Slab(int T, int n_slab, int s) {
    const int L = (T + n_slab - 1) / n_slab;
    t_lo = s * L;
    t_hi = t_lo + L < T ? t_lo + L : T;
    a = t_lo > 0 ? t_lo - 1 : 0;
    const int b = t_hi + 1 < T ? t_hi + 1 : T;
    n_seq = b - a;
    n_own = t_hi - t_lo;
  }
};

// Shared memory of one block, in floats, for the largest slab (L owned
// rows and both halos): the staged parameters (memory path), the joint tile
// [d][cpb][n_seq], the cost and margin rows [cpb][opitch], the staged
// per-row worlds [kMaxCands][kRowFloats], the active slots and mask, then
// with ee the frame [12][cpb][opitch] and with the constraint route the
// q_con rows [cpb][opitch] (opitch = n_own | 1: odd, few bank conflicts).
// kernels/rollout.py _smem_floats is the same.
inline size_t smem_floats(int staged_params, int d, int cpb, int T,
                          int n_slab, bool ee, bool con) {
  const int L = (T + n_slab - 1) / n_slab;
  const size_t n_seq = n_slab == 1 ? T : (L + 2 < T ? L + 2 : T);
  const size_t opitch = L | 1;
  return (size_t)((staged_params + 31) & ~31) + (size_t)d * cpb * n_seq
         + (2 + (ee ? 12 : 0) + (con ? 1 : 0)) * cpb * opitch
         + kMaxCands * kRowFloats + kMaxCands + 2;
}

// ---- Joint chains -----------------------------------------------------------
// A chain's walk(P, q_of, stride, R, p, body) runs the FK of one waypoint
// from the base frame (R, p): for each joint j it moves the frame to the
// joint's origin, applies the joint's motion at q_of[j * stride], then
// calls body(b) for each body b on that joint with the frame live. It has d, nb and skip_rotf (every fixed
// rotation is the identity: R·RotFixed skipped).

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
  static constexpr int kMinBlocks = 4;
  int d, nb, skip_rotf;

  template <class Body>
  __device__ __forceinline__ void walk(const float* P, const float* q_of,
                                       int stride, float (&R)[9],
                                       float (&p)[3], Body& body) const {
    const int body_start = 12 + 16 * d;
    for (int j = 0; j < d; ++j) {
      const float* J = P + 12 + 16 * j;
      joint_origin(J, skip_rotf, R, p);
      const float x = J[1], y = J[2], z = J[3];
      const float q = q_of[j * stride];
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
  // arm_7dof (7 joints, identity fixed rotations) fits 64 registers; a
  // chain with fixed rotations or more joints (the URDF torso arm) spills
  static constexpr int kMinBlocks = SkipRotf != 0 && d <= 7 ? 4 : 3;

  template <class Body>
  __device__ __forceinline__ void walk(const float* P, const float* q_of,
                                       int stride, float (&R)[9],
                                       float (&p)[3], Body& body) const {
    step<0, 0, Joints...>(P, q_of, stride, R, p, body);
  }

 private:
  template <int J, int B, class First, class... Rest, class Body>
  __device__ __forceinline__ static void step(const float* P,
                                              const float* q_of, int stride,
                                              float (&R)[9], float (&p)[3],
                                              Body& body) {
    const float* Jp = P + 12 + 16 * J;
    joint_origin(Jp, SkipRotf != 0, R, p);
    First::move(Jp, q_of[J * stride], R, p);
#pragma unroll
    for (int b = B; b < B + First::n_bodies; ++b) body(b);
    if constexpr (sizeof...(Rest) > 0)
      step<J + 1, B + First::n_bodies, Rest...>(P, q_of, stride, R, p,
                                                body);
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

// ---- The kernel body ---------------------------------------------------------

// One body of the current joint for one lane, with the joint's frame (R, p)
// live: body(b) puts the body in the world, reads its neighbours at t - 1
// and t + 1 from the adjacent lanes and, on an owning lane, adds
// potential x speed to the lane's sum and dist - radius to its margin.
template <class Dist>
struct BodyCost {
  const Dist& dist;
  const float* bodies;          // offset[3], radius per body
  const float (&R)[9];
  const float (&p)[3];
  bool own;
  int t, T;
  float inv_dt, inv_2dt, clearance;
  float& acc;
  float& margin;

  __device__ __forceinline__ void operator()(int b) const {
    const float* Bd = bodies + 4 * b;
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
    if (!own) return;
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
    const float d = dist(x0, x1, x2);
    const float radius = Bd[3];
    const float d_sig = d - radius - clearance;
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
    margin = fminf(margin, d - radius);
  }
};

// The constraint route: the summed cost of the n_con constraints in K
// (kConFloats each, the parameters' constraint section) at one waypoint's
// end-effector frame (R, p), in the operation order of the plain tail
// (costs/constraints.py _cost_from_frame):
//   orientation: ach = R·a, cos = clamp(ach·b, -1, 1),
//                excess = max(acos(cos) - tolerance, 0);
//   position:    rel = p + R·a - b, excess = max(sqrt(rel·rel) - tolerance, 0);
// each adds weight·excess², from 0 in the constraints' order. Every product,
// sum and difference is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), so on the same frame the route differs
// from the plain tail only by acosf against torch's arccos (a few ULP;
// sqrtf is IEEE-rounded in both).
__device__ __forceinline__ float dot3(float x0, float x1, float x2,
                                      float y0, float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                   __fmul_rn(x2, y2));
}

__device__ __forceinline__ float constraint_cost(const float* K, int n_con,
                                                 const float (&R)[9],
                                                 const float (&p)[3]) {
  float total = 0.0f;
  for (int k = 0; k < n_con; ++k) {
    const float* c = K + kConFloats * k;
    const float a0 = c[1], a1 = c[2], a2 = c[3];
    float excess;
    if (c[0] == 0.0f) {
      const float ach0 = dot3(R[0], R[1], R[2], a0, a1, a2);
      const float ach1 = dot3(R[3], R[4], R[5], a0, a1, a2);
      const float ach2 = dot3(R[6], R[7], R[8], a0, a1, a2);
      const float cosang =
          fminf(fmaxf(dot3(ach0, ach1, ach2, c[4], c[5], c[6]), -1.0f),
                1.0f);
      excess = fmaxf(__fsub_rn(acosf(cosang), c[7]), 0.0f);
    } else {
      float rel[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        rel[i] = __fsub_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(p[i], __fmul_rn(R[3 * i], a0)),
                                __fmul_rn(R[3 * i + 1], a1)),
                      __fmul_rn(R[3 * i + 2], a2)),
            c[4 + i]);
      const float dist = sqrtf(dot3(rel[0], rel[1], rel[2], rel[0], rel[1],
                                    rel[2]));
      excess = fmaxf(__fsub_rn(dist, c[7]), 0.0f);
    }
    total = __fadd_rn(total, __fmul_rn(c[8], __fmul_rn(excess, excess)));
  }
  return total;
}

// The kernel body; launched as a grid of (ceil(C / cpb), n_slab) blocks of
// kBlock threads. World is a policy with stage() and
//   __device__ Dist at(const float* W, int c, const float* row) const
// binding candidate c's distance once per window: Dist is callable as
// dist(x0, x1, x2), the signed distance at a body center. Chain is
// RuntimeChain or a StaticChain (with_chain); Par is ParamBlock,
// LargeParamBlock or ParamPtr (with_params).
template <class World, class Chain, class Par>
__device__ __forceinline__ void evaluate(const World& world,
                                         const Chain& chain, const Par& par,
                                         const Shape& s) {
  const int d = chain.d, nb = chain.nb;
  const int C = s.C, T = s.T, cpb = s.cpb;
  const Slab sl(T, s.n_slab, blockIdx.y);
  const int n_seq = sl.n_seq, n_own = sl.n_own, opitch = n_own | 1;
  extern __shared__ float smem[];
  float* tile = smem + (Par::kStaged ? (s.n_params + 31) & ~31 : 0);
  float* q_st = tile + d * cpb * n_seq;           // [cpb][opitch]
  float* m_st = q_st + cpb * opitch;              // [cpb][opitch]
  float* rows = m_st + cpb * opitch;              // [kMaxCands][kRowFloats]
  int* slots = reinterpret_cast<int*>(rows + kMaxCands * kRowFloats);
  float* ee_st = reinterpret_cast<float*>(slots + kMaxCands + 2);

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int c0 = blockIdx.x * cpb;
  const int n_c = min(cpb, C - c0);
  // the block's active candidates: slots[0..n_act) their columns, then
  // n_act and the mask
  if (warp == 0) {
    const bool act = lane < n_c
                     && (s.active == nullptr || s.active[c0 + lane]);
    const unsigned mask = __ballot_sync(kFull, act);
    if (act) slots[__popc(mask & ((1u << lane) - 1))] = lane;
    if (lane == 0) {
      slots[kMaxCands] = __popc(mask);
      slots[kMaxCands + 1] = (int)mask;
    }
  }
  const float* P = par.bind(smem, s.n_params);
  world.stage(rows, c0, n_c);
  // the joint tile [d][cpb][n_seq]: thread (r, cc) of the first
  // r_step * cpb loads rows r, r + r_step, .. of column cc for every
  // joint, element (j, t, c) of either layout at j * sj + t * st + c * sc
  const int cc = threadIdx.x % cpb;
  const int r0 = threadIdx.x / cpb, r_step = kBlock / cpb;
  const bool mine = r0 < r_step && cc < n_c
                    && (s.active == nullptr || s.active[c0 + cc]);
  if (mine) {
    const size_t sj = s.cand_major ? 1 : (size_t)T * C;
    const size_t st = s.cand_major ? d : C;
    const size_t sc = s.cand_major ? (size_t)T * d : 1;
    const float* src = s.cand + sl.a * st + (c0 + cc) * sc;
    for (int j = 0; j < d; ++j) {
      float* dst = tile + (j * cpb + cc) * n_seq;
      const float* sjp = src + j * sj;
      for (int r = r0; r < n_seq; r += r_step) dst[r] = sjp[r * st];
    }
  }
  __syncthreads();

  const int n_act = slots[kMaxCands];
  const int n_pairs = n_act * n_seq;
  const int n_win = (n_pairs + kCore - 1) / kCore;
  const int body_base = 12 + 16 * d + d + 1;
  const float* W = P + body_base + 4 * nb;
  const float inv_dt = 1.0f / s.dt;
  const float inv_2dt = 1.0f / (2.0f * s.dt);
  const int stride = cpb * n_seq;                  // one joint of the tile
  for (int w = warp; w < n_win; w += kWarps) {
    const int f = w * kCore - 1 + lane;
    const int fc = min(max(f, 0), n_pairs - 1);
    const int i = fc / n_seq;
    const int r = fc - i * n_seq;
    const int t = sl.a + r;
    const int slot = slots[i];
    const bool own = lane >= 1 && lane <= kCore && f < n_pairs
                     && t >= sl.t_lo && t < sl.t_hi;
    const auto dist = world.at(W, c0 + slot, rows + slot * kRowFloats);
    float R[9], p[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = P[k];
    p[0] = P[9]; p[1] = P[10]; p[2] = P[11];
    float acc = 0.0f, margin = kBig;
    BodyCost<decltype(dist)> body{dist, P + body_base, R, p, own, t, T,
                                  inv_dt, inv_2dt, s.clearance, acc,
                                  margin};
    chain.walk(P, tile + slot * n_seq + r, stride, R, p, body);
    if (own) {
      const int o = slot * opitch + (t - sl.t_lo);
      q_st[o] = acc * s.dt;
      m_st[o] = margin;
      if (s.ee != nullptr) {
        float* e = ee_st + o;
        const int plane = cpb * opitch;
#pragma unroll
        for (int k = 0; k < 3; ++k) e[k * plane] = p[k];
#pragma unroll
        for (int k = 0; k < 9; ++k) e[(3 + k) * plane] = R[k];
      }
      if (s.q_con != nullptr) {
        // the constraint section ends the parameters; q_con's rows follow
        // the frame's (none without ee). Both pointers are formed here,
        // not before the loop, where they held registers across the walk
        // and made a runtime-chain composite instantiation spill.
        const float* K = P + s.n_params - kConFloats * s.n_con;
        float* c_st = ee_st + (s.ee != nullptr ? 12 * cpb * opitch : 0);
        c_st[o] = constraint_cost(K, s.n_con, R, p);
      }
    }
  }
  __syncthreads();

  // the owned rows, cpb candidates a row; inactive columns are zeros
  const size_t plane = (size_t)T * C;
  const float* c_st = ee_st + (s.ee != nullptr ? 12 * cpb * opitch : 0);
  if (r0 < r_step && cc < n_c) {
    for (int r = r0; r < n_own; r += r_step) {
      const size_t o = (size_t)(sl.t_lo + r) * C + c0 + cc;
      const int so = cc * opitch + r;
      s.q_obs[o] = mine ? q_st[so] : 0.0f;
      if (s.ee != nullptr)
        for (int k = 0; k < 12; ++k)
          s.ee[k * plane + o] = mine ? ee_st[k * cpb * opitch + so] : 0.0f;
      if (s.q_con != nullptr) s.q_con[o] = mine ? c_st[so] : 0.0f;
    }
  }
  // warp w: the margins over the slab of candidates c0 + w, c0 + w + 8, ..
  for (int col = warp; col < n_c; col += kWarps) {
    const bool act = (slots[kMaxCands + 1] >> col) & 1;
    float m = kBig;
    if (act)
      for (int r = lane; r < n_own; r += kWarp)
        m = fminf(m, m_st[col * opitch + r]);
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2)
      m = fminf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0)
      s.margin_part[(size_t)blockIdx.y * C + c0 + col] = act ? m : 0.0f;
  }
}

// Checks the plan (cpb in [1, kMaxCands]; n_slab slabs of L =
// ceil(T / n_slab) owned waypoints, none empty) and
// opts the kernel in to its shared memory above 48 KB
// (cudaFuncSetAttribute); returns a cudaError_t.
template <class Kernel>
inline int prepare(Kernel kernel, size_t smem, const Shape& s) {
  if (s.cpb < 1 || s.cpb > kMaxCands || s.n_slab < 1 || s.n_slab > s.T)
    return (int)cudaErrorInvalidValue;
  const int L = (s.T + s.n_slab - 1) / s.n_slab;
  if ((s.T + L - 1) / L != s.n_slab) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches kernel<<<(ceil(C / cpb), n_slab), kBlock>>> with the shared
// memory of its plan; returns a cudaError_t. With a non-null `resident` it
// launches nothing and writes the kernel's resident blocks per SM at that
// shared memory instead (cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// kernels/rollout.py rollout_occupancy).
template <class Kernel, class... Args>
inline int launch_plan(Kernel kernel, int staged_params, int d,
                       const Shape& s, void* stream, int* resident,
                       Args&&... args) {
  if (s.C <= 0) return 0;
  const size_t smem = smem_floats(staged_params, d, s.cpb, s.T, s.n_slab,
                                  s.ee != nullptr, s.q_con != nullptr)
                      * sizeof(float);
  const int err = prepare(kernel, smem, s);
  if (err != 0) return err;
  if (resident != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, kernel, kBlock, smem);
  const dim3 grid((s.C + s.cpb - 1) / s.cpb, s.n_slab);
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(args..., s);
  return (int)cudaGetLastError();
}

}  // namespace rollout

// Fused rollout evaluator for voxel-grid worlds (GridSDF) and grid + analytic
// overlay worlds (CompositeWorld), for Hopper (sm_90a).
//
// Replaces, as one kernel, the hybrid grid path of
// tpustomp/kernels/rollout_pallas.py:
//   K5  build_unrolled_kernel(mode="kin"), pallas_call at :770, which writes
//       body positions and speeds as a [B, 4, C, T] tensor, followed by its
//       XLA tail _grid_finish (:807-862: trilinear gather, potential,
//       reductions);
//   K2  build_kinematics_kernel, pallas_call at :325 — the same for robots
//       whose bodies are not link-sorted (the wrapper sorts them; their
//       parameters travel as rollout_analytic.cu says for K1);
//   K5 followed by _grid_finish's per_cand branch (:818-829; the wrapper
//       pads the overlay at :949-954) — a CompositeWorld whose overlay has
//       one set of spheres/boxes per scenario (batched MPC over a voxel
//       scene): rollout_grid_rows_launch below. Its overlay rows are read
//       as rollout_analytic.cu's per-row worlds are (rollout_common.cuh
//       RowPrims); the grid stays shared.
// Both entry points also write the end-effector frame when given an ee
// buffer, or the constraints' cost when given a q_con buffer (the
// constraint route, rollout_common.cuh). The TPU's grid path has no such
// output (the JAX package runs a second, vmapped FK for constraints over
// voxel worlds); here the frame, and the constraints' cost on it, come out
// of the same FK.
// The TPU split exists only because Mosaic has no arbitrary gather; here the
// trilinear sample sits inside the fused loop of rollout_common.cuh, and no
// [B, 4, C, T] intermediate exists.
//
// The distance at a body center follows world/sdf.py:_grid_sample in
// float32, step by step: g = (p - origin) / resolution with IEEE division
// (floor decides the cell, so no fast math), clip to [0, shape - 1.000001]
// (the upper bound is computed by the wrapper in float32, as the
// reference), cell index clip(floor(g), 0, shape - 2), f = g - index, then
// interpolation along z, then y, then x. A composite world then takes the
// min with the overlay's spheres and boxes.
//
// What bounds it on the H100: instruction issue, as rollout_analytic.cu,
// plus the gather. Per (candidate, waypoint) the FK chain is the analytic
// kernel's, and each body adds a trilinear sample: three IEEE divisions,
// the cell arithmetic and the corner loads. At config 4's shape (C =
// 57,344, T = 102, 12 bodies) a launch takes 70M samples; at config 5's
// (C = 210,000, T = 52) 131M. From the dense grid a sample is eight
// scattered 4-byte loads over 4 sectors of 32 bytes. The GridSDF's packed
// corner table ([X*Y*Z, 8], world/sdf.py, the layout the JAX package's grid
// tail reads) holds a cell's 8 corners in one 32-byte row, so a sample is
// one sector and two 16-byte loads: 4x fewer L1/L2 sectors. The table (7.9
// MB for the 64x80x48 tabletop) stays resident in the 50 MB L2. The kernel
// reads the table when the grid has one and the dense grid otherwise
// (pack=False); the corner values and the arithmetic are the same, so the
// two agree bit for bit. Hardware texture filtering is not used: its 8-bit
// fractional weights cannot meet the 1e-6 margin tolerance. The skeleton's
// lane plan and parameter block cut the issued instructions as for the
// analytic kernel (the grid's origin and resolution are constant-bank
// operands). Issuing two bodies' table loads before consuming either (to
// overlap their L2 round trips) was measured and dropped: the held corners
// took the kernel from 63 to 156-209 registers and one block an SM
// (PERF.md).

#include "rollout_common.cuh"

namespace {

// Trilinear sample of the shared grid.
struct GridSample {
  const float* grid;                // [X, Y, Z] row-major, on the device
  const float4* packed;             // [X*Y*Z, 8] as 2 float4 a row, or null
  int X, Y, Z;
  float hi0, hi1, hi2;              // shape - 1.000001, in float32
  const float* G;                   // origin[3], resolution: parameters

  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    const float res = G[3];
    float g0 = (x0 - G[0]) / res;
    float g1 = (x1 - G[1]) / res;
    float g2 = (x2 - G[2]) / res;
    g0 = fminf(fmaxf(g0, 0.0f), hi0);
    g1 = fminf(fmaxf(g1, 0.0f), hi1);
    g2 = fminf(fmaxf(g2, 0.0f), hi2);
    const int i0 = min(max((int)floorf(g0), 0), X - 2);
    const int i1 = min(max((int)floorf(g1), 0), Y - 2);
    const int i2 = min(max((int)floorf(g2), 0), Z - 2);
    const float fx = g0 - (float)i0;
    const float fy = g1 - (float)i1;
    const float fz = g2 - (float)i2;
    const int base = (i0 * Y + i1) * Z + i2;
    float c000, c001, c010, c011, c100, c101, c110, c111;
    if (packed != nullptr) {
      // corners (dx, dy, dz), dz fastest
      const float4 a = __ldg(packed + 2 * (size_t)base);
      const float4 b = __ldg(packed + 2 * (size_t)base + 1);
      c000 = a.x; c001 = a.y; c010 = a.z; c011 = a.w;
      c100 = b.x; c101 = b.y; c110 = b.z; c111 = b.w;
    } else {
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
    const float c00 = c000 * (1.0f - fz) + c001 * fz;
    const float c01 = c010 * (1.0f - fz) + c011 * fz;
    const float c10 = c100 * (1.0f - fz) + c101 * fz;
    const float c11 = c110 * (1.0f - fz) + c111 * fz;
    const float c0 = c00 * (1.0f - fy) + c01 * fy;
    const float c1 = c10 * (1.0f - fy) + c11 * fy;
    return c0 * (1.0f - fx) + c1 * fx;
  }
};

struct GridDims {
  const float* grid;
  const float4* packed;
  int X, Y, Z;
  float hi0, hi1, hi2;
  // G: origin[3], resolution in the parameters
  __device__ __forceinline__ GridSample at(const float* G) const {
    return GridSample{grid, packed, X, Y, Z, hi0, hi1, hi2, G};
  }
};

// Overlays of up to 4 floats (one sphere) run with their counts compiled
// in: a per-row overlay's row staged in shared memory, a shared overlay at
// fixed offsets of the parameters. Larger overlays loop to their run-time
// counts.
constexpr int kRegisterFloats = 4;

// The grid sample, min-composed with the overlay for a composite world.
template <class Overlay>
struct GridPoint {
  GridSample sample;
  Overlay overlay;
  int composite;
  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    const float dist = sample(x0, x1, x2);
    if (!composite) return dist;
    return fminf(dist, overlay(x0, x1, x2));
  }
};

// A GridSDF, or a CompositeWorld whose overlay is in params (shared).
template <int NS, int NX>
struct GridDist {
  static constexpr int kMinBlocks = NS == rollout::kAny ? 3 : 4;
  GridDims dims;
  rollout::SharedPrims<NS, NX> prims;   // overlay (0, 0 for a grid)
  int composite;
  __device__ __forceinline__ void stage(float*, int, int) const {}
  __device__ __forceinline__ auto at(const float* W, int c,
                                     const float* row) const {
    auto overlay = prims.at(W, c, row);
    return GridPoint<decltype(overlay)>{dims.at(W + prims.floats()), overlay,
                                        composite};
  }
};

// A CompositeWorld with one overlay per row; params hold no primitives.
template <int NS, int NX>
struct GridRowDist {
  static constexpr int kMinBlocks = NS == rollout::kAny ? 3 : 4;
  GridDims dims;
  rollout::RowPrims<NS, NX> rows;
  __device__ __forceinline__ void stage(float* st, int c0, int n_c) const {
    rows.stage(st, c0, n_c);
  }
  __device__ __forceinline__ auto at(const float* W, int c,
                                     const float* row) const {
    auto overlay = rows.at(W, c, row);
    return GridPoint<decltype(overlay)>{dims.at(W), overlay, 1};
  }
};

template <class World, class Chain, class Par>
__global__ void __launch_bounds__(
    rollout::kBlock, rollout::kernel_min_blocks<World, Chain>())
rollout_grid_kernel(
    World world, Chain chain, const __grid_constant__ Par par,
    const rollout::Shape s) {
  rollout::evaluate(world, chain, par, s);
}

}  // namespace

// Both entry points take the grid as: dense grid, packed corner table (32-
// byte aligned rows, or null), X, Y, Z, hi[3]; and end with
// rollout_analytic.cu's tail.
extern "C" int rollout_grid_launch(
    const float* cand, const float* params, int n_params, int host_params,
    const float* grid, const float* packed, int X, int Y, int Z, float hi0,
    float hi1, float hi2, int composite, const uint8_t* active, float* q_obs,
    float* margin_part, float* ee, float* q_con, int C, int T, int d, int nb,
    int ns, int nx, int n_con, float dt, float clearance, int skip_rotf,
    int cpb, int n_slab, int cand_major, void* stream, int* resident) {
  const GridDims dims{grid, reinterpret_cast<const float4*>(packed), X, Y, Z,
                      hi0, hi1, hi2};
  const rollout::Shape s{cand,  active, q_obs, margin_part, ee,
                         q_con, C,      T,     n_params,    cpb,
                         n_slab, n_con, cand_major, dt, clearance};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_params<kRegisterFloats>(
        params, n_params, host_params, ns, nx, [&](auto k, const auto& par) {
          using K = decltype(k);
          using Par = std::decay_t<decltype(par)>;
          using World = GridDist<K::ns, K::nx>;
          return rollout::launch_plan(
              rollout_grid_kernel<World, decltype(chain), Par>,
              Par::kStaged ? n_params : 0, d, s, stream, resident,
              World{dims, {ns, nx}, composite}, chain, par);
        });
  });
}

// Overlay rows: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6].
extern "C" int rollout_grid_rows_launch(
    const float* cand, const float* params, int n_params, int host_params,
    const float* grid, const float* packed, int X, int Y, int Z, float hi0,
    float hi1, float hi2, const float* spheres, const float* boxes,
    int cands_per_row, const uint8_t* active, float* q_obs,
    float* margin_part, float* ee, float* q_con, int C, int T, int d, int nb,
    int ns, int nx, int n_con, float dt, float clearance, int skip_rotf,
    int cpb, int n_slab, int cand_major, void* stream, int* resident) {
  const GridDims dims{grid, reinterpret_cast<const float4*>(packed), X, Y, Z,
                      hi0, hi1, hi2};
  const rollout::Shape s{cand,  active, q_obs, margin_part, ee,
                         q_con, C,      T,     n_params,    cpb,
                         n_slab, n_con, cand_major, dt, clearance};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_params<kRegisterFloats>(
        params, n_params, host_params, ns, nx, [&](auto k, const auto& par) {
          using K = decltype(k);
          using Par = std::decay_t<decltype(par)>;
          using World = GridRowDist<K::ns, K::nx>;
          return rollout::launch_plan(
              rollout_grid_kernel<World, decltype(chain), Par>,
              Par::kStaged ? n_params : 0, d, s, stream, resident,
              World{dims, {spheres, boxes, ns, nx, cands_per_row}}, chain,
              par);
        });
  });
}

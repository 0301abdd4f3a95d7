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
//       whose bodies are not link-sorted (the wrapper sorts them);
//   K5 followed by _grid_finish's per_cand branch (:818-829; the wrapper
//       pads the overlay at :949-954) — a CompositeWorld whose overlay has
//       one set of spheres/boxes per scenario (batched MPC over a voxel
//       scene): rollout_grid_rows_launch below. Its overlay rows are read
//       as rollout_analytic.cu's per-row worlds are (rollout_common.cuh
//       RowPrims); the grid stays shared.
// Both entry points also write the end-effector frame when given an ee
// buffer (rollout_common.cuh). The TPU's grid path has no such output (the
// JAX package runs a second, vmapped FK for constraints over voxel worlds);
// here the frame comes out of the same FK.
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
// What bounds it on the H100: the gather. At the config-5 shape (C =
// 210,000, T = 52, 12 bodies) one launch takes 131M samples. From the
// dense grid a sample is eight scattered 4-byte loads over 4 sectors of
// 32 bytes. The GridSDF's packed corner table ([X*Y*Z, 8], world/sdf.py,
// the layout the JAX package's grid tail reads) holds a cell's 8 corners in
// one 32-byte row, so a sample is one sector and two 16-byte loads: 4x fewer
// L1/L2 sectors. The table (7.9 MB for the 64x80x48 tabletop) stays
// resident in the 50 MB L2. The kernel reads the table when the grid has
// one and the dense grid otherwise (pack=False); the corner values and the
// arithmetic are the same, so the two agree bit for bit. Hardware texture
// filtering is not used: its 8-bit fractional weights cannot meet the 1e-6
// margin tolerance.

#include "rollout_common.cuh"

namespace {

// Trilinear sample of the shared grid.
struct GridSample {
  const float* grid;                // [X, Y, Z] row-major, on the device
  const float4* packed;             // [X*Y*Z, 8] as 2 float4 a row, or null
  int X, Y, Z;
  float hi0, hi1, hi2;              // shape - 1.000001, in float32
  float o0, o1, o2, res;            // origin, resolution

  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    float g0 = (x0 - o0) / res;
    float g1 = (x1 - o1) / res;
    float g2 = (x2 - o2) / res;
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
  // G: origin[3], resolution in the staged parameters
  __device__ __forceinline__ GridSample at(const float* G) const {
    return GridSample{grid, packed, X, Y, Z, hi0, hi1, hi2,
                      G[0], G[1], G[2], G[3]};
  }
};

// The overlay primitives a warp holds in registers: one sphere (4 floats)
// keeps the kernel, whose grid sample holds its pointers, dimensions and
// origin in registers too, within 64 registers a thread (ptxas), so 4
// blocks of 256 threads stay resident per SM; 2 spheres and 2 boxes take 77
// registers and 3 blocks. Larger overlays are read from memory at every
// use.
constexpr int kRegisterFloats = 4;

// One warp's distance: the grid sample, min-composed with the overlay
// for a composite world.
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
  GridDims dims;
  rollout::SharedPrims<NS, NX> prims;   // overlay (0, 0 for a grid)
  int composite;
  __device__ __forceinline__ auto at(const float* W, int c) const {
    auto overlay = prims.at(W, c);
    return GridPoint<decltype(overlay)>{
        dims.at(W + 4 * prims.ns + 6 * prims.nx), overlay, composite};
  }
};

// A CompositeWorld with one overlay per row; params hold no primitives.
template <int NS, int NX>
struct GridRowDist {
  GridDims dims;
  rollout::RowPrims<NS, NX> rows;
  __device__ __forceinline__ auto at(const float* W, int c) const {
    auto overlay = rows.at(W, c);
    return GridPoint<decltype(overlay)>{dims.at(W), overlay, 1};
  }
};

template <class World, class Chain>
__global__ void __launch_bounds__(rollout::kBlock) rollout_grid_kernel(
    World world, Chain chain, const float* __restrict__ cand,
    const float* __restrict__ params, int n_params,
    const uint8_t* __restrict__ active, float* __restrict__ q_obs,
    float* __restrict__ margin_part, float* __restrict__ ee, int C, int T,
    float dt, float clearance, int seg_len) {
  rollout::evaluate(world, chain, cand, params, n_params, active, q_obs,
                    margin_part, ee, C, T, dt, clearance, seg_len);
}

template <class World, class Chain>
int launch(const World& world, const Chain& chain, const float* cand,
           const float* params, int n_params, const uint8_t* active,
           float* q_obs, float* margin_part, float* ee, int C, int T,
           float dt, float clearance, int seg_len, void* stream) {
  if (C <= 0) return 0;
  const size_t smem =
      rollout::smem_floats(n_params, chain.d, ee != nullptr) * sizeof(float);
  const int err =
      rollout::prepare(rollout_grid_kernel<World, Chain>, smem, seg_len);
  if (err != 0) return err;
  dim3 blocks((C + rollout::kCands - 1) / rollout::kCands,
              (T + seg_len - 1) / seg_len);
  rollout_grid_kernel<World, Chain><<<blocks, rollout::kBlock, smem,
                                      (cudaStream_t)stream>>>(
      world, chain, cand, params, n_params, active, q_obs, margin_part, ee,
      C, T, dt, clearance, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points take the grid as: dense grid, packed corner table (32-
// byte aligned rows, or null), X, Y, Z, hi[3]; and end with
// rollout_analytic.cu's tail.
extern "C" int rollout_grid_launch(
    const float* cand, const float* params, int n_params, const float* grid,
    const float* packed, int X, int Y, int Z, float hi0, float hi1,
    float hi2, int composite, const uint8_t* active, float* q_obs,
    float* margin_part, float* ee, int C, int T, int d, int nb, int ns,
    int nx, float dt, float clearance, int skip_rotf, int seg_len,
    void* stream) {
  const GridDims dims{grid, reinterpret_cast<const float4*>(packed), X, Y, Z,
                      hi0, hi1, hi2};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_register_counts<kRegisterFloats>(
        ns, nx, [&](auto k) {
          using K = decltype(k);
          return launch(GridDist<K::ns, K::nx>{dims, {ns, nx}, composite},
                        chain, cand, params, n_params, active, q_obs,
                        margin_part, ee, C, T, dt, clearance, seg_len,
                        stream);
        });
  });
}

// Overlay rows: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6].
extern "C" int rollout_grid_rows_launch(
    const float* cand, const float* params, int n_params, const float* grid,
    const float* packed, int X, int Y, int Z, float hi0, float hi1,
    float hi2, const float* spheres, const float* boxes, int cands_per_row,
    const uint8_t* active, float* q_obs, float* margin_part, float* ee, int C,
    int T, int d, int nb, int ns, int nx, float dt, float clearance,
    int skip_rotf, int seg_len, void* stream) {
  const GridDims dims{grid, reinterpret_cast<const float4*>(packed), X, Y, Z,
                      hi0, hi1, hi2};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_register_counts<kRegisterFloats>(
        ns, nx, [&](auto k) {
          using K = decltype(k);
          return launch(
              GridRowDist<K::ns, K::nx>{
                  dims, {spheres, boxes, ns, nx, cands_per_row}},
              chain, cand, params, n_params, active, q_obs, margin_part, ee,
              C, T, dt, clearance, seg_len, stream);
        });
  });
}

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
// What bounds it on the H100: the eight scattered 4-byte grid loads per
// (candidate, waypoint, body) — 70M samples, 560M loads per launch at the
// config-4 shape (C = 57,344, T = 102, 12 bodies) — not the FK. The dense
// grid (0.98 MB for the 64x80x48 tabletop) stays resident in the 50 MB L2;
// loads go through the read-only path (__ldg), and the two z-neighbours of
// each corner pair share a 32-byte sector. Hardware texture filtering is not
// used: its 8-bit fractional weights cannot meet the 1e-6 margin tolerance.

#include "rollout_common.cuh"

namespace {

// Trilinear sample of the shared grid; G points at origin[3], resolution.
struct GridSample {
  const float* grid;                // [X, Y, Z] row-major, on the device
  int X, Y, Z;
  float hi0, hi1, hi2;              // shape - 1.000001, in float32
  const float* G;

  __device__ __forceinline__ float operator()(float x0, float x1,
                                              float x2) const {
    float g0 = (x0 - G[0]) / G[3];
    float g1 = (x1 - G[1]) / G[3];
    float g2 = (x2 - G[2]) / G[3];
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
    const int sy = Z, sx = Y * Z;
    const float c000 = __ldg(grid + base);
    const float c001 = __ldg(grid + base + 1);
    const float c010 = __ldg(grid + base + sy);
    const float c011 = __ldg(grid + base + sy + 1);
    const float c100 = __ldg(grid + base + sx);
    const float c101 = __ldg(grid + base + sx + 1);
    const float c110 = __ldg(grid + base + sx + sy);
    const float c111 = __ldg(grid + base + sx + sy + 1);
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
  int X, Y, Z;
  float hi0, hi1, hi2;
  __device__ __forceinline__ GridSample at(const float* G) const {
    return GridSample{grid, X, Y, Z, hi0, hi1, hi2, G};
  }
};

// One thread's distance: the grid sample, min-composed with the overlay
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
struct GridDist {
  GridDims dims;
  int ns, nx;                       // overlay primitives (0, 0 for a grid)
  int composite;
  __device__ __forceinline__ GridPoint<rollout::Prims<rollout::SharedLoad>>
  at(const float* W, int) const {
    return {dims.at(W + 4 * ns + 6 * nx), rollout::shared_prims(W, ns, nx),
            composite};
  }
};

// A CompositeWorld with one overlay per row; params hold no primitives.
struct GridRowDist {
  GridDims dims;
  rollout::RowPrims rows;
  __device__ __forceinline__ GridPoint<rollout::Prims<rollout::ReadOnlyLoad>>
  at(const float* W, int c) const {
    return {dims.at(W), rows.at(c), 1};
  }
};

template <class World>
__global__ void __launch_bounds__(rollout::kBlock) rollout_grid_kernel(
    World world, const float* __restrict__ cand,
    const float* __restrict__ params, int n_params,
    const uint8_t* __restrict__ active, float* __restrict__ q_obs,
    float* __restrict__ margin_part, int C, int T, int d, int nb, float dt,
    float clearance, int skip_rotf, int t_chunk) {
  rollout::evaluate(world, cand, params, n_params, active, q_obs,
                    margin_part, C, T, d, nb, dt, clearance, skip_rotf,
                    t_chunk);
}

template <class World>
int launch(const World& world, const float* cand, const float* params,
           int n_params, const uint8_t* active, float* q_obs,
           float* margin_part, int C, int T, int d, int nb, float dt,
           float clearance, int skip_rotf, int t_chunk, void* stream) {
  if (C <= 0) return 0;
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  const size_t smem = rollout::smem_bytes(n_params, nb);
  const int err = rollout::allow_smem(rollout_grid_kernel<World>, smem);
  if (err != 0) return err;
  dim3 blocks((C + rollout::kBlock - 1) / rollout::kBlock, n_chunks);
  rollout_grid_kernel<World><<<blocks, rollout::kBlock, smem,
                               (cudaStream_t)stream>>>(
      world, cand, params, n_params, active, q_obs, margin_part, C, T, d, nb,
      dt, clearance, skip_rotf, t_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rollout_grid_launch(
    const float* cand, const float* params, int n_params, const float* grid,
    int X, int Y, int Z, float hi0, float hi1, float hi2, int composite,
    const uint8_t* active, float* q_obs, float* margin_part, int C, int T,
    int d, int nb, int ns, int nx, float dt, float clearance, int skip_rotf,
    int t_chunk, void* stream) {
  const GridDist world{GridDims{grid, X, Y, Z, hi0, hi1, hi2}, ns, nx,
                       composite};
  return launch(world, cand, params, n_params, active, q_obs, margin_part, C,
                T, d, nb, dt, clearance, skip_rotf, t_chunk, stream);
}

// Overlay rows: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6].
extern "C" int rollout_grid_rows_launch(
    const float* cand, const float* params, int n_params, const float* grid,
    int X, int Y, int Z, float hi0, float hi1, float hi2,
    const float* spheres, const float* boxes, int cands_per_row,
    const uint8_t* active, float* q_obs, float* margin_part, int C, int T,
    int d, int nb, int ns, int nx, float dt, float clearance, int skip_rotf,
    int t_chunk, void* stream) {
  const GridRowDist world{GridDims{grid, X, Y, Z, hi0, hi1, hi2},
                          rollout::RowPrims{spheres, boxes, ns, nx,
                                            cands_per_row}};
  return launch(world, cand, params, n_params, active, q_obs, margin_part, C,
                T, d, nb, dt, clearance, skip_rotf, t_chunk, stream);
}

// Fused rollout evaluator for analytic (sphere/box) worlds, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tpustomp/kernels/rollout_pallas.py that
// evaluate analytic worlds:
//   K3  build_unrolled_kernel(mode="analytic", time_major=True,
//       with_activity=True), pallas_call at :741 — the batched STOMP path;
//   K4  the same builder with time_major=False, pallas_call at :755 — the
//       candidate-major [C, T, d] layout (the wrapper permutes into this
//       kernel's time-major input);
//   K1  build_rollout_kernel, pallas_call at :257 — the rolled form for
//       robots whose bodies are not link-sorted (the wrapper sorts them);
//   K3 with per_cand_world=True (:402-409, :610-634, wrapper :974-1009) —
//       every candidate against its own spheres and boxes (batched MPC):
//       rollout_analytic_rows_launch below.
// The computation, layout and parameter format are rollout_common.cuh's;
// this file supplies the distance: the min over the world's spheres and
// boxes.
//
// What bounds it on the H100: arithmetic, not memory. At the config-4 shape
// (C = 57,344 candidates, T = 102, d = 7, 12 bodies, 2 boxes) one launch reads
// 164 MB of trajectories and writes 23 MB of cost rows, while each
// (candidate, waypoint) costs ~70 flops per joint of frame algebra plus a
// sincos, and ~40 flops per body and box of SDF. The design therefore keeps
// every intermediate on chip and does each FK exactly once (plus a 2-waypoint
// halo per chunk); the primitives are read from shared memory as
// warp-uniform broadcasts.
//
// Per-row worlds (config 5: 10,000 scenarios x 21 candidates, one moving
// sphere plus the 2 tabletop boxes per scenario, 16 floats per row): a
// 64-thread block spans the candidates of ~4 scenarios, so a warp reads 2-3
// distinct rows. Staging them in shared memory would buy little: the rows a
// block touches are a few hundred bytes, read ns + nx times per body and
// waypoint from L1 through __ldg (the same addresses across most of a warp,
// so mostly broadcasts), while the FK arithmetic above still bounds the
// kernel. The per-row world costs one more 4-byte load per primitive term
// than the shared one, and no extra pass.

#include "rollout_common.cuh"

namespace {

struct AnalyticDist {
  int ns, nx;
  __device__ __forceinline__ rollout::Prims<rollout::SharedLoad> at(
      const float* W, int) const {
    return rollout::shared_prims(W, ns, nx);
  }
};

struct AnalyticRowDist {
  rollout::RowPrims rows;
  __device__ __forceinline__ rollout::Prims<rollout::ReadOnlyLoad> at(
      const float*, int c) const {
    return rows.at(c);
  }
};

template <class World>
__global__ void __launch_bounds__(rollout::kBlock) rollout_analytic_kernel(
    World world, const float* __restrict__ cand,
    const float* __restrict__ params, int n_params,
    const uint8_t* __restrict__ active, float* __restrict__ q_obs,
    float* __restrict__ margin_part, int C, int T, int d, int nb, float dt,
    float clearance, int skip_rotf, int t_chunk) {
  rollout::evaluate(world, cand, params, n_params, active, q_obs, margin_part,
                    C, T, d, nb, dt, clearance, skip_rotf, t_chunk);
}

template <class World>
int launch(const World& world, const float* cand, const float* params,
           int n_params, const uint8_t* active, float* q_obs,
           float* margin_part, int C, int T, int d, int nb, float dt,
           float clearance, int skip_rotf, int t_chunk, void* stream) {
  if (C <= 0) return 0;
  const int n_chunks = (T + t_chunk - 1) / t_chunk;
  const size_t smem = rollout::smem_bytes(n_params, nb);
  const int err = rollout::allow_smem(rollout_analytic_kernel<World>, smem);
  if (err != 0) return err;
  dim3 grid((C + rollout::kBlock - 1) / rollout::kBlock, n_chunks);
  rollout_analytic_kernel<World><<<grid, rollout::kBlock, smem,
                                   (cudaStream_t)stream>>>(
      world, cand, params, n_params, active, q_obs, margin_part, C, T, d, nb,
      dt, clearance, skip_rotf, t_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// A world shared by every candidate: its primitives are in params.
extern "C" int rollout_analytic_launch(
    const float* cand, const float* params, int n_params,
    const uint8_t* active, float* q_obs, float* margin_part, int C, int T,
    int d, int nb, int ns, int nx, float dt, float clearance, int skip_rotf,
    int t_chunk, void* stream) {
  return launch(AnalyticDist{ns, nx}, cand, params, n_params, active, q_obs,
                margin_part, C, T, d, nb, dt, clearance, skip_rotf, t_chunk,
                stream);
}

// Per-row worlds: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6];
// params hold the robot only.
extern "C" int rollout_analytic_rows_launch(
    const float* cand, const float* params, int n_params,
    const float* spheres, const float* boxes, int cands_per_row,
    const uint8_t* active, float* q_obs, float* margin_part, int C, int T,
    int d, int nb, int ns, int nx, float dt, float clearance, int skip_rotf,
    int t_chunk, void* stream) {
  const rollout::RowPrims rows{spheres, boxes, ns, nx, cands_per_row};
  return launch(AnalyticRowDist{rows}, cand, params, n_params, active, q_obs,
                margin_part, C, T, d, nb, dt, clearance, skip_rotf, t_chunk,
                stream);
}

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
//       rollout_analytic_rows_launch below;
//   K3 with ee_out=True (:410-418, :472-474, :672-682, :736-740) — the
//       end-effector frame [12, T, C] beside the costs, for Cartesian
//       constraints: either entry point with a non-null ee.
// The computation, layout and parameter format are rollout_common.cuh's;
// this file supplies the distance: the min over the world's spheres and
// boxes.
//
// What bounds it on the H100: arithmetic, not memory. At the config-4 shape
// (C = 57,344 candidates, T = 102, d = 7, 12 bodies, 2 boxes) one launch reads
// 164 MB of trajectories and writes 23 MB of cost rows, while each
// (candidate, waypoint) costs ~70 flops per joint of frame algebra plus a
// sincos, and ~40 flops per body and box of SDF: a serial chain per
// waypoint. The skeleton therefore does each FK once (plus a 1-waypoint
// halo per segment of 30), keeps every intermediate in registers, and
// spends no shared memory per thread, so registers alone set how many warps
// hide that chain's latency.
//
// Per-row worlds (config 5: 10,000 scenarios x 21 candidates, one moving
// sphere plus the 2 tabletop boxes per scenario, 16 floats per row): a warp
// evaluates one candidate, so its row is warp-uniform; a row within the
// register budget below is loaded once into registers instead of once per
// body and waypoint, and an inactive scenario's warps leave at once.

#include "rollout_common.cuh"

namespace {

// The primitives a warp holds in registers: up to 16 floats (4 a sphere, 6
// a box) keep every instantiation within 64 registers a thread (ptxas), so
// 4 blocks of 256 threads stay resident per SM; 2 spheres and 2 boxes (20
// floats) take 68 registers and 3 blocks. Larger worlds are read from
// memory at every use.
constexpr int kRegisterFloats = 16;

template <class World, class Chain>
__global__ void __launch_bounds__(rollout::kBlock) rollout_analytic_kernel(
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
  const int err = rollout::prepare(rollout_analytic_kernel<World, Chain>,
                                   smem, seg_len);
  if (err != 0) return err;
  dim3 grid((C + rollout::kCands - 1) / rollout::kCands,
            (T + seg_len - 1) / seg_len);
  rollout_analytic_kernel<World, Chain><<<grid, rollout::kBlock, smem,
                                          (cudaStream_t)stream>>>(
      world, chain, cand, params, n_params, active, q_obs, margin_part, ee,
      C, T, dt, clearance, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point ends with the same tail: active (or null), q_obs,
// margin_part ([segments, C]), ee ([12, T, C], or null: no frame output),
// then the shapes, the scalars and the segment length. d, nb and skip_rotf
// must match the library's chain (rollout_common.cuh with_chain).

// A world shared by every candidate: its primitives are in params.
extern "C" int rollout_analytic_launch(
    const float* cand, const float* params, int n_params,
    const uint8_t* active, float* q_obs, float* margin_part, float* ee, int C,
    int T, int d, int nb, int ns, int nx, float dt, float clearance,
    int skip_rotf, int seg_len, void* stream) {
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_register_counts<kRegisterFloats>(
        ns, nx, [&](auto k) {
          using K = decltype(k);
          return launch(rollout::SharedPrims<K::ns, K::nx>{ns, nx}, chain,
                        cand, params, n_params, active, q_obs, margin_part,
                        ee, C, T, dt, clearance, seg_len, stream);
        });
  });
}

// Per-row worlds: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6];
// params hold the robot only.
extern "C" int rollout_analytic_rows_launch(
    const float* cand, const float* params, int n_params,
    const float* spheres, const float* boxes, int cands_per_row,
    const uint8_t* active, float* q_obs, float* margin_part, float* ee, int C,
    int T, int d, int nb, int ns, int nx, float dt, float clearance,
    int skip_rotf, int seg_len, void* stream) {
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_register_counts<kRegisterFloats>(
        ns, nx, [&](auto k) {
          using K = decltype(k);
          return launch(rollout::RowPrims<K::ns, K::nx>{spheres, boxes, ns,
                                                        nx, cands_per_row},
                        chain, cand, params, n_params, active, q_obs,
                        margin_part, ee, C, T, dt, clearance, seg_len,
                        stream);
        });
  });
}

// Fused rollout evaluator for analytic (sphere/box) worlds, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tpustomp/kernels/rollout_pallas.py that
// evaluate analytic worlds:
//   K3  build_unrolled_kernel(mode="analytic", time_major=True,
//       with_activity=True), pallas_call at :741 — the batched STOMP path;
//   K4  the same builder with time_major=False, pallas_call at :755 — the
//       candidate-major [C, T, d] layout, read by the kernel's own stage
//       (cand_major, rollout_common.cuh), so no copy runs before it;
//   K1  build_rollout_kernel, pallas_call at :257 — the rolled form for
//       robots whose bodies are not link-sorted (the wrapper sorts them;
//       their parameters in the parameter block, or the large block above
//       it, whether the robot came from the host or was built on the
//       card);
//   K3 with per_cand_world=True (:402-409, :610-634, wrapper :974-1009) —
//       every candidate against its own spheres and boxes (batched MPC):
//       rollout_analytic_rows_launch below;
//   K3 with ee_out=True (:410-418, :472-474, :672-682, :736-740) — the
//       end-effector frame [12, T, C] beside the costs, for Cartesian
//       constraints: either entry point with a non-null ee; or, with a
//       non-null q_con, the frame's one consumer folded in (the solver's
//       constraint tail, costs/constraints.py constraint_cost_tm): the
//       constraints' cost [T, C] instead of the frame.
// The computation, layout and parameter format are rollout_common.cuh's;
// this file supplies the distance: the min over the world's spheres and
// boxes.
//
// What bounds it on the H100: instruction issue, not memory. At the config-4
// shape (C = 57,344 candidates, T = 102, d = 7, 12 bodies, 2 boxes) one
// launch reads 164 MB of trajectories and writes 23 MB of cost rows (0.06 ms
// at 3.35 TB/s), while each (candidate, waypoint) is a serial chain of
// ~2,000 instructions: per joint ~70 flops of frame algebra and a sincos,
// per body and box ~40 flops of SDF. rollout_common.cuh's skeleton answers
// that: 32 lanes per 30 owned waypoints over the block's active candidates
// only, the robot and the shared boxes as constant-bank operands (no
// shared-memory load, no register), every intermediate in registers.
//
// Per-row worlds (config 5: 10,000 scenarios x 21 candidates, one moving
// sphere plus the 2 tabletop boxes per scenario, 16 floats per row): a row
// within the budget below is staged per block in shared memory (a block's 9
// candidates span one or two rows) and read with its counts compiled in;
// inactive scenarios cost no FK.

#include "rollout_common.cuh"

namespace {

// Worlds of up to 16 floats of primitives (4 a sphere, 6 a box) run with
// their counts compiled in (the loops unrolled): a per-row world's row
// staged in shared memory, a shared world's primitives at fixed offsets of
// the parameters. Larger worlds loop to their run-time counts (a shared one
// still in the constant bank while the parameter block holds it; a per-row
// one read from memory at every use).
constexpr int kRegisterFloats = 16;

template <class World, class Chain, class Par>
__global__ void __launch_bounds__(
    rollout::kBlock, rollout::kernel_min_blocks<World, Chain>())
rollout_analytic_kernel(
    World world, Chain chain, const __grid_constant__ Par par,
    const rollout::Shape s) {
  rollout::evaluate(world, chain, par, s);
}

}  // namespace

// Every entry point ends with the same tail: active (or null), q_obs,
// margin_part ([n_slab, C]), ee ([12, T, C], or null: no frame output),
// q_con ([T, C], or null: no constraint route; n_con constraints, the last
// section of params), then the shapes, the scalars, the lane plan (cpb,
// n_slab: kernels/rollout.py _plan), cand_major (1: cand is [C, T, d], else
// [d, T, C]), the stream, and `resident`: null for a launch, else the
// occupancy query of rollout_common.cuh launch_plan. params is a host
// pointer to n_params floats for the parameter block when host_params is 1
// (n_params <= kParamFloats; the large block up to kLargeParamFloats), else
// a device pointer (the memory path). d, nb and skip_rotf must match the
// library's chain (rollout_common.cuh with_chain).

// A world shared by every candidate: its primitives are in params.
extern "C" int rollout_analytic_launch(
    const float* cand, const float* params, int n_params, int host_params,
    const uint8_t* active, float* q_obs, float* margin_part, float* ee,
    float* q_con, int C, int T, int d, int nb, int ns, int nx, int n_con,
    float dt, float clearance, int skip_rotf, int cpb, int n_slab,
    int cand_major, void* stream, int* resident) {
  const rollout::Shape s{cand,  active, q_obs, margin_part, ee,
                         q_con, C,      T,     n_params,    cpb,
                         n_slab, n_con, cand_major, dt, clearance};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_params<kRegisterFloats>(
        params, n_params, host_params, ns, nx, [&](auto k, const auto& par) {
          using K = decltype(k);
          using Par = std::decay_t<decltype(par)>;
          using World = rollout::SharedPrims<K::ns, K::nx>;
          return rollout::launch_plan(
              rollout_analytic_kernel<World, decltype(chain), Par>,
              Par::kStaged ? n_params : 0, d, s, stream, resident,
              World{ns, nx}, chain, par);
        });
  });
}

// Per-row worlds: spheres [C / cands_per_row, ns, 4], boxes [.., nx, 6];
// params hold the robot only.
extern "C" int rollout_analytic_rows_launch(
    const float* cand, const float* params, int n_params, int host_params,
    const float* spheres, const float* boxes, int cands_per_row,
    const uint8_t* active, float* q_obs, float* margin_part, float* ee,
    float* q_con, int C, int T, int d, int nb, int ns, int nx, int n_con,
    float dt, float clearance, int skip_rotf, int cpb, int n_slab,
    int cand_major, void* stream, int* resident) {
  const rollout::Shape s{cand,  active, q_obs, margin_part, ee,
                         q_con, C,      T,     n_params,    cpb,
                         n_slab, n_con, cand_major, dt, clearance};
  return rollout::with_chain(d, nb, skip_rotf, [&](auto chain) {
    return rollout::with_params<kRegisterFloats>(
        params, n_params, host_params, ns, nx, [&](auto k, const auto& par) {
          using K = decltype(k);
          using Par = std::decay_t<decltype(par)>;
          using World = rollout::RowPrims<K::ns, K::nx>;
          return rollout::launch_plan(
              rollout_analytic_kernel<World, decltype(chain), Par>,
              Par::kStaged ? n_params : 0, d, s, stream, resident,
              World{spheres, boxes, ns, nx, cands_per_row}, chain, par);
        });
  });
}

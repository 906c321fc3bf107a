// Two-pass MPPI rollout + cost for NVIDIA Hopper (sm_90a), scoring every
// rollout against C forecast scenarios in one launch.
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::_rollout_kernel
// (the TPU kernel of the two-pass sampler, the scenario ensemble and long
// horizons; calls at pallas_rollout.py:615, :978 and, chunked, :1071). The
// TPU scores a C-scenario ensemble with C calls of its kernel
// (_scenario_costs_padded, pallas_rollout.py:1096-1128), each re-running the
// whole step on the same controls; here one launch does it. Per rollout r and
// horizon step s the thread reads the given absolute control
// u = controls[s, :, r] once and runs the Franka-Ridgeback step of
// franka_step.cuh once: FK (forward_kinematics), the scenario-free cost
// terms (step_costs), the manipulability term, the mass matrix, Cholesky
// solve and Euler step
// (step_dynamics). Only the trajectory term reads the forecast (through the
// per-step table row), so it alone runs C times, once per scenario's row,
// and each scenario's smooth cost is formed in step()'s order (... velocity,
// + trajectory_c, + manipulability, then disc * step). A C-scenario launch
// therefore gives, per scenario, the costs of a one-scenario launch on that
// scenario's table. The violation channel reads no forecast: it is counted
// once and written C times. Thread 0 streams rollout 0's pre-step (q, v),
// which no scenario changes. The noise is assembled (and the shifted optimal
// added) before the launch, in plain PyTorch, as the JAX package does outside
// its kernel (lane_noise_assemble). The plain PyTorch version is
// kernels/cuda_rollout.py::rollout_reference; the wrapper is rollout.
//
// Layout: controls are rollout-minor (S, 12, R), so thread r's loads for one
// (s, d) are coalesced across the warp. The C per-step tables ((C, S, 8)
// floats: trajectory target, its scalars, discount, padding) sit in dynamic
// shared memory, 32 B a row, so one block holds C x S <= 7,264 rows. Costs
// come out as (C, R, 2). The kernel is instantiated for every C from 1 to
// MAX_SCENARIOS, so each instantiation keeps exactly its C smooth
// accumulators in registers (a runtime C would hold MAX_SCENARIOS live under
// the 255-register cap); C = 1 is the single-forecast kernel, which the
// long-horizon path and make_cuda_rollout_fn launch.
//
// One loop over any S: the TPU kernel splits long horizons into chunks over
// a second grid axis only to keep its VMEM tiles wide, and that chunking
// carries two faults this kernel cannot have (stale chunked rollout-0 states
// on the TPU, and zero-discount pad steps whose inf/NaN still poisons a
// cost). Here q and v stay in registers for the whole horizon and no step
// beyond S runs.
//
// What bounds it on an H100: arithmetic. One rollout-step needs at least
// 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_tpu/ops/
// flops.py) for the step and one scenario, and each further scenario adds
// the trajectory term and its two accumulations, 17 more
// (cuda_rollout.SCENARIO_FP32_INSTRUCTIONS). At 10,000 x 50 x 4 scenarios
// that is ~1.68 G instructions, ~50 us at 132 SMs x 128 lanes x 1.98 GHz;
// reading the controls once is 24 MB, ~7 us at 3.35 TB/s. The dynamics, not
// the scenarios, are the work: four scenarios cost one step body plus 51
// instructions, where four launches cost four step bodies and four reads of
// the controls. Beyond that it is the first, simple design of kernel 1 (one
// thread per rollout at ~2.4 warps per SM, generic joint loops,
// register-capped with spills); its measured time beside the bound is in
// PERF.md.

#include "franka_step.cuh"

namespace {

constexpr int TABLE_WIDTH = 8;     // floats per row: target (3), inv2, pcost, vtarget, disc, pad
constexpr int BLOCK = 64;          // threads per block: 157 blocks at R = 10,000
constexpr int MAX_SCENARIOS = 8;   // largest C compiled

template <int C>
__global__ void __launch_bounds__(BLOCK)
rollout_kernel(const Params P, const float* __restrict__ init, const float* __restrict__ table,
               const float* __restrict__ controls, float* __restrict__ costs,
               float* __restrict__ states, int R, int S) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < C * S * TABLE_WIDTH; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  float q[NJ], v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    q[j] = init[j];
    v[j] = init[NJ + j];
  }
  const float energy = init[2 * NJ];
  float viol_total = 0.0f, smooth_total[C];
#pragma unroll
  for (int c = 0; c < C; ++c) smooth_total[c] = 0.0f;

  for (int s = 0; s < S; ++s) {
    if (r == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        states[s * 2 * NJ + j] = q[j];
        states[s * 2 * NJ + NJ + j] = v[j];
      }
    }
    float u[NJ];
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = controls[((size_t)s * NJ + d) * R + r];
    StepKinematics K;
    float step_viol, smooth;
    forward_kinematics(P, q, K);
    step_costs(P, q, v, energy, K, step_viol, smooth);
    float manipulability = 0.0f;
    if (P.enable_manipulability) manipulability = manipulability_cost(P, K.J);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* row = tab + (c * S + s) * TABLE_WIDTH;
      float step_smooth = smooth;
      add_trajectory_cost(P, K.ee_vel, row, step_smooth);
      if (P.enable_manipulability) step_smooth += manipulability;
      smooth_total[c] += row[COL_DISC] * step_smooth;
    }
    viol_total += tab[s * TABLE_WIDTH + COL_DISC] * step_viol;
    step_dynamics(P, q, v, u, K);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    costs[2 * ((size_t)c * R + r)] = viol_total;
    costs[2 * ((size_t)c * R + r) + 1] = smooth_total[c];
  }
}

template <int C>
int launch(const Params& P, const float* init, const float* table, const float* controls,
           float* costs, float* states, int rollouts, int steps, cudaStream_t stream) {
  const size_t shared = (size_t)C * steps * TABLE_WIDTH * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + BLOCK - 1) / BLOCK;
  rollout_kernel<C><<<blocks, BLOCK, shared, (cudaStream_t)stream>>>(
      P, init, table, controls, costs, states, rollouts, steps);
  return (int)cudaGetLastError();
}

// launch<scenarios> for a runtime count in [C, MAX_SCENARIOS].
template <int C>
int dispatch(int scenarios, const Params& P, const float* init, const float* table,
             const float* controls, float* costs, float* states, int rollouts, int steps,
             cudaStream_t stream) {
  if (scenarios == C) return launch<C>(P, init, table, controls, costs, states, rollouts, steps, stream);
  if constexpr (C < MAX_SCENARIOS) {
    return dispatch<C + 1>(scenarios, P, init, table, controls, costs, states, rollouts, steps, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int ro_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int ro_topology(int* out, int capacity) { return write_topology(out, capacity); }

// The largest scenario count compiled, for the wrapper's check.
int ro_max_scenarios() { return MAX_SCENARIOS; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block, `table` at (scenarios, steps, 8) floats,
// `costs` at (scenarios, rollouts, 2). A scenario count outside
// [1, MAX_SCENARIOS] returns cudaErrorInvalidValue; tables larger than a
// block's shared memory make cudaFuncSetAttribute (or the launch) fail, and
// that error is returned. The wrapper refuses both before calling.
int ro_launch(const void* params, const float* init, const float* table, const float* controls,
              float* costs, float* states, int rollouts, int steps, int scenarios, void* stream) {
  return dispatch<1>(scenarios, *static_cast<const Params*>(params), init, table, controls, costs,
                     states, rollouts, steps, (cudaStream_t)stream);
}

}  // extern "C"

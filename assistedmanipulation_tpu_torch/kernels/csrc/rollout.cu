// Two-pass MPPI rollout + cost for NVIDIA Hopper (sm_90a), scoring every
// rollout against C forecast scenarios in one launch.
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::_rollout_kernel
// (the TPU kernel of the two-pass sampler, the scenario ensemble and long
// horizons; calls at pallas_rollout.py:615, :978 and, chunked, :1071). The
// TPU scores a C-scenario ensemble with C calls of its kernel
// (_scenario_costs_padded, pallas_rollout.py:1096-1128), each re-running the
// whole step on the same controls; here one launch does it. Per rollout r and
// horizon step s the kernel reads the given absolute control
// u = controls[s, :, r] once and runs the Franka-Ridgeback step of
// franka_step.cuh once: FK (forward_kinematics), the scenario-free cost
// terms (step_costs), the manipulability term, the mass matrix, Cholesky
// solve and Euler step
// (step_dynamics). Only the trajectory term reads the forecast (through the
// per-step table row), so it alone runs C times, once per scenario's row,
// and each scenario's smooth cost is formed in the order of franka_step.cuh's
// parts (... velocity, + trajectory_c, + manipulability, then disc * step). A C-scenario launch
// therefore gives, per scenario, the costs of a one-scenario launch on that
// scenario's table. The violation channel reads no forecast: it is counted
// once and written C times. Rollout 0's pre-step (q, v) is streamed out,
// which no scenario changes. The noise is assembled (and the shifted optimal
// added) before the launch, in plain PyTorch, as the JAX package does outside
// its kernel (lane_noise_assemble). The plain PyTorch version is
// kernels/cuda_rollout.py::rollout_reference; the wrapper is rollout.
//
// Layout: controls are rollout-minor (S, 12, R), so a warp's loads for one
// (s, d) are coalesced. The C per-step tables ((C, S, 8) floats: trajectory
// target, its scalars, discount, padding) sit in dynamic shared memory, 32 B
// a row, beside the state ring, so one block holds C x S <= MAX_TABLE_ROWS
// = 6,878 rows. Costs come out as (C, R, 2). The kernel is instantiated for
// every C from 1 to MAX_SCENARIOS, so each instantiation keeps exactly its C
// smooth accumulators in registers (a runtime C would hold MAX_SCENARIOS
// live under the 255-register cap); C = 1 is the single-forecast kernel,
// which the long-horizon path, make_cuda_rollout_fn and the resimulate
// re-rollout (R = 1) launch.
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
// the controls. What holds one thread per rollout back is latency: each
// step is one long dependent stream, and at small widths (R = 1 for the
// resimulate re-rollout, 52 x 30 in the scenario study) that stream is the
// whole kernel. So it runs as kernel 1 does (sample_rollout.cuh), on a warp
// pair per 32 rollouts sharing a shared-memory ring (pipeline.cuh):
//   - the dynamics warp loads its controls, runs forward_kinematics and
//     step_dynamics, and pushes (q_{s+1}, v_{s+1}) into the ring;
//   - the cost warp pops (q_s, v_s), runs forward_kinematics on it with the
//     same code, then step_costs, the manipulability term and the C
//     add_trajectory_cost rows in the order above, streams rollout 0's states
//     and writes the (C, R, 2) costs.
// The chain each step waits on is FK + dynamics; the scenario-free cost
// terms and all C trajectory terms run beside it, up to STAGES steps behind.
// Both warps run one loop with FK in the shared part (two copies of the
// step's code overflow the SM's instruction cache). Dead lanes (r >= R: 31
// of each warp at R = 1) replay the last rollout, store nothing and arrive
// at every barrier.

#include "franka_step.cuh"
#include "pipeline.cuh"

namespace {

constexpr int TABLE_WIDTH = 8;     // floats per row: target (3), inv2, pcost, vtarget, disc, pad
constexpr int MAX_SCENARIOS = 8;   // largest C compiled
constexpr int STAGES = 4;          // state ring depth
using StateRing = Ring<STAGES, 2 * NJ>;
constexpr int MAX_TABLE_ROWS =
    (int)((MAX_SHARED_BYTES - StateRing::BYTES) / (TABLE_WIDTH * sizeof(float)));

size_t shared_bytes(int rows) {
  return (size_t)rows * TABLE_WIDTH * sizeof(float) + StateRing::BYTES;
}

template <int C>
__global__ void __launch_bounds__(PAIR)
pair_rollout_kernel(const Params P, const float* __restrict__ init, const float* __restrict__ table,
                    const float* __restrict__ controls, float* __restrict__ costs,
                    float* __restrict__ states, int R, int S) {
  extern __shared__ __align__(16) float tab[];
  const int rows = C * S;
  const StateRing ring{tab + rows * TABLE_WIDTH,
                       reinterpret_cast<uint64_t*>(tab + rows * TABLE_WIDTH + StateRing::FLOATS)};
  for (int i = threadIdx.x; i < rows * TABLE_WIDTH; i += blockDim.x) tab[i] = table[i];
  if (threadIdx.x == 0) {
    ring.init();
    mbarrier_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int r = blockIdx.x * LANES + lane;
  const bool live = r < R;
  // A dead lane replays the last rollout's controls: it takes that lane's
  // branches, so its warp runs one path (on zero controls the step took
  // other branches than any live lane, and the warp ran both every step).
  const int source = live ? r : R - 1;
  float q[NJ], v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    q[j] = init[j];
    v[j] = init[NJ + j];
  }

  // Warp 0 runs the dynamics, warp 1 the costs, in one loop whose
  // forward_kinematics both execute; the empty asm keeps the compiler from
  // splitting the loop by role.
  const bool dynamics_warp = threadIdx.x < LANES;
  const float energy = init[2 * NJ];
  float viol_total = 0.0f, smooth_total[C];
#pragma unroll
  for (int c = 0; c < C; ++c) smooth_total[c] = 0.0f;
  for (int s = 0; s < S; ++s) {
    int dynamics = dynamics_warp;
    asm volatile("" : "+r"(dynamics));
    float u[NJ];
    if (dynamics) {
      if (s == S - 1) break;  // no step reads the state after the horizon
#pragma unroll
      for (int d = 0; d < NJ; ++d) u[d] = controls[((size_t)s * NJ + d) * R + source];
    } else {
      if (s > 0) {
        float qv[2 * NJ];
        ring.pop(s - 1, lane, qv);  // state s
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          q[j] = qv[j];
          v[j] = qv[NJ + j];
        }
      }
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          states[s * 2 * NJ + j] = q[j];
          states[s * 2 * NJ + NJ + j] = v[j];
        }
      }
    }
    StepKinematics K;
    forward_kinematics(P, q, K);
    if (dynamics) {
      step_dynamics(P, q, v, u, K);
      float qv[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qv[j] = q[j];
        qv[NJ + j] = v[j];
      }
      ring.push(s, lane, qv);  // state s + 1
    } else {
      float step_viol, smooth;
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
    }
  }
  if (!dynamics_warp && live) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      costs[2 * ((size_t)c * R + r)] = viol_total;
      costs[2 * ((size_t)c * R + r) + 1] = smooth_total[c];
    }
  }
}

template <int C>
int launch(const Params& P, const float* init, const float* table, const float* controls,
           float* costs, float* states, int rollouts, int steps, cudaStream_t stream) {
  const size_t shared = shared_bytes(C * steps);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_rollout_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + LANES - 1) / LANES;
  pair_rollout_kernel<C><<<blocks, PAIR, shared, (cudaStream_t)stream>>>(
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

// The most (C x S) table rows that fit in a block's shared memory beside
// the state ring, for the wrapper's check.
int ro_max_table_rows() { return MAX_TABLE_ROWS; }

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

// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a), as a
// warp-specialised kernel: each group of 32 rollouts gets a pair of warps.
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::
// _fused_sample_rollout_kernel (the TPU kernel of the serving solve). The
// plain PyTorch version is kernels/cuda_rollout.py::
// fused_sample_rollout_reference; the wrapper is fused_sample_rollout. The
// step body (topology, Params, forward_kinematics, step_costs,
// step_dynamics) is franka_step.cuh's, shared with rollout.cu and the
// in-kernel-RNG kernel; the rings are pipeline.cuh's.
//
// Per rollout r and horizon step s the kernel
//   1. picks the noise: elite rollouts (keep[r]) take their old noise shifted
//      left by `shift` with a fresh tail when `do_shift`, other rollouts take
//      fresh noise, rollout 0 takes 0 and rollout 1 takes -optimal[s]; the
//      chosen value is written out unchanged (bitwise the plain version's);
//   2. runs u = noise + optimal_shifted[s] through the Franka-Ridgeback step:
//      FK, the 7-term assisted-manipulation cost, CRBA mass matrix, implicit
//      PD + Coulomb friction diagonal, 12x12 Cholesky solve, semi-implicit
//      Euler;
//   3. accumulates disc[s] * (violations, smooth) in f32 in step order, and
//      streams rollout 0's pre-step (q, v).
//
// What bounds it on an H100: arithmetic. One rollout-step needs at least
// 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_tpu/ops/
// flops.py), so 10,000 x 50 is ~1.65 G instructions, ~49 us at 132 SMs x 128
// lanes x 1.98 GHz; the three noise streams are 72 MB, ~21 us at 3.35 TB/s.
// What holds it back is latency: one thread per rollout gives ~2.4 warps per
// SM at R = 10,000, under one per scheduler, and each warp's step is one long
// dependent stream at ~3.7 cycles per instruction.
//
// The design splits each step by what the next state needs. The next
// (q, v) depends only on FK and the dynamics; the cost terms, the noise
// output and rollout 0's states feed nothing later in the rollout. So:
//   - the dynamics warp holds q and v in registers and, per step, loads its
//     noise (the select), runs forward_kinematics, writes the noise out (after
//     FK, so the loads land while it runs), runs step_dynamics and pushes
//     (q_{s+1}, v_{s+1}) into a ring of STAGES slots in shared memory; it runs
//     no cost term;
//   - the cost warp pops (q_s, v_s) (q_0, v_0 is `init`), runs
//     forward_kinematics on it with the same code, then step_costs,
//     add_trajectory_cost and manipulability_cost in step()'s order,
//     accumulates the discounted costs, streams rollout 0's states and writes
//     the (R, 2) costs at the end.
// The chain each step waits on is FK + dynamics; the cost terms run beside
// it on the other warp, up to STAGES steps behind. The costs are bitwise the
// one-warp step()'s: the same code on the same q. Both warps run one loop,
// FK in the part they share, so one copy of FK's code serves the pair: the
// step's code is ~125 KB of SASS, and with FK compiled once per warp the two
// streams together no longer fit the SM's instruction cache (PERF.md: that
// form ran slower than one thread per rollout). The pair is one block of 64
// threads: 313 blocks, 4.7 warps per SM at R = 10,000. The last pair may
// hold fewer than 32 rollouts:
// its dead lanes (r >= R) run the loop on zero noise with no global load or
// store and arrive at every barrier, so no arrival count depends on R, and
// no thread leaves before the loop ends.
//
// Shared memory: the (S, 32) per-step table (trajectory target, its scalars,
// discount, optimal and shifted optimal), the state ring and its barriers;
// fsr_max_steps() is the longest horizon that fits.

#include "franka_step.cuh"
#include "pipeline.cuh"

namespace {

constexpr int TABLE_WIDTH = 32;   // floats per row of the per-step table
constexpr int COL_OPTIMAL = 7;    // 12: pre-shift optimal (rollout 1 = -this)
constexpr int COL_OPTSHIFT = 19;  // 12: shifted optimal (u = noise + this)
constexpr int PAIR = 2 * LANES;   // threads per block: the dynamics warp, then the cost warp
constexpr int STAGES = 4;         // state ring depth
using StateRing = Ring<STAGES, 2 * NJ>;
constexpr size_t RING_BYTES =
    StateRing::FLOATS * sizeof(float) + StateRing::BARRIERS * sizeof(uint64_t);
constexpr int MAX_STEPS = (int)((MAX_SHARED_BYTES - RING_BYTES) / (TABLE_WIDTH * sizeof(float)));

size_t shared_bytes(int steps) { return (size_t)steps * TABLE_WIDTH * sizeof(float) + RING_BYTES; }

// The select chain of pallas_rollout.py:350-363 for one row and step: u
// gets the chosen noise. The fresh predicate does not depend on the dof, so
// a row loads all 12 values from one source, picked per row.
__device__ __forceinline__ void select_noise(const float* row, const float* __restrict__ old,
                                             const float* __restrict__ fresh, int r, int R, int s,
                                             int S, int shift, bool do_shift, bool row0, bool row1,
                                             bool kept, bool live, float (&u)[NJ]) {
  const bool tail = s >= S - shift;
  const bool take_fresh = !row0 && !row1 && (!kept || (do_shift && tail));
  const int sidx = do_shift ? min(s + shift, S - 1) : s;
  const float* source = take_fresh ? fresh : old;
  const int source_step = take_fresh ? s : sidx;
  if (row0 || row1) {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = row0 ? 0.0f : -row[COL_OPTIMAL + d];
  } else if (live) {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = source[((size_t)source_step * NJ + d) * R + r];
  } else {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = 0.0f;
  }
}

// The chosen noise written out (live lanes only); u becomes the control,
// noise plus the shifted optimal.
__device__ __forceinline__ void write_noise(const float* row, float* __restrict__ noise, int r,
                                            int R, int s, bool live, float (&u)[NJ]) {
#pragma unroll
  for (int d = 0; d < NJ; ++d) {
    if (live) noise[((size_t)s * NJ + d) * R + r] = u[d];
    u[d] += row[COL_OPTSHIFT + d];
  }
}

__global__ void __launch_bounds__(PAIR)
pair_sample_rollout_kernel(const Params P, const float* __restrict__ init,
                           const float* __restrict__ table, const int* __restrict__ meta,
                           const float* __restrict__ old, const float* __restrict__ fresh,
                           const unsigned char* __restrict__ keep, float* __restrict__ noise,
                           float* __restrict__ costs, float* __restrict__ states, int R, int S) {
  extern __shared__ __align__(16) float tab[];
  const StateRing ring{tab + S * TABLE_WIDTH,
                       reinterpret_cast<uint64_t*>(tab + S * TABLE_WIDTH + StateRing::FLOATS)};
  for (int i = threadIdx.x; i < S * TABLE_WIDTH; i += blockDim.x) tab[i] = table[i];
  if (threadIdx.x == 0) {
    ring.init();
    mbarrier_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int r = blockIdx.x * LANES + lane;
  const bool live = r < R;
  float q[NJ], v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    q[j] = init[j];
    v[j] = init[NJ + j];
  }

  // Warp 0 runs the dynamics, warp 1 the costs, in one loop whose
  // forward_kinematics both execute. The empty asm keeps the compiler from
  // splitting the loop by role, which would compile FK twice.
  const bool dynamics_warp = threadIdx.x < LANES;
  const int shift = meta[0];
  const bool do_shift = meta[1] != 0;
  const bool first = meta[2] != 0;  // this batch holds static rollouts 0 and 1
  const bool row0 = first && r == 0;
  const bool row1 = first && r == 1;
  const bool kept = live && keep[r] != 0;
  const float energy = init[2 * NJ];
  float viol_total = 0.0f, smooth_total = 0.0f;
  for (int s = 0; s < S; ++s) {
    int dynamics = dynamics_warp;
    asm volatile("" : "+r"(dynamics));
    const float* row = tab + s * TABLE_WIDTH;
    float u[NJ];
    if (dynamics) {
      select_noise(row, old, fresh, r, R, s, S, shift, do_shift, row0, row1, kept, live, u);
      if (s == S - 1) {  // no step reads the state after the horizon
        write_noise(row, noise, r, R, s, live, u);
        break;
      }
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
      write_noise(row, noise, r, R, s, live, u);  // after FK, which hid the loads' latency
      step_dynamics(P, q, v, u, K);
      float qv[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qv[j] = q[j];
        qv[NJ + j] = v[j];
      }
      ring.push(s, lane, qv);  // state s + 1
    } else {
      float step_viol, step_smooth;
      step_costs(P, q, v, energy, K, step_viol, step_smooth);
      add_trajectory_cost(P, K.ee_vel, row, step_smooth);
      if (P.enable_manipulability) step_smooth += manipulability_cost(P, K.J);
      viol_total += row[COL_DISC] * step_viol;
      smooth_total += row[COL_DISC] * step_smooth;
    }
  }
  if (!dynamics_warp && live) {
    costs[2 * r] = viol_total;
    costs[2 * r + 1] = smooth_total;
  }
}

}  // namespace

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int fsr_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int fsr_topology(int* out, int capacity) { return write_topology(out, capacity); }

// The longest horizon whose table and state ring fit in a block's shared
// memory, for the wrapper's check.
int fsr_max_steps() { return MAX_STEPS; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block; `seed` and `scale` are unused (the
// in-kernel-RNG kernel's launch takes the same arguments).
int fsr_launch(const void* params, const float* init, const float* table, const int* meta,
               const float* old, const float* fresh, const int* seed, const float* scale,
               const unsigned char* keep, float* noise, float* costs, float* states, int rollouts,
               int steps, void* stream) {
  const size_t shared = shared_bytes(steps);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pair_sample_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + LANES - 1) / LANES;
  pair_sample_rollout_kernel<<<blocks, PAIR, shared, (cudaStream_t)stream>>>(
      *static_cast<const Params*>(params), init, table, meta, old, fresh, keep, noise, costs,
      states, rollouts, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

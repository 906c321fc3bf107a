// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a), as a
// warp-specialised kernel: each group of 32 rollouts gets a pair of warps. A
// template over where the fresh noise comes from:
//
//   pair_sample_rollout_kernel<false>  fused_sample_rollout.cu (kernel 1),
//                                      reads it from a tensor (`fresh`);
//   pair_sample_rollout_kernel<true>   inkernel_rng_sample_rollout.cu
//                                      (kernel 3), draws it in the kernel from
//                                      the update's 2 seed words (`seed`) and
//                                      the 12 scales (`scale`).
//
// Per rollout r and horizon step s the kernel
//   1. picks the noise: elite rollouts (keep[r]) take their old noise shifted
//      left by `shift` with a fresh tail when `do_shift`, other rollouts take
//      fresh noise, rollout 0 takes 0 and rollout 1 takes -optimal[s]; the
//      chosen value is written out unchanged (bitwise the plain version's).
//      The in-kernel-RNG instantiation makes 12 fresh values in every row at
//      every step, and the select keeps them where the chain takes fresh
//      noise: 3 Philox4x32-10 calls on counter (r, s, c, 0) under the seed
//      words, 6 Box-Muller pairs, times scale[d] (philox.cuh, the twin of
//      kernels/philox.py), so the draws do not depend on the thread layout;
//   2. runs u = noise + optimal_shifted[s] through the Franka-Ridgeback step:
//      FK, the 7-term assisted-manipulation cost, CRBA mass matrix, implicit
//      PD + Coulomb friction diagonal, 12x12 Cholesky solve, semi-implicit
//      Euler;
//   3. accumulates disc[s] * (violations, smooth) in f32 in step order, and
//      streams rollout 0's pre-step (q, v).
//
// What holds one thread per rollout back on an H100 is latency: ~2.4 warps
// per SM at R = 10,000, under one per scheduler, and each warp's step is one
// long dependent stream at ~3.7 cycles per instruction. The design splits
// each step by what the next state needs. The next (q, v) depends only on FK
// and the dynamics; the cost terms, the noise output and rollout 0's states
// feed nothing later in the rollout. So:
//   - the dynamics warp holds q and v in registers and, per step, loads its
//     noise (the select; in <true> also the draws), runs forward_kinematics,
//     writes the noise out (after FK, so the loads land while it runs), runs
//     step_dynamics and pushes (q_{s+1}, v_{s+1}) into a ring of STAGES slots
//     in shared memory; it runs no cost term;
//   - the cost warp pops (q_s, v_s) (q_0, v_0 is `init`), runs
//     forward_kinematics on it with the same code, then step_costs,
//     add_trajectory_cost and manipulability_cost in order, accumulates the
//     discounted costs, streams rollout 0's states and writes the (R, 2)
//     costs at the end.
// The chain each step waits on is FK + dynamics (+ the draws in <true>); the
// cost terms run beside it on the other warp, up to STAGES steps behind.
// Both warps run one loop, FK in the part they share, so one copy of FK's
// code serves the pair: the step's code is ~125 KB of SASS, and with FK
// compiled once per warp the two streams together no longer fit the SM's
// instruction cache (PERF.md: that form ran slower than one thread per
// rollout). The pair is one block of 64 threads: 313 blocks, 4.7 warps per
// SM at R = 10,000. The last pair may hold fewer than 32 rollouts: its dead
// lanes (r >= R) run the loop on zero noise with no global load or store and
// arrive at every barrier, so no arrival count depends on R, and no thread
// leaves before the loop ends.
//
// Layout: noise tensors are rollout-minor (S, 12, R), so a warp's loads and
// stores for one (s, d) are coalesced. Shared memory holds the (S, 32)
// per-step table (trajectory target, its scalars, discount, optimal and
// shifted optimal), the state ring and its barriers; MAX_STEPS is the
// longest horizon that fits. Model and objective constants arrive as one
// by-value kernel parameter (Params), read through the constant cache; the
// robot's topology is compiled in (franka_step.cuh).

#pragma once

#include "franka_step.cuh"
#include "philox.cuh"
#include "pipeline.cuh"

namespace {

constexpr int TABLE_WIDTH = 32;   // floats per row of the per-step table
constexpr int COL_OPTIMAL = 7;    // 12: pre-shift optimal (rollout 1 = -this)
constexpr int COL_OPTSHIFT = 19;  // 12: shifted optimal (u = noise + this)
constexpr int STAGES = 4;         // state ring depth
using StateRing = Ring<STAGES, 2 * NJ>;
constexpr int MAX_STEPS =
    (int)((MAX_SHARED_BYTES - StateRing::BYTES) / (TABLE_WIDTH * sizeof(float)));

size_t shared_bytes(int steps) {
  return (size_t)steps * TABLE_WIDTH * sizeof(float) + StateRing::BYTES;
}

// The select chain of pallas_rollout.py:350-363 (:506-511 for the in-kernel
// draws) for one row and step: u gets the chosen noise. The fresh predicate
// does not depend on the dof, so a row loads all 12 values from one source,
// picked per row: fresh or old noise in kernel 1, old noise where it is kept
// in kernel 3, whose loads issue before its draws. Every row of kernel 3
// draws its 12 values at every step, outside any branch: a warp almost
// always holds both elite and fresh rows, and a draw under the fresh
// predicate made it run the draws and then the loads in turn; unconditional
// draws overlap the loads' latency and cost an elite row nothing its warp
// did not already spend.
template <bool INKERNEL_RNG>
__device__ __forceinline__ void select_noise(const float* row, const float* __restrict__ old,
                                             const float* __restrict__ fresh, unsigned int key0,
                                             unsigned int key1, const float* __restrict__ scale,
                                             int r, int R, int s, int S, int shift, bool do_shift,
                                             bool row0, bool row1, bool kept, bool live,
                                             float (&u)[NJ]) {
  const bool tail = s >= S - shift;
  const bool take_fresh = !row0 && !row1 && (!kept || (do_shift && tail));
  const int sidx = do_shift ? min(s + shift, S - 1) : s;
  const float* source = take_fresh ? fresh : old;
  const int source_step = take_fresh ? s : sidx;
  if (row0 || row1) {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = row0 ? 0.0f : -row[COL_OPTIMAL + d];
  } else if (live && (!INKERNEL_RNG || !take_fresh)) {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = source[((size_t)source_step * NJ + d) * R + r];
  } else {
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = 0.0f;
  }
  if constexpr (INKERNEL_RNG) {
    float z[NJ];
    normal_draws((unsigned int)r, (unsigned int)s, key0, key1, scale, z);
    const bool drawn = live && take_fresh;
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = drawn ? z[d] : u[d];
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

// `fresh` is read by <false> only, `seed` and `scale` by <true> only (the
// other instantiation is given null pointers there); they come last, so
// <false>'s parameters sit where kernel 1's always did.
template <bool INKERNEL_RNG>
__global__ void __launch_bounds__(PAIR)
pair_sample_rollout_kernel(const Params P, const float* __restrict__ init,
                           const float* __restrict__ table, const int* __restrict__ meta,
                           const float* __restrict__ old, const float* __restrict__ fresh,
                           const unsigned char* __restrict__ keep, float* __restrict__ noise,
                           float* __restrict__ costs, float* __restrict__ states, int R, int S,
                           const int* __restrict__ seed, const float* __restrict__ scale) {
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
  unsigned int key0 = 0, key1 = 0;
  if constexpr (INKERNEL_RNG) {
    key0 = (unsigned int)seed[0];
    key1 = (unsigned int)seed[1];
  }
  const float energy = init[2 * NJ];
  float viol_total = 0.0f, smooth_total = 0.0f;
  for (int s = 0; s < S; ++s) {
    int dynamics = dynamics_warp;
    asm volatile("" : "+r"(dynamics));
    const float* row = tab + s * TABLE_WIDTH;
    float u[NJ];
    if (dynamics) {
      select_noise<INKERNEL_RNG>(row, old, fresh, key0, key1, scale, r, R, s, S, shift, do_shift,
                                 row0, row1, kept, live, u);
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

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block (void* keeps the internal-linkage type
// out of the exported signatures).
template <bool INKERNEL_RNG>
int launch_pair_sample_rollout(const void* params, const float* init, const float* table,
                               const int* meta, const float* old, const float* fresh,
                               const int* seed, const float* scale, const unsigned char* keep,
                               float* noise, float* costs, float* states, int rollouts, int steps,
                               void* stream) {
  const size_t shared = shared_bytes(steps);
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(pair_sample_rollout_kernel<INKERNEL_RNG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + LANES - 1) / LANES;
  pair_sample_rollout_kernel<INKERNEL_RNG><<<blocks, PAIR, shared, (cudaStream_t)stream>>>(
      *static_cast<const Params*>(params), init, table, meta, old, fresh, keep, noise, costs,
      states, rollouts, steps, seed, scale);
  return (int)cudaGetLastError();
}

}  // namespace

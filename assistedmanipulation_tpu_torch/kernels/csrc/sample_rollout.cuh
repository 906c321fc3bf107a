// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a), one
// thread per rollout: a template over where the fresh noise comes from.
//
//   sample_rollout_kernel<true>   inkernel_rng_sample_rollout.cu, draws it in
//                                 the kernel from the update's 2 seed words
//                                 (`seed`) and the 12 scales (`scale`);
//   sample_rollout_kernel<false>  reads the fresh noise from a tensor
//                                 (`fresh`). No library launches it: the
//                                 fused kernel (fused_sample_rollout.cu) runs
//                                 the same select chain and step on a pair of
//                                 warps per 32 rollouts instead.
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
//      kernels/philox.py);
//   2. runs u = noise + optimal_shifted[s] through the Franka-Ridgeback step of
//      franka_step.cuh: FK, the 7-term assisted-manipulation cost, CRBA mass
//      matrix, implicit PD + Coulomb friction diagonal, 12x12 Cholesky solve,
//      semi-implicit Euler;
//   3. accumulates disc[s] * (violations, smooth) in f32 in step order, and
//      thread 0 streams rollout 0's pre-step (q, v).
//
// Layout: noise tensors are rollout-minor (S, 12, R), so thread r's loads and
// stores for one (s, d) are coalesced across the warp. The per-step table
// (S x 32 floats: trajectory target, its scalars, discount, optimal and
// shifted optimal) sits in shared memory, loaded once per block. Model and
// objective constants arrive as one by-value kernel parameter (Params), read
// through the constant cache. The robot's topology (parents, joint types,
// frame bodies, collision pairs) is compiled in; the wrapper checks the model
// against the library's topology export before the first launch.
//
// It is a first, simple design: one thread per rollout leaves an H100 with
// ~2.4 warps per SM at R = 10,000, the loops over joints are generic (no
// folding of the model's structural zeros) and the live set exceeds the
// register file, so it spills. The draws go straight into u[] and the noise
// output, so their live range stays inside the step.

#pragma once

#include "franka_step.cuh"
#include "philox.cuh"

namespace {

constexpr int TABLE_WIDTH = 32;  // floats per row of the per-step table
constexpr int BLOCK = 64;        // threads per block: 157 blocks at R = 10,000
constexpr int COL_OPTIMAL = 7;   // 12: pre-shift optimal (rollout 1 = -this)
constexpr int COL_OPTSHIFT = 19; // 12: shifted optimal (u = noise + this)

template <bool INKERNEL_RNG>
__global__ void __launch_bounds__(BLOCK)
sample_rollout_kernel(const Params P, const float* __restrict__ init,
                      const float* __restrict__ table, const int* __restrict__ meta,
                      const float* __restrict__ old, const float* __restrict__ fresh,
                      const int* __restrict__ seed, const float* __restrict__ scale,
                      const unsigned char* __restrict__ keep, float* __restrict__ noise,
                      float* __restrict__ costs, float* __restrict__ states, int R, int S) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < S * TABLE_WIDTH; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int shift = meta[0];
  const bool do_shift = meta[1] != 0;
  const bool first = meta[2] != 0;  // this batch holds static rollouts 0 and 1
  const bool row0 = first && r == 0;
  const bool row1 = first && r == 1;
  const bool kept = keep[r] != 0;

  float q[NJ], v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    q[j] = init[j];
    v[j] = init[NJ + j];
  }
  const float energy = init[2 * NJ];
  float viol_total = 0.0f, smooth_total = 0.0f;

  for (int s = 0; s < S; ++s) {
    const float* row = tab + s * TABLE_WIDTH;
    if (r == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        states[s * 2 * NJ + j] = q[j];
        states[s * 2 * NJ + NJ + j] = v[j];
      }
    }
    // Noise select: the chain of pallas_rollout.py:350-363 (:506-511 for the
    // in-kernel draws). The fresh predicate does not depend on the dof, so a
    // row takes all 12 fresh values or none. Each sampled row loads from one
    // source, picked per row: fresh or old noise in the fused kernel, old
    // noise where it is kept in the in-kernel-RNG one, whose loads issue
    // before its draws. Every row of the in-kernel-RNG kernel draws its 12
    // values at every step, outside any branch: a warp almost always holds
    // both elite and fresh rows, and a draw under the fresh predicate made it
    // run the draws and then the loads in turn; unconditional draws overlap
    // the loads' latency and cost an elite row nothing its warp did not
    // already spend. The values go to u[] first and are written out after,
    // which keeps the loads apart from the stores.
    const bool tail = s >= S - shift;
    const bool take_fresh = !row0 && !row1 && (!kept || (do_shift && tail));
    const int sidx = do_shift ? min(s + shift, S - 1) : s;
    const float* source = take_fresh ? fresh : old;
    const int source_step = take_fresh ? s : sidx;
    float u[NJ];
    if (row0 || row1) {
#pragma unroll
      for (int d = 0; d < NJ; ++d) u[d] = row0 ? 0.0f : -row[COL_OPTIMAL + d];
    } else if (!INKERNEL_RNG || !take_fresh) {
#pragma unroll
      for (int d = 0; d < NJ; ++d) u[d] = source[((size_t)source_step * NJ + d) * R + r];
    }
    if constexpr (INKERNEL_RNG) {
      float z[NJ];
      normal_draws((unsigned int)r, (unsigned int)s, (unsigned int)seed[0], (unsigned int)seed[1],
                   scale, z);
#pragma unroll
      for (int d = 0; d < NJ; ++d) u[d] = take_fresh ? z[d] : u[d];
    }
#pragma unroll
    for (int d = 0; d < NJ; ++d) {
      noise[((size_t)s * NJ + d) * R + r] = u[d];
      u[d] += row[COL_OPTSHIFT + d];
    }
    float step_viol, step_smooth;
    step(P, q, v, u, energy, row, step_viol, step_smooth);
    viol_total += row[COL_DISC] * step_viol;
    smooth_total += row[COL_DISC] * step_smooth;
  }
  costs[2 * r] = viol_total;
  costs[2 * r + 1] = smooth_total;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block (void* keeps the internal-linkage type
// out of the exported signatures); the instantiation that does not read
// `fresh` (or `seed` and `scale`) is given null pointers there.
template <bool INKERNEL_RNG>
int launch_sample_rollout(const void* params, const float* init, const float* table,
                          const int* meta, const float* old, const float* fresh, const int* seed,
                          const float* scale, const unsigned char* keep, float* noise,
                          float* costs, float* states, int rollouts, int steps, void* stream) {
  const size_t shared = (size_t)steps * TABLE_WIDTH * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sample_rollout_kernel<INKERNEL_RNG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + BLOCK - 1) / BLOCK;
  sample_rollout_kernel<INKERNEL_RNG><<<blocks, BLOCK, shared, (cudaStream_t)stream>>>(
      *static_cast<const Params*>(params), init, table, meta, old, fresh, seed, scale, keep, noise,
      costs, states, rollouts, steps);
  return (int)cudaGetLastError();
}

}  // namespace

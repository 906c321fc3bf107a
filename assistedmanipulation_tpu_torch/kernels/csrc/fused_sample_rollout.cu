// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a).
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::
// _fused_sample_rollout_kernel (the TPU kernel of the serving solve). Per
// rollout r and horizon step s it
//   1. picks the noise: elite rollouts (keep[r]) take their old noise shifted
//      left by `shift` with a fresh tail when `do_shift`, other rollouts take
//      fresh noise, rollout 0 takes 0 and rollout 1 takes -optimal[s]; the
//      chosen value is written out unchanged (bitwise the plain version's);
//   2. runs u = noise + optimal_shifted[s] through the Franka-Ridgeback step:
//      FK, the 7-term assisted-manipulation cost, CRBA mass matrix, implicit
//      PD + Coulomb friction diagonal, 12x12 Cholesky solve, semi-implicit
//      Euler;
//   3. accumulates disc[s] * (violations, smooth) in f32 in step order, and
//      thread 0 streams rollout 0's pre-step (q, v).
// The plain PyTorch version is kernels/cuda_rollout.py::
// fused_sample_rollout_reference; the wrapper is fused_sample_rollout. The
// step body (topology, Params, step()) is shared with rollout.cu through
// franka_step.cuh.
//
// Layout: noise tensors are rollout-minor (S, 12, R), so thread r's loads and
// stores for one (s, d) are coalesced across the warp. The per-step table
// (S x 32 floats: trajectory target, its scalars, discount, optimal and
// shifted optimal) sits in shared memory, loaded once per block. Model and
// objective constants arrive as one by-value kernel parameter (Params), read
// through the constant cache. The robot's topology (parents, joint types,
// frame bodies, collision pairs) is compiled in; the wrapper checks the
// model against fsr_topology() before the first launch.
//
// What bounds it on an H100: arithmetic. One rollout-step needs at least
// 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_tpu/ops/
// flops.py), so 10,000 x 50 is ~1.65 G instructions, ~49 us at 132 SMs x 128
// lanes x 1.98 GHz; the three noise streams are 72 MB, ~21 us at 3.35 TB/s.
// The design keeps the 24 state floats in registers for the whole horizon,
// reads each noise element at most once (a branch picks the one source the
// select chain needs) and writes it once. It is a first, simple version:
// one thread per rollout leaves an H100 with ~2.4 warps per SM at R = 10,000,
// the loops over joints are generic (no folding of the model's structural
// zeros) and the live set exceeds the register file, so it spills. The
// measured time beside the bound is in PERF.md.

#include "franka_step.cuh"

namespace {

constexpr int TABLE_WIDTH = 32;  // floats per row of the per-step table
constexpr int BLOCK = 64;        // threads per block: 157 blocks at R = 10,000
constexpr int COL_OPTIMAL = 7;   // 12: pre-shift optimal (rollout 1 = -this)
constexpr int COL_OPTSHIFT = 19; // 12: shifted optimal (u = noise + this)

__global__ void __launch_bounds__(BLOCK)
fused_sample_rollout_kernel(const Params P, const float* __restrict__ init,
                            const float* __restrict__ table, const int* __restrict__ meta,
                            const float* __restrict__ old, const float* __restrict__ fresh,
                            const unsigned char* __restrict__ keep, float* __restrict__ noise,
                            float* __restrict__ costs, float* __restrict__ states, int R,
                            int S) {
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
    // Noise select: the chain of pallas_rollout.py:350-363, reading only the
    // source it picks.
    const int sidx = min(s + shift, S - 1);
    const bool tail = s >= S - shift;
    float u[NJ];
#pragma unroll
    for (int d = 0; d < NJ; ++d) {
      const size_t at = ((size_t)s * NJ + d) * R + r;
      float n;
      if (row0) {
        n = 0.0f;
      } else if (row1) {
        n = -row[COL_OPTIMAL + d];
      } else if (!kept || (do_shift && tail)) {
        n = fresh[at];
      } else if (do_shift) {
        n = old[((size_t)sidx * NJ + d) * R + r];
      } else {
        n = old[at];
      }
      noise[at] = n;
      u[d] = n + row[COL_OPTSHIFT + d];
    }
    float step_viol, step_smooth;
    step(P, q, v, u, energy, row, step_viol, step_smooth);
    viol_total += row[COL_DISC] * step_viol;
    smooth_total += row[COL_DISC] * step_smooth;
  }
  costs[2 * r] = viol_total;
  costs[2 * r + 1] = smooth_total;
}

}  // namespace

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int fsr_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int fsr_topology(int* out, int capacity) { return write_topology(out, capacity); }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block (void* keeps the internal-linkage type
// out of this exported signature).
int fsr_launch(const void* params, const float* init, const float* table, const int* meta,
               const float* old, const float* fresh, const unsigned char* keep, float* noise,
               float* costs, float* states, int rollouts, int steps, void* stream) {
  const size_t shared = (size_t)steps * TABLE_WIDTH * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_sample_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + BLOCK - 1) / BLOCK;
  fused_sample_rollout_kernel<<<blocks, BLOCK, shared, (cudaStream_t)stream>>>(
      *static_cast<const Params*>(params), init, table, meta, old, fresh, keep, noise, costs,
      states, rollouts, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

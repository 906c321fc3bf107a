// Two-pass MPPI rollout + cost for NVIDIA Hopper (sm_90a).
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::_rollout_kernel
// (the TPU kernel of the two-pass sampler, the scenario ensemble and long
// horizons; calls at pallas_rollout.py:615, :978 and, chunked, :1071). Per
// rollout r and horizon step s it runs the given absolute control
// u = controls[s, :, r] through the Franka-Ridgeback step of franka_step.cuh,
// accumulates disc[s] * (violations, smooth) in f32 in step order, and
// thread 0 streams rollout 0's pre-step (q, v). The noise is assembled (and
// the shifted optimal added) before the launch, in plain PyTorch, as the JAX
// package does outside its kernel (lane_noise_assemble). The plain PyTorch
// version is kernels/cuda_rollout.py::rollout_reference; the wrapper is
// rollout.
//
// Layout: controls are rollout-minor (S, 12, R), so thread r's loads for one
// (s, d) are coalesced across the warp. The per-step table (S x 8 floats:
// trajectory target, its scalars, discount, padding) sits in dynamic shared
// memory, 32 B a step, so one block holds up to 7,264 steps.
//
// One loop over any S: the TPU kernel splits long horizons into chunks over
// a second grid axis only to keep its VMEM tiles wide, and that chunking
// carries two faults this kernel cannot have (stale chunked rollout-0 states
// on the TPU, and zero-discount pad steps whose inf/NaN still poisons a
// cost). Here q and v stay in registers for the whole horizon and no step
// beyond S runs.
//
// What bounds it on an H100: arithmetic, as kernel 1. One rollout-step needs
// at least 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_
// tpu/ops/flops.py), so 10,000 x 50 is ~1.65 G instructions, ~49 us at 132
// SMs x 128 lanes x 1.98 GHz; reading the controls once is 24 MB, ~7 us at
// 3.35 TB/s. Like kernel 1 it is a first, simple version (one thread per
// rollout, generic joint loops, register-capped); its measured time beside
// the bound is in PERF.md.

#include "franka_step.cuh"

namespace {

constexpr int TABLE_WIDTH = 8;  // floats per row: target (3), inv2, pcost, vtarget, disc, pad
constexpr int BLOCK = 64;       // threads per block: 157 blocks at R = 10,000

__global__ void __launch_bounds__(BLOCK)
rollout_kernel(const Params P, const float* __restrict__ init, const float* __restrict__ table,
               const float* __restrict__ controls, float* __restrict__ costs,
               float* __restrict__ states, int R, int S) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < S * TABLE_WIDTH; i += blockDim.x) tab[i] = table[i];
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
    float u[NJ];
#pragma unroll
    for (int d = 0; d < NJ; ++d) u[d] = controls[((size_t)s * NJ + d) * R + r];
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
int ro_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int ro_topology(int* out, int capacity) { return write_topology(out, capacity); }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `params` points at a Params block. A table larger than a block's shared
// memory makes cudaFuncSetAttribute (or the launch) fail, and that error is
// returned; the wrapper refuses such horizons before calling.
int ro_launch(const void* params, const float* init, const float* table, const float* controls,
              float* costs, float* states, int rollouts, int steps, void* stream) {
  const size_t shared = (size_t)steps * TABLE_WIDTH * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rollouts + BLOCK - 1) / BLOCK;
  rollout_kernel<<<blocks, BLOCK, shared, (cudaStream_t)stream>>>(
      *static_cast<const Params*>(params), init, table, controls, costs, states, rollouts, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

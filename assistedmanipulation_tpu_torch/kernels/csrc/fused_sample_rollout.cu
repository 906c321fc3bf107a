// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a), as a
// warp-specialised kernel: each group of 32 rollouts gets a pair of warps.
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::
// _fused_sample_rollout_kernel (the TPU kernel of the serving solve). The
// kernel is pair_sample_rollout_kernel<false> of sample_rollout.cuh, which
// reads the fresh noise from a tensor (its design: that header's note). The
// plain PyTorch version is kernels/cuda_rollout.py::
// fused_sample_rollout_reference; the wrapper is fused_sample_rollout. The
// step body (topology, Params, forward_kinematics, step_costs,
// step_dynamics) is franka_step.cuh's, shared with rollout.cu and the
// in-kernel-RNG kernel; the rings are pipeline.cuh's.
//
// What bounds it on an H100: arithmetic. One rollout-step needs at least
// 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_tpu/ops/
// flops.py), so 10,000 x 50 is ~1.65 G instructions, ~49 us at 132 SMs x 128
// lanes x 1.98 GHz; the three noise streams are 72 MB, ~21 us at 3.35 TB/s.
// What holds it back is latency, which the warp pair answers.
//
// Shared memory: the (S, 32) per-step table, the state ring and its
// barriers; fsr_max_steps() is the longest horizon that fits.

#include "sample_rollout.cuh"

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int fsr_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int fsr_topology(int* out, int capacity) { return write_topology(out, capacity); }

// The longest horizon whose table and state ring fit in a block's shared
// memory, for the wrapper's check.
int fsr_max_steps() { return MAX_STEPS; }

// Launch on `stream` (launch_pair_sample_rollout in sample_rollout.cuh);
// `seed` and `scale` are unused (the in-kernel-RNG kernel's launch takes the
// same arguments).
int fsr_launch(const void* params, const float* init, const float* table, const int* meta,
               const float* old, const float* fresh, const int* seed, const float* scale,
               const unsigned char* keep, float* noise, float* costs, float* states, int rollouts,
               int steps, void* stream) {
  return launch_pair_sample_rollout<false>(params, init, table, meta, old, fresh, nullptr,
                                           nullptr, keep, noise, costs, states, rollouts, steps,
                                           stream);
}

}  // extern "C"

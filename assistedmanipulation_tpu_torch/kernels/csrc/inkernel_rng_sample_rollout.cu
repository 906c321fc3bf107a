// Fused MPPI sampling (fresh draws made in the kernel) + noise assembly +
// rollout + cost for NVIDIA Hopper (sm_90a), on a warp pair per 32 rollouts.
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::
// _inkernel_rng_sample_rollout_kernel (call at pallas_rollout.py:1275, the
// serving solve with inkernel_rng=True). The kernel is
// pair_sample_rollout_kernel<true> of sample_rollout.cuh: the fused kernel's
// warp pair with the fresh-noise input gone; its dynamics warp draws 12
// values per row and step from Philox4x32-10 under the update's 2 seed words
// (philox.cuh), scales them by scale[d] and keeps them where the select
// chain picks fresh noise. The plain PyTorch version is
// kernels/cuda_rollout.py::inkernel_rng_sample_rollout_reference (kernel 1's
// plain version fed philox.normal_draws); the wrapper is
// inkernel_rng_sample_rollout.
//
// What bounds it on an H100: arithmetic. Per rollout-step kernel 1's 3,301
// FP32 instructions; per step that draws, 48 more for Box-Muller and the
// scaling and 24 transcendentals at 1/8 of the FP32 rate (192 slots), so
// 3,541 FP32 instruction slots, and 264 integer instructions of Philox and
// mantissa fill. At 10,000 x 50, all drawing: >= 52.9 us of FP32 issue at
// 132 SMs x 128 lanes x 1.98 GHz. It reads the old noise and writes the
// noise, 48 MB, 14.3 us at 3.35 TB/s, and never reads or writes a fresh-noise
// tensor (kernel 1 reads 24 MB of it, which torch.randn writes first). The
// draws sit on the dynamics warp's chain, beside the loads they overlap.

#include "sample_rollout.cuh"

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int irs_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int irs_topology(int* out, int capacity) { return write_topology(out, capacity); }

// The longest horizon whose table and state ring fit in a block's shared
// memory, for the wrapper's check.
int irs_max_steps() { return MAX_STEPS; }

// Launch on `stream` (launch_pair_sample_rollout in sample_rollout.cuh);
// `fresh` is unused, `seed` (2 int32) and `scale` (12 floats) stay on the
// device.
int irs_launch(const void* params, const float* init, const float* table, const int* meta,
               const float* old, const float* fresh, const int* seed, const float* scale,
               const unsigned char* keep, float* noise, float* costs, float* states, int rollouts,
               int steps, void* stream) {
  return launch_pair_sample_rollout<true>(params, init, table, meta, old, nullptr, seed, scale,
                                          keep, noise, costs, states, rollouts, steps, stream);
}

}  // extern "C"

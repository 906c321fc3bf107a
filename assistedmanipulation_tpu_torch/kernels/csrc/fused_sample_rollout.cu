// Fused MPPI noise assembly + rollout + cost for NVIDIA Hopper (sm_90a).
//
// Replaces assistedmanipulation_tpu/kernels/pallas_rollout.py::
// _fused_sample_rollout_kernel (the TPU kernel of the serving solve). The
// kernel is sample_rollout_kernel<false> of sample_rollout.cuh: it reads the
// fresh noise the select chain picks from the `fresh` tensor. The plain
// PyTorch version is kernels/cuda_rollout.py::fused_sample_rollout_reference;
// the wrapper is fused_sample_rollout. The step body (topology, Params,
// step()) is shared with rollout.cu through franka_step.cuh.
//
// What bounds it on an H100: arithmetic. One rollout-step needs at least
// 3,301 issued FP32 instructions (4,892 FLOPs, assistedmanipulation_tpu/ops/
// flops.py), so 10,000 x 50 is ~1.65 G instructions, ~49 us at 132 SMs x 128
// lanes x 1.98 GHz; the three noise streams are 72 MB, ~21 us at 3.35 TB/s.
// The design keeps the 24 state floats in registers for the whole horizon,
// reads each noise element at most once (a branch picks the one source the
// select chain needs) and writes it once. The measured time beside the bound
// is in PERF.md.

#include "sample_rollout.cuh"

extern "C" {

// sizeof(Params), for the wrapper to check its ctypes mirror.
int fsr_params_bytes() { return (int)sizeof(Params); }

// The compiled topology (write_topology in franka_step.cuh).
int fsr_topology(int* out, int capacity) { return write_topology(out, capacity); }

// Launch on `stream` (launch_sample_rollout in sample_rollout.cuh); `seed`
// and `scale` are unused.
int fsr_launch(const void* params, const float* init, const float* table, const int* meta,
               const float* old, const float* fresh, const int* seed, const float* scale,
               const unsigned char* keep, float* noise, float* costs, float* states, int rollouts,
               int steps, void* stream) {
  return launch_sample_rollout<false>(params, init, table, meta, old, fresh, seed, scale, keep,
                                      noise, costs, states, rollouts, steps, stream);
}

}  // extern "C"

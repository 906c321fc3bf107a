// FP32 issue-peak probe for NVIDIA Hopper (sm_90a).
//
// Replaces scripts/vpu_roofline.py::_chain_kernel (the microkernel the JAX
// package's roofline divided by). Per element i, with base = x[i],
// c = base * 0.9999999 and d = base * 1e-7 (runtime values, nothing to fold),
// A independent accumulators start at base + 0.001 a and each runs
// `iterations` x U dependent steps of acc * c + d (one FFMA; the FMA leg) or
// acc + d (one FADD; the add leg); out[i] is the mean of the accumulators,
// summed in order.
//
// One thread per element, the accumulators in registers. A and U are
// template parameters (1, 2, 4, 8, 16), so the U steps unroll into straight
// FFMA/FADD chains; the outer loop keeps `#pragma unroll 1`, so one pass of
// it issues exactly A x U FFMA (or FADD) instructions, which the probe's
// driver checks in the library's SASS (kernels/fp32_chain.py:
// loop_instruction_counts). Without --use_fast_math nvcc may neither fold
// the FMA chain nor reassociate the add chain; the add is __fadd_rn, because
// nvcc otherwise contracts d = base * 1e-7 into every add and issues the add
// leg as FFMAs (its first build on the card did). The start values are
// __fmul_rn/__fadd_rn for the same reason: rounded as the plain version
// rounds them, the add leg's output is bitwise the plain version's.
//
// What bounds it: FP32 issue, by construction. Every instruction of the loop
// is an FFMA or FADD and each thread's A chains are independent, so with
// A x (warps per scheduler) >= the FMA latency the card issues one of them
// per FP32 lane per cycle: 132 SMs x 128 lanes x the SM clock. The rate the
// driver measures is that denominator, shown on the card; it reads and
// writes 8 bytes per element.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 1024;  // threads per block: 2 blocks fill an SM's 2,048 threads

template <int A, int U, bool FMA>
__global__ void __launch_bounds__(BLOCK)
fp32_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int iterations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float base = x[i];
  const float c = base * 0.9999999f;
  const float d = base * 1e-7f;
  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = __fadd_rn(base, __fmul_rn(0.001f, (float)a));
#pragma unroll 1
  for (int k = 0; k < iterations; ++k) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int u = 0; u < U; ++u) acc[a] = FMA ? fmaf(acc[a], c, d) : __fadd_rn(acc[a], d);
    }
  }
  float total = acc[0];
#pragma unroll
  for (int a = 1; a < A; ++a) total = total + acc[a];
  out[i] = total * (1.0f / A);
}

template <int A, int U, bool FMA>
int launch(const float* x, float* out, int n, int iterations, cudaStream_t stream) {
  const int blocks = (n + BLOCK - 1) / BLOCK;
  fp32_chain_kernel<A, U, FMA><<<blocks, BLOCK, 0, stream>>>(x, out, n, iterations);
  return (int)cudaGetLastError();
}

template <int A, int U>
int launch_leg(const float* x, float* out, int n, int iterations, int fma, cudaStream_t stream) {
  return fma ? launch<A, U, true>(x, out, n, iterations, stream)
             : launch<A, U, false>(x, out, n, iterations, stream);
}

template <int A>
int launch_unroll(const float* x, float* out, int n, int iterations, int unroll, int fma,
                  cudaStream_t stream) {
  switch (unroll) {
    case 1: return launch_leg<A, 1>(x, out, n, iterations, fma, stream);
    case 2: return launch_leg<A, 2>(x, out, n, iterations, fma, stream);
    case 4: return launch_leg<A, 4>(x, out, n, iterations, fma, stream);
    case 8: return launch_leg<A, 8>(x, out, n, iterations, fma, stream);
    case 16: return launch_leg<A, 16>(x, out, n, iterations, fma, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Threads per block, for the wrapper's element count.
int fc_block() { return BLOCK; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for an accumulator count or unroll outside
// 1, 2, 4, 8, 16.
int fc_launch(const float* x, float* out, int n, int iterations, int accumulators, int unroll,
              int fma, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (accumulators) {
    case 1: return launch_unroll<1>(x, out, n, iterations, unroll, fma, s);
    case 2: return launch_unroll<2>(x, out, n, iterations, unroll, fma, s);
    case 4: return launch_unroll<4>(x, out, n, iterations, unroll, fma, s);
    case 8: return launch_unroll<8>(x, out, n, iterations, unroll, fma, s);
    case 16: return launch_unroll<16>(x, out, n, iterations, unroll, fma, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

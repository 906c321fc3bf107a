// Philox4x32-10 and the Box-Muller normal pair, device side: the twin of
// kernels/philox.py, so the CUDA kernel and the plain PyTorch version draw
// the same bits (Salmon et al., SC'11; the generator behind cuRAND's and
// PyTorch's Philox). Counter (rollout, step, call, 0), key = the update's 2
// seed words; see philox.py for the word order and the conversion, which is
// the TPU kernel's (assistedmanipulation_tpu/kernels/pallas_rollout.py:473-497).
//
// No --use_fast_math: logf, sqrtf, sinf and cosf are the accurate library
// functions (a few ulps from the plain version's), never __logf or __sinf.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct PhiloxWords {
  unsigned int w[4];
};

__host__ __device__ __forceinline__ PhiloxWords philox4x32_10(unsigned int c0, unsigned int c1,
                                                              unsigned int c2, unsigned int c3,
                                                              unsigned int k0, unsigned int k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned long long p0 = 0xD2511F53ull * c0;
    const unsigned long long p1 = 0xCD9E8D57ull * c2;
    const unsigned int hi0 = (unsigned int)(p0 >> 32), lo0 = (unsigned int)p0;
    const unsigned int hi1 = (unsigned int)(p1 >> 32), lo1 = (unsigned int)p1;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return PhiloxWords{{c0, c1, c2, c3}};
}

// A uniform in (0, 1] from 32 random bits by mantissa fill.
__device__ __forceinline__ float philox_uniform(unsigned int bits) {
  return 2.0f - __uint_as_float((bits >> 9) | 0x3F800000u);
}

// One Box-Muller pair from two words: (r cos theta, r sin theta).
__device__ __forceinline__ void box_muller(unsigned int bits1, unsigned int bits2, float& z0,
                                           float& z1) {
  const float radius = sqrtf(-2.0f * logf(philox_uniform(bits1)));
  const float theta = 0x1.921fb6p+2f * philox_uniform(bits2);  // float32(2 pi) * u2
  z0 = radius * cosf(theta);
  z1 = radius * sinf(theta);
}

}  // namespace

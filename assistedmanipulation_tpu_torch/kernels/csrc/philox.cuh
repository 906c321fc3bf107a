// Philox4x32-10 and the Box-Muller normal pair, device side: the twin of
// kernels/philox.py, so the CUDA kernel and the plain PyTorch version draw
// the same bits (Salmon et al., SC'11; the generator behind cuRAND's and
// PyTorch's Philox). Counter (rollout, step, call, 0), key = the update's 2
// seed words; see philox.py for the word order and the conversion, which is
// the TPU kernel's (assistedmanipulation_tpu/kernels/pallas_rollout.py:473-497).
//
// No --use_fast_math: logf, sqrtf and sincospif are the accurate library
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

// One Box-Muller pair from two words: (r cos theta, r sin theta) with
// theta = pi x, x = 2 u2 (exact). sincospif gives both values from one
// argument reduction, which in half turns is exact: no Payne-Hanek slow path
// (sincosf keeps one per call, with a local array, for arguments no draw
// reaches) and 376 fewer SASS instructions per rollout-step than sincosf of
// float32(2 pi) u2 (scripts/torch_sass_census.py).
__device__ __forceinline__ void box_muller(unsigned int bits1, unsigned int bits2, float& z0,
                                           float& z1) {
  const float radius = sqrtf(-2.0f * logf(philox_uniform(bits1)));
  float s, c;
  sincospif(2.0f * philox_uniform(bits2), &s, &c);
  z0 = radius * c;
  z1 = radius * s;
}

// The 12 normal draws of rollout r at step s: 3 Philox calls on counter
// (r, s, call, 0) under the seed words, 6 Box-Muller pairs, times scale[d].
// Both loops stay rolled: unrolled, they are ~400 SASS instructions more in
// a step loop that already fills the instruction cache, and the in-kernel-
// RNG kernel ran 26% slower (PERF.md). The constant indices into z keep it
// in registers.
__device__ __forceinline__ void normal_draws(unsigned int r, unsigned int s, unsigned int key0,
                                             unsigned int key1, const float* scale,
                                             float (&z)[12]) {
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    const PhiloxWords words = philox4x32_10(r, s, (unsigned int)c, 0u, key0, key1);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float z0, z1;
      box_muller(h ? words.w[2] : words.w[0], h ? words.w[3] : words.w[1], z0, z1);
      const int d = 4 * c + 2 * h;
      z0 *= scale[d];
      z1 *= scale[d + 1];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (d == 2 * k) {
          z[2 * k] = z0;
          z[2 * k + 1] = z1;
        }
      }
    }
  }
}

}  // namespace

// Shared-memory rings between two warps of one block, guarded by Hopper
// mbarriers (sm_90): the producer/consumer pattern of a warp-specialised
// kernel, for values that one warp computes and another reads.
//
// A ring has STAGES slots; item i of the stream lives in slot i % STAGES and
// is the (i / STAGES)-th use of that slot. Each slot has a `full` barrier
// (the producer's lanes arrive once they have written the slot) and an
// `empty` one (the consumer's lanes arrive once they have read it), both
// initialised for LANES arrivals: every lane of the warp arrives, live or
// not, so no count depends on how many lanes hold work. A barrier's phase
// flips each time its arrivals complete; `try_wait.parity` with parity p
// returns once the phase of parity p has completed, so the consumer of item
// i waits on full with parity (i / STAGES) & 1 and the producer on empty
// with the opposite parity, which a fresh barrier passes at once (the slot
// starts empty).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
// Threads per block of a warp pair: the dynamics warp, then the cost warp.
constexpr int PAIR = 2 * LANES;

// The mbarrier primitives, in PTX. scripts/emulate_kernels.py compiles this
// header with g++ and defines EMULATED_MBARRIERS, supplying atomic stand-ins
// with the same parity semantics.
#ifndef EMULATED_MBARRIERS

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return (uint32_t)__cvta_generic_to_shared(pointer);
}

// One thread initialises a barrier for `count` arrivals per phase; the
// block fences (mbarrier_init_fence) and synchronises before any use.
__device__ __forceinline__ void mbarrier_init(uint64_t* barrier, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(barrier)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This thread's arrival (release: its earlier shared-memory writes and reads
// are ordered before the phase completes).
__device__ __forceinline__ void mbarrier_arrive(uint64_t* barrier) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_address(barrier)) : "memory");
}

// Block until the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void mbarrier_wait(uint64_t* barrier, unsigned parity) {
  const uint32_t address = shared_address(barrier);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(address), "r"(parity)
        : "memory");
  }
}

#endif  // EMULATED_MBARRIERS

// A ring of STAGES slots of WIDTH floats per lane, laid out
// [stage][WIDTH][LANES] so that lane l touches only bank l, with its
// barriers. `data` and `barriers` point into shared memory.
template <int STAGES, int WIDTH>
struct Ring {
  float* data;         // STAGES * WIDTH * LANES floats
  uint64_t* barriers;  // full[STAGES], then empty[STAGES]

  static constexpr int FLOATS = STAGES * WIDTH * LANES;
  static constexpr int BARRIERS = 2 * STAGES;
  static constexpr size_t BYTES = FLOATS * sizeof(float) + BARRIERS * sizeof(uint64_t);

  __device__ __forceinline__ uint64_t* full(int slot) const { return barriers + slot; }
  __device__ __forceinline__ uint64_t* empty(int slot) const { return barriers + STAGES + slot; }

  // One thread of the block, before the fence and the block's barrier.
  __device__ __forceinline__ void init() const {
    for (int slot = 0; slot < STAGES; ++slot) {
      mbarrier_init(full(slot), LANES);
      mbarrier_init(empty(slot), LANES);
    }
  }

  // Producer: write item i's WIDTH values of this lane, then arrive.
  __device__ __forceinline__ void push(int i, int lane, const float (&values)[WIDTH]) const {
    const int slot = i % STAGES;
    mbarrier_wait(empty(slot), ((i / STAGES) & 1) ^ 1);
    float* out = data + slot * WIDTH * LANES + lane;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) out[k * LANES] = values[k];
    mbarrier_arrive(full(slot));
  }

  // Consumer: wait for item i, read this lane's WIDTH values, free the slot.
  __device__ __forceinline__ void pop(int i, int lane, float (&values)[WIDTH]) const {
    const int slot = i % STAGES;
    mbarrier_wait(full(slot), (i / STAGES) & 1);
    const float* in = data + slot * WIDTH * LANES + lane;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) values[k] = in[k * LANES];
    mbarrier_arrive(empty(slot));
  }
};

}  // namespace

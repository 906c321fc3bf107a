// The tracer's device stamp (assistedmanipulation_tpu_torch/tracing.py).
//
// One thread reads the device's global timer (%globaltimer: ns, the
// timebase the CUDA profiler stamps device operations with) and writes it to
// slots[index], in pinned host memory: the host reads it without a copy once
// it has seen the stream pass the kernel (a stream query or synchronise makes
// the write visible; a system fence here would double the kernel's cost). A
// device span's boundary is one such launch on the stream (tracing.mark); in
// a CUDA graph capture it becomes one kernel node. A kernel node is chosen
// over a timing event's record node for its cost: on an H100 a timing event's
// node added ~4.8 us to a replay of the serving update, this kernel ~1.2 us.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    *reinterpret_cast<volatile unsigned long long*>(slot) = now;
}

}  // namespace

extern "C" int tm_stamp(unsigned long long* slots, int index, cudaStream_t stream) {
    stamp_kernel<<<1, 1, 0, stream>>>(slots + index);
    return static_cast<int>(cudaGetLastError());
}

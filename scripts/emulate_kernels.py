#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, compiled by g++, against their
plain PyTorch versions: a rehearsal for machines without nvcc or a card.

    python3 scripts/emulate_kernels.py [--rollouts 256] [--steps 50]

Each ``kernels/csrc/<name>.cu`` is compiled as C++20, with the headers it
includes, a small stand-in ``cuda_runtime.h`` (the CUDA keywords as empty
macros, ``sincosf`` and ``sincospif`` from libm) and a launcher. Kernels
1-3 each run a producer/consumer pair of warps per 32 rollouts, which
threads run in turn cannot survive: the launcher runs each block's 64
threads as 64 host threads at once, ``__syncthreads`` as a
``std::barrier``, and the mbarrier primitives of ``pipeline.cuh`` as
atomics with the same parity semantics (``EMULATED_MBARRIERS``), so the
ring's slots, parities and arrival counts are the card's code. Each runs
at ``--rollouts``, at 33 (a last pair with one live lane) and kernel 2
also at 1 (one live lane per warp), kernel 2 at one scenario and at
chip_smoke's 4 in one launch (bitwise 4 one-scenario launches). The
outputs go through chip_smoke's ``compare`` against the plain versions in
float32 (float64 where it asks), on chip_smoke's inputs, under its
long-horizon rule at every horizon: g++ rounds otherwise than nvcc (no
FMA contraction), and at a few hundred rollouts one barrier-grazing
outlier is more than a share cap allows. The in-kernel-RNG kernel's noise
is held by chip_smoke's rule (non-fresh noise bitwise, fresh draws within
its tolerance of philox.normal_draws), which catches a Philox word-order
or counter fault. The FP32 chain kernel runs through its own exported
launcher (every ``<<<...>>>`` launch becomes a loop over blocks and
threads) against ``chain_reference``: the add leg bitwise, the FMA leg
within its tolerance (``fp32_chain.compare_to_reference``). This checks
the kernels' indexing, layouts, rings and parameter block and shows how
far float32 evaluations drift apart; it says nothing about the card's
speed or its compiler. A ring fault can hang it: run it under
``timeout``. Prints one JSON line per kernel and case; the libraries go to
build/emulate/. ``run_rollout``, ``run_fused`` and ``run_inkernel`` run
one case each (tests/test_torch_emulated_kernels.py).
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
struct dim3 { unsigned x, y, z; };
extern thread_local dim3 blockIdx, blockDim, threadIdx;
// The block's barrier when its threads run at once (kernel 1), else none.
inline thread_local std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { if (block_barrier) block_barrier->arrive_and_wait(); }
// mbarrier stand-ins: bits 0-31 the arrivals still pending in this phase,
// 32-62 the count per phase, 63 the phase; a wait for parity p returns once
// the phase bit differs from p (the phase of parity p has completed).
#define EMULATED_MBARRIERS
inline void mbarrier_init(uint64_t* barrier, unsigned count) {
  std::atomic_ref<uint64_t>(*barrier).store(((uint64_t)count << 32) | count);
}
inline void mbarrier_init_fence() {}
inline void mbarrier_arrive(uint64_t* barrier) {
  std::atomic_ref<uint64_t> word(*barrier);
  uint64_t old = word.load(), next;
  do {
    const uint64_t pending = (old & 0xffffffffu) - 1, count = (old >> 32) & 0x7fffffffu;
    next = pending ? (old & ~(uint64_t)0xffffffffu) | pending : (~old & (1ull << 63)) | (count << 32) | count;
  } while (!word.compare_exchange_weak(old, next));
}
inline void mbarrier_wait(uint64_t* barrier, unsigned parity) {
  std::atomic_ref<uint64_t> word(*barrier);
  while ((word.load() >> 63) == parity) std::this_thread::yield();
}
inline void sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }
inline void sincospif(float x, float* s, float* c) {
  *s = (float)std::sin(M_PI * (double)x);
  *c = (float)std::cos(M_PI * (double)x);
}
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
#define EMULATE_GRID(blocks, threads, ...) \
  for (unsigned b_ = 0; b_ < (unsigned)(blocks); ++b_) \
    for (unsigned t_ = 0; t_ < (unsigned)(threads); ++t_) { \
      blockIdx.x = b_; blockDim.x = (threads); threadIdx.x = t_; __VA_ARGS__; }
using std::min;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""

# Per kernel: the kernel function, the launcher's parameter list (chip_smoke's
# input order, then the outputs) and the kernel call's arguments after Params.
LAUNCHERS = {
    "rollout": (
        "pair_rollout_kernel<SCENARIOS>",
        "const float* init, const float* table, const float* controls, float* costs, float* states",
        "init, table, controls, costs, states, R, S",
    ),
    "fused_sample_rollout": (
        "pair_sample_rollout_kernel<false>",
        "const float* init, const float* table, const int* meta, const float* old, const float* fresh, "
        "const unsigned char* keep, float* noise, float* costs, float* states",
        "init, table, meta, old, fresh, keep, noise, costs, states, R, S, nullptr, nullptr",
    ),
    "inkernel_rng_sample_rollout": (
        "pair_sample_rollout_kernel<true>",
        "const float* init, const float* table, const int* meta, const float* old, "
        "const unsigned char* keep, const int* seed, const float* scale, float* noise, float* costs, "
        "float* states",
        "init, table, meta, old, nullptr, keep, noise, costs, states, R, S, seed, scale",
    ),
}
LAUNCH_SYNTAX = re.compile(r"<<<[^<>]*>>>")

# Each block's PAIR threads (a warp pair per 32 rollouts) run as host
# threads at once; the blocks run in turn.
LAUNCHER = r"""
#include "cuda_runtime.h"
#include <vector>
thread_local dim3 blockIdx, blockDim, threadIdx;
namespace { alignas(16) float tab[1 << 18]; }
#include "SOURCE"
extern "C" void emulate(const void* params, PARAMETERS, int R, int S) {
  for (unsigned b = 0; b < (unsigned)((R + LANES - 1) / LANES); ++b) {
    std::barrier<> block(PAIR);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (unsigned)PAIR; ++t)
      threads.emplace_back([&, t] {
        blockIdx.x = b;
        blockDim.x = PAIR;
        threadIdx.x = t;
        block_barrier = &block;
        KERNEL(*static_cast<const Params*>(params), ARGUMENTS);
      });
    for (std::thread& thread : threads) thread.join();
  }
}
"""
OUT = ROOT / "build" / "emulate"


def build(name: str, scenarios: int = 1, out: Path = OUT) -> ctypes.CDLL:
    """g++ the kernel source and its headers (their launch syntax removed)
    into a library under ``out``; the two-pass kernel at ``scenarios``
    scenarios."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(STUB)
    csrc = ROOT / "assistedmanipulation_tpu_torch" / "kernels" / "csrc"
    for path in (csrc / f"{name}.cu", *csrc.glob("*.cuh")):
        target = out / (f"{name}.cpp" if path.suffix == ".cu" else path.name)
        target.write_text(LAUNCH_SYNTAX.sub("", path.read_text()))
    kernel, parameters, arguments = LAUNCHERS[name]
    launcher = (LAUNCHER.replace("SOURCE", f"{name}.cpp").replace("PARAMETERS", parameters)
                .replace("ARGUMENTS", arguments).replace("KERNEL", kernel.replace("SCENARIOS", str(scenarios))))
    stem = f"emulate_{name}" + (f"_x{scenarios}" if scenarios > 1 else "")
    (out / f"{stem}.cpp").write_text(launcher)
    library = out / f"lib{stem}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-w",
         f"-I{out}", "-o", str(library), str(out / f"{stem}.cpp")],
        check=True,
    )
    return ctypes.CDLL(str(library))


def _spec():
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    return cr.RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01)


def _pointer(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def _double(inputs):
    return tuple(x.double() if x.is_floating_point() else x for x in inputs)


def run_rollout(libraries: dict, R: int, S: int, C: int, seed: int) -> dict:
    """Kernel 2 (``libraries[C]``) at R x S on C scenario tables against its
    plain version; at C > 1 each scenario also bitwise against a
    one-scenario launch (``libraries[1]``) on its table."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    spec = _spec()
    params = ctypes.byref(spec.kernel_params())
    init, tables, controls = inputs = chip_smoke.rollout_kernel_inputs(R, S, seed=seed, device="cpu", scenarios=C)
    costs = torch.full((C, R, 2) if C > 1 else (R, 2), float("nan"))
    states = torch.full((S, 24), float("nan"))
    libraries[C].emulate(params, *map(_pointer, (*inputs, costs, states)), R, S)
    line = {"kernel": "rollout", "rollouts": R, "steps": S, "scenarios": C}
    if C == 1:
        err = chip_smoke.compare(
            (None, costs, states), (None, *cr.rollout_reference(spec, *inputs)),
            lambda: (None, *cr.rollout_reference(spec, *_double(inputs))), drift=True,
        )
        return {**line, **err}
    err = chip_smoke.compare_scenarios(
        (costs, states), cr.rollout_reference(spec, *inputs),
        lambda: cr.rollout_reference(spec, *_double(inputs)), drift=True,
    )
    for c in range(C):
        single, single_states = torch.empty((R, 2)), torch.empty((S, 24))
        table = tables[c].contiguous()
        libraries[1].emulate(params, *map(_pointer, (init, table, controls, single, single_states)), R, S)
        if not (torch.equal(single, costs[c]) and torch.equal(single_states, states)):
            raise AssertionError(f"scenario {c}: the {C}-scenario kernel differs from the one-scenario kernel")
    return {**line, "bitwise_to_one_scenario_launches": True, **err}


def run_fused(library, R: int, S: int, shift: int, do_shift: bool) -> dict:
    """Kernel 1 at R x S and one (shift, do_shift) case against its plain
    version: noise bitwise, costs and states by ``compare``."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    spec = _spec()
    inputs = chip_smoke.kernel_inputs(R, shift, do_shift, seed=R + shift, device="cpu", steps=S)
    noise = torch.full_like(inputs[3], float("nan"))
    costs, states = torch.full((R, 2), float("nan")), torch.full((S, 24), float("nan"))
    library.emulate(ctypes.byref(spec.kernel_params()), *map(_pointer, (*inputs, noise, costs, states)), R, S)
    err = chip_smoke.compare(
        (noise, costs, states), cr.fused_sample_rollout_reference(spec, *inputs),
        lambda: cr.fused_sample_rollout_reference(spec, *_double(inputs)), drift=True,
    )
    return {"kernel": "fused_sample_rollout", "rollouts": R, "steps": S, "shift": shift, "do_shift": do_shift,
            **err}


def run_inkernel(library, R: int, S: int, shift: int, do_shift: bool) -> dict:
    """Kernel 3 at R x S and one (shift, do_shift) case, by chip_smoke's
    rule: non-fresh noise bitwise, fresh draws within its tolerance of
    philox.normal_draws, costs and states by ``compare``."""
    import chip_smoke

    spec = _spec()
    inputs = chip_smoke.inkernel_inputs(R, shift, do_shift, seed=R + shift, device="cpu", steps=S)
    noise = torch.full_like(inputs[3], float("nan"))
    costs, states = torch.full((R, 2), float("nan")), torch.full((S, 24), float("nan"))
    library.emulate(ctypes.byref(spec.kernel_params()), *map(_pointer, (*inputs, noise, costs, states)), R, S)
    err = chip_smoke.check_inkernel(spec, inputs, (noise, costs, states), drift=True)
    return {"kernel": "inkernel_rng_sample_rollout", "rollouts": R, "steps": S, "shift": shift,
            "do_shift": do_shift, **err}


def build_grid(name: str, out: Path = OUT) -> ctypes.CDLL:
    """g++ a kernel source whose launches become loops over the grid; its
    own exported functions run it."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(STUB)
    source = (ROOT / "assistedmanipulation_tpu_torch" / "kernels" / "csrc" / f"{name}.cu").read_text()
    source = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),[^>]*>>>\(([^;]*)\);",
                    r"EMULATE_GRID(\2, \3, \1(\4));", source)
    (out / f"{name}.cpp").write_text('#include "cuda_runtime.h"\nthread_local dim3 blockIdx, blockDim, threadIdx;\n' + source)
    library = out / f"libemulate_{name}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
         f"-I{out}", "-o", str(library), str(out / f"{name}.cpp")],
        check=True,
    )
    return ctypes.CDLL(str(library))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rollouts", type=int, default=256)
    parser.add_argument("--steps", type=int, default=50)
    args = parser.parse_args()
    R, S = args.rollouts, args.steps

    import chip_smoke

    rollout = {C: build("rollout", C) for C in (1, chip_smoke.SCENARIOS)}
    for rollouts in (R, 33, 1):
        for C, seed in ((1, 11), (chip_smoke.SCENARIOS, 12)):
            print(json.dumps(run_rollout(rollout, rollouts, S, C, seed)))

    library = build("fused_sample_rollout")
    for rollouts, (shift, do_shift) in [(R, case) for case in ((2, True), (0, False), (S, True))] + [(33, (2, True))]:
        print(json.dumps(run_fused(library, rollouts, S, shift, do_shift)))

    library = build("inkernel_rng_sample_rollout")
    for rollouts, (shift, do_shift) in [(R, case) for case in ((2, True), (0, False), (S, True))] + [(33, (2, True))]:
        print(json.dumps(run_inkernel(library, rollouts, S, shift, do_shift)))

    from assistedmanipulation_tpu_torch.kernels import fp32_chain

    library = build_grid("fp32_chain")
    x = 1.0 + 0.001 * torch.rand(2 * library.fc_block() + 17, generator=torch.Generator().manual_seed(0))
    for fma in (True, False):
        for accumulators in fp32_chain.CHOICES:
            for unroll in (1, fp32_chain.UNROLL):
                out = torch.empty_like(x)
                err = library.fc_launch(_pointer(x), _pointer(out), x.numel(), 3, accumulators, unroll,
                                        int(fma), None)
                want = fp32_chain.chain_reference(x, 3, accumulators, fma, unroll)
                if err:
                    raise AssertionError(f"fp32_chain fma={fma} A={accumulators} U={unroll}: error {err}")
                fp32_chain.compare_to_reference(out, want, fma, f"A={accumulators} U={unroll}")
                rel = float(((out - want).abs() / want.abs()).max())
                print(json.dumps({"kernel": "fp32_chain", "elements": x.numel(), "iterations": 3, "fma": fma,
                                  "accumulators": accumulators, "unroll": unroll, "max_rel_err": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, compiled by g++, against their
plain PyTorch versions: a rehearsal for machines without nvcc or a card.

    python3 scripts/emulate_kernels.py [--rollouts 256] [--steps 50]

Each ``kernels/csrc/<name>.cu`` is compiled as C++ with a small stand-in
``cuda_runtime.h`` (the CUDA keywords as empty macros, ``sincosf`` from
libm) and a launcher that runs every thread of every block in turn, the
block's shared table filled first. The outputs go through chip_smoke's
``compare`` against the plain versions in float32 (float64 where it asks),
on chip_smoke's inputs, under its long-horizon rule at every horizon: g++
rounds otherwise than nvcc (no FMA contraction), and at a few hundred
rollouts one barrier-grazing outlier is more than a share cap allows.
This checks the kernels' indexing, layouts and parameter block and shows
how far float32 evaluations drift apart; it says nothing about the card's
speed or its compiler. Prints one JSON line per kernel and case; the
libraries go to build/emulate/.
"""

import argparse
import ctypes
import json
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
typedef int cudaError_t;
enum { cudaSuccess = 0 };
typedef struct CUstream_st* cudaStream_t;
struct dim3 { unsigned x, y, z; };
extern dim3 blockIdx, blockDim, threadIdx;
inline void __syncthreads() {}
inline void sincosf(float x, float* s, float* c) { *s = std::sin(x); *c = std::cos(x); }
using std::min;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""

# Per kernel: the launcher's parameter list and the kernel call's arguments.
LAUNCHERS = {
    "rollout": (
        "const float* init, const float* table, const float* controls, float* costs, float* states",
        "init, table, controls, costs, states",
    ),
    "fused_sample_rollout": (
        "const float* init, const float* table, const int* meta, const float* old, const float* fresh, "
        "const unsigned char* keep, float* noise, float* costs, float* states",
        "init, table, meta, old, fresh, keep, noise, costs, states",
    ),
}

LAUNCHER = r"""
#include "cuda_runtime.h"
dim3 blockIdx, blockDim, threadIdx;
namespace { float tab[1 << 18]; }
#include "SOURCE"
extern "C" void emulate(const void* params, PARAMETERS, int R, int S) {
  for (int i = 0; i < S * TABLE_WIDTH; ++i) tab[i] = table[i];
  blockDim.x = BLOCK;
  for (unsigned b = 0; b < (unsigned)((R + BLOCK - 1) / BLOCK); ++b)
    for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      KERNEL(*static_cast<const Params*>(params), ARGUMENTS, R, S);
    }
}
"""


def build(name: str) -> ctypes.CDLL:
    """g++ the kernel source (its launch syntax removed) into a library."""
    out = ROOT / "build" / "emulate"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(STUB)
    csrc = ROOT / "assistedmanipulation_tpu_torch" / "kernels" / "csrc"
    source = (csrc / f"{name}.cu").read_text()
    (out / f"{name}.cpp").write_text(source.replace(
        "<<<blocks, BLOCK, shared, (cudaStream_t)stream>>>", ""))
    parameters, arguments = LAUNCHERS[name]
    launcher = (LAUNCHER.replace("SOURCE", f"{name}.cpp").replace("PARAMETERS", parameters)
              .replace("ARGUMENTS", arguments).replace("KERNEL", f"{name}_kernel"))
    (out / f"emulate_{name}.cpp").write_text(launcher)
    library = out / f"libemulate_{name}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
         f"-I{out}", f"-I{csrc}", "-o", str(library), str(out / f"emulate_{name}.cpp")],
        check=True,
    )
    return ctypes.CDLL(str(library))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rollouts", type=int, default=256)
    parser.add_argument("--steps", type=int, default=50)
    args = parser.parse_args()
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    R, S = args.rollouts, args.steps
    spec = cr.RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01)
    params = ctypes.byref(spec.kernel_params())

    def pointer(tensor):
        return ctypes.c_void_p(tensor.data_ptr())

    def double(inputs):
        return tuple(x.double() if x.is_floating_point() else x for x in inputs)

    library = build("rollout")
    inputs = chip_smoke.rollout_kernel_inputs(R, S, seed=11, device="cpu")
    costs, states = torch.empty((R, 2)), torch.empty((S, 24))
    library.emulate(params, *map(pointer, (*inputs, costs, states)), R, S)
    err = chip_smoke.compare(
        (None, costs, states), (None, *cr.rollout_reference(spec, *inputs)),
        lambda: (None, *cr.rollout_reference(spec, *double(inputs))), drift=True,
    )
    print(json.dumps({"kernel": "rollout", "rollouts": R, "steps": S, **err}))

    library = build("fused_sample_rollout")
    for shift, do_shift in ((2, True), (0, False), (S, True)):
        inputs = chip_smoke.kernel_inputs(R, shift, do_shift, seed=R + shift, device="cpu", steps=S)
        noise, costs, states = torch.empty_like(inputs[3]), torch.empty((R, 2)), torch.empty((S, 24))
        library.emulate(params, *map(pointer, (*inputs, noise, costs, states)), R, S)
        err = chip_smoke.compare(
            (noise, costs, states), cr.fused_sample_rollout_reference(spec, *inputs),
            lambda: cr.fused_sample_rollout_reference(spec, *double(inputs)), drift=True,
        )
        print(json.dumps({"kernel": "fused_sample_rollout", "rollouts": R, "steps": S,
                          "shift": shift, "do_shift": do_shift, **err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

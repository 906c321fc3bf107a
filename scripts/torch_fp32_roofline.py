#!/usr/bin/env python3
"""Measure the H100's FP32 issue peak on the port's chain kernel and set
kernels 1-3 against it (the port's counterpart of scripts/vpu_roofline.py).

    python3 scripts/torch_fp32_roofline.py [--iterations 2048] [--reps 30] [--blocks 5]

1. Kernels 1-3 at 10,000 rollouts x 50 steps: time per launch and
   instructions per launch (``cuda_rollout.STEP_FP32_INSTRUCTIONS`` per
   rollout-step, plus the draws' slots for the in-kernel-RNG kernel where its
   inputs draw). The in-kernel-RNG kernel also runs with every sampled row
   elite and no shift (no thread draws) and with no elite row (every sampled
   row draws at every step): the difference is what the draws cost.
2. ``fp32_chain.probe``: the SASS loop of every instantiation holds
   accumulators x unroll FFMA (FADD) instructions (cuobjdump); the FMA leg
   (acc * c + d, one FFMA) and the add leg (acc + d, one FADD) at 1, 2, 4, 8
   and 16 independent accumulators per thread, unroll 16, on 2,048 elements
   per SM, each rate the extra work of 4K over K iterations over the extra
   time (CUDA events over back-to-back launches, best of the blocks), while
   the SM clock is read every 0.25 s (the rate follows the clock under
   load); the peak of a leg is its largest rate, beside the nominal rate
   chip_smoke.py's bounds use (SMs x 128 lanes x max SM clock); kernels 1-3's
   issue rate against both.

Prints one JSON line; writes no file. Exits 1 if a SASS loop is not
accumulators x unroll of its leg. Needs a CUDA card; the card's name and
power limit are in the output.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=2048)
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--blocks", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fp32_roofline: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout, fp32_chain
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    build.build()
    card = chip_smoke.nvidia_smi("name,power.limit")
    spec = cuda_rollout.RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01)
    R, S = chip_smoke.SERVING_ROLLOUTS, chip_smoke.STEPS
    no_draws = chip_smoke.inkernel_inputs(R, 0, False, seed=9)
    no_draws[4][2:] = True
    all_draws = chip_smoke.inkernel_inputs(R, 0, False, seed=9)
    all_draws[4][:] = False
    inkernel = chip_smoke.inkernel_inputs(R, 2, True, seed=9)
    step_instructions = R * S * cuda_rollout.STEP_FP32_INSTRUCTIONS
    inkernel_launch = cuda_rollout.inkernel_rng_sample_rollout
    kernel_work = {}
    for name, launch, inputs, instructions in (
        ("fused_sample_rollout", cuda_rollout.fused_sample_rollout, chip_smoke.kernel_inputs(R, 2, True, seed=7),
         step_instructions),
        ("rollout", cuda_rollout.rollout, chip_smoke.rollout_kernel_inputs(R, S, seed=8), step_instructions),
        ("inkernel_rng_sample_rollout", inkernel_launch, inkernel, chip_smoke.inkernel_work(inkernel)[0]),
        ("inkernel_rng_sample_rollout_no_draws", inkernel_launch, no_draws, chip_smoke.inkernel_work(no_draws)[0]),
        ("inkernel_rng_sample_rollout_all_draws", inkernel_launch, all_draws,
         chip_smoke.inkernel_work(all_draws)[0]),
    ):
        for _ in range(3):
            launch(spec, *inputs)
        kernel_work[name] = (instructions, chip_smoke.time_call(lambda: launch(spec, *inputs), 50))

    n = fp32_chain.default_elements()
    report = fp32_chain.probe(torch.ones(n, device="cuda"), args.iterations, args.reps, args.blocks, kernel_work)
    print(json.dumps({"card": card, "sms": torch.cuda.get_device_properties(0).multi_processor_count, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

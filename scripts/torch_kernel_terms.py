#!/usr/bin/env python3
"""The fused sample+rollout CUDA kernel against its plain PyTorch version,
one cost term at a time.

    python3 scripts/torch_kernel_terms.py

For horizons S = 1, 3 and 50 at R = 10,000 (float32, random noise, no
shift), runs the kernel and the plain version with all seven objective
terms, with each term alone, and with none, and prints per configuration:
rollouts whose violation counts differ, the largest and 99th-percentile
relative error of the smooth cost, how many rollouts exceed 1e-4, and the
largest relative error of rollout 0's states. A fault in one term's
arithmetic shows at S = 1 in that term's row; float32 conditioning shows
only after many steps, in the terms with inverse barriers. Needs a CUDA card.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TERMS = (
    "enable_joint_limit", "enable_self_collision_limit", "enable_workspace_limit",
    "enable_velocity_cost", "enable_trajectory_cost", "enable_manipulability_cost",
)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_terms: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip())
    for steps in (1, 3, 50):
        chip_smoke.STEPS = steps
        inputs = chip_smoke.kernel_inputs(10_000, 0, False, seed=1)
        for only in ("all",) + TERMS + ("none",):
            cfg = (
                ObjectiveConfiguration() if only == "all"
                else ObjectiveConfiguration(**{term: term == only for term in TERMS})
            )
            spec = cuda_rollout.RolloutSpec(frankaridgeback_model(), cfg, fr.Configuration(), 0.01)
            _, costs_k, states_k = cuda_rollout.fused_sample_rollout(spec, *inputs)
            _, costs_p, states_p = cuda_rollout.fused_sample_rollout_reference(spec, *inputs)
            rel = (costs_k[:, 1] - costs_p[:, 1]).abs() / costs_p[:, 1].abs().clamp(min=1)
            states = ((states_k - states_p).abs() / states_p.abs().clamp(min=1)).max()
            print(
                f"S={steps:<3d} {only:28s} violations differ in "
                f"{int((costs_k[:, 0] != costs_p[:, 0]).sum())}; smooth rel max "
                f"{float(rel.max()):.3g} p99 {float(rel.quantile(0.99)):.3g} "
                f"above 1e-4 {int((rel > 1e-4).sum())}; states rel max {float(states):.3g}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

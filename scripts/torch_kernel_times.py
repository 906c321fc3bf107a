#!/usr/bin/env python3
"""Time the port's rollout kernels at the serving shape, for comparing two
checkouts on one card.

    python3 scripts/torch_kernel_times.py [--root DIR] [--label NAME] [--repeats 50]

Imports the package and ``chip_smoke`` from ``--root`` (default: this
checkout), builds its kernels and prints one JSON line of CUDA-event times
per launch at 10,000 rollouts x 50 steps, on ``chip_smoke``'s inputs:

- ``kernel1``: the fused kernel, shift 2 with a fresh tail, 20% elite rows;
- ``kernel3``: the in-kernel-RNG kernel on the same case, and on two
  bounding mixes: every row elite with no shift (no row takes a fresh draw)
  and no row elite (every row does);
- ``kernel2_x1``: the two-pass kernel at one scenario;
- ``kernel2_scenario_update``: the two-pass kernel's work in one update of
  the 4-scenario cell: one 4-scenario launch where the checkout's wrapper
  takes (C, S, 8) tables, else 4 one-scenario launches;
- ``kernel3_fresh_max_err_in_scale_units``: the every-row-drawing mix's
  noise against ``philox.normal_draws`` on the card (0 = bitwise);
- ``ptxas``: registers, stack and spill bytes of each library.

To compare a change with its parent, unpack the parent (``git archive``)
into a directory that .gitignore lists and run, in one call on the card,
parent, change, change, parent. Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

R, S, SCENARIOS = 10_000, 50, 4


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    parser.add_argument("--repeats", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels.philox import normal_draws
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    build_seconds = build.build(("fused_sample_rollout", "rollout", "inkernel_rng_sample_rollout"))
    spec = cr.RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01)

    def timed(fn):
        for _ in range(3):
            fn()
        return chip_smoke.time_call(fn, args.repeats)

    out = {"label": args.label, "root": str(args.root), "build_seconds": build_seconds}
    fused = chip_smoke.kernel_inputs(R, 2, True, seed=7)
    out["kernel1"] = timed(lambda: cr.fused_sample_rollout(spec, *fused))
    del fused
    init, table, meta, old, keep, words, scale = chip_smoke.inkernel_inputs(R, 2, True, seed=9)
    mixes = {
        "kernel3": (meta, keep),
        "kernel3_no_row_drawing": (torch.tensor([0, 0, 0], dtype=torch.int32, device="cuda"),
                                   torch.ones_like(keep)),
        "kernel3_every_row_drawing": (meta, torch.zeros_like(keep)),
    }
    for name, (mix_meta, mix_keep) in mixes.items():
        out[name] = timed(lambda: cr.inkernel_rng_sample_rollout(
            spec, init, table, mix_meta, old, mix_keep, words, scale))
    # The every-row-drawing mix's noise against the plain draws on the card,
    # in units of the scale (0 = bitwise).
    noise, _, _ = cr.inkernel_rng_sample_rollout(
        spec, init, table, meta, old, torch.zeros_like(keep), words, scale)
    fresh = normal_draws(words, S, R, scale)
    out["kernel3_fresh_max_err_in_scale_units"] = float(
        ((noise[:, :, 2:] - fresh[:, :, 2:]).abs() / scale.clamp(min=1e-30)[None, :, None]).max())
    del old, noise, fresh
    init, table, controls = chip_smoke.rollout_kernel_inputs(R, S, seed=8)
    out["kernel2_x1"] = timed(lambda: cr.rollout(spec, init, table, controls))
    tables = table.expand(SCENARIOS, -1, -1).contiguous()
    if hasattr(cr, "MAX_SCENARIOS"):
        out["kernel2_scenario_update"] = timed(lambda: cr.rollout(spec, init, tables, controls))
        out["kernel2_scenario_update_form"] = f"one {SCENARIOS}-scenario launch"
    else:
        out["kernel2_scenario_update"] = timed(lambda: [cr.rollout(spec, init, t, controls) for t in tables])
        out["kernel2_scenario_update_form"] = f"{SCENARIOS} one-scenario launches"
    out["ptxas"] = {name: chip_smoke.ptxas_summary(build.ptxas_report(name)) for name in build_seconds}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

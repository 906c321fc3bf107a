#!/usr/bin/env python3
"""Time the port's rollout kernels at the serving shape, for comparing two
checkouts on one card.

    python3 scripts/torch_kernel_times.py [--root DIR] [--label NAME] [--repeats 50] [--only KERNEL]
                                          [--widths 32,4224,8448] [--seeds 7,8,9]

Imports the package and ``chip_smoke`` from ``--root`` (default: this
checkout), builds its kernels and prints one JSON line of CUDA-event times
per launch at 10,000 rollouts x 50 steps, on ``chip_smoke``'s inputs:

- ``kernel1``: the fused kernel, shift 2 with a fresh tail, 20% elite rows;
  ``kernel1_s500`` the same case at 500 steps;
- ``kernel3``: the in-kernel-RNG kernel on the same case, and on two
  bounding mixes: every row elite with no shift (no row takes a fresh draw)
  and no row elite (every row does);
- ``kernel2_x1``: the two-pass kernel at one scenario;
- ``kernel2_scenario_update``: the two-pass kernel's work in one update of
  the 4-scenario cell, one 4-scenario launch;
- ``kernel2_r1``: the two-pass kernel at R = 1 x 50, the resimulate
  re-rollout's shape;
- ``kernel2_study_x1``, ``kernel2_study_x4``: at the scenario study's 52 x
  30, one scenario and 4 in one launch;
- ``kernel3_fresh_max_err_in_scale_units``: the every-row-drawing mix's
  noise against ``philox.normal_draws`` on the card (0 = bitwise);
- ``ptxas``: registers, stack and spill bytes of each library;
- ``hashes``: per kernel, a SHA-256 prefix of each output of one launch on
  its fixed inputs (kernel 1 and kernel 3's shift-2 case, kernel 2 at one
  and at 4 scenarios, at R = 1, at the study's shape and on chip_smoke.py
  phase 2's inputs at R = 1 and 33), so one call on
  two checkouts shows which kernels give bitwise the same noise, costs and
  states.

``--only kernel1`` (or ``kernel2``, ``kernel3``) builds, loads and times
that kernel alone in a fresh process: for comparing variants of it, and
for timing a kernel with no other library loaded before it. ``--widths``
also times each kernel timed (kernel 2 at one scenario) at those rollout
counts x 50 steps, the same cases at other widths (``widths``): with a warp
pair per 32 rollouts, 4,224 rollouts put one pair on each of the 132 SMs.
``--seeds`` times the same case at 10,000 rollouts on the inputs each
seed makes (``seeds``): a launch lasts as long as its slowest block, so a
time can depend on the data.

To compare a change with its parent, unpack the parent (``git archive``)
into a directory that .gitignore lists and run, in one call on the card,
parent, change, change, parent. Needs a CUDA card.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

R, S, LONG_S, SCENARIOS = 10_000, 50, 500, 4


def digests(outputs) -> list:
    """A SHA-256 prefix of each output tensor's bytes."""
    return [hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16] for t in outputs]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    parser.add_argument("--repeats", type=int, default=50)
    parser.add_argument("--only", choices=("kernel1", "kernel2", "kernel3"))
    parser.add_argument("--widths", default="", help="comma-separated rollout counts")
    parser.add_argument("--seeds", default="", help="comma-separated input seeds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout as cr
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )

    sections = {"kernel1": ("fused_sample_rollout", kernel1), "kernel3": ("inkernel_rng_sample_rollout", kernel3),
                "kernel2": ("rollout", kernel2)}
    if args.only:
        sections = {args.only: sections[args.only]}
    build_seconds = build.build(tuple(library for library, _ in sections.values()))
    spec = cr.RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01)

    def timed(fn):
        for _ in range(3):
            fn()
        return chip_smoke.time_call(fn, args.repeats)

    out = {"label": args.label, "root": str(args.root), "build_seconds": build_seconds, "hashes": {}}
    for _, section in sections.values():
        section(out, timed, spec)
    for option, key in ((args.widths, "widths"), (args.seeds, "seeds")):
        if option:
            values = [int(n) for n in option.split(",")]
            out[key] = {name: cases(name, key, values, timed, spec) for name in sections}
    out["ptxas"] = {name: chip_smoke.ptxas_summary(build.ptxas_report(name)) for name in build_seconds}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out))
    return 0


def kernel1(out: dict, timed, spec) -> None:
    """Kernel 1 at 50 and 500 steps, and its hash, into ``out``."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    fused = chip_smoke.kernel_inputs(R, 2, True, seed=7)
    out["kernel1"] = timed(lambda: cr.fused_sample_rollout(spec, *fused))
    out["hashes"]["kernel1"] = digests(cr.fused_sample_rollout(spec, *fused))
    fused = chip_smoke.kernel_inputs(R, 2, True, seed=7, steps=LONG_S)
    out["kernel1_s500"] = timed(lambda: cr.fused_sample_rollout(spec, *fused))


def kernel3(out: dict, timed, spec) -> None:
    """Kernel 3's three mixes, its draws' error and its hash, into ``out``."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels.philox import normal_draws

    hashes = out["hashes"]
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
    hashes["kernel3"] = digests(cr.inkernel_rng_sample_rollout(spec, init, table, meta, old, keep, words, scale))
    # The every-row-drawing mix's noise against the plain draws on the card,
    # in units of the scale (0 = bitwise).
    noise, _, _ = cr.inkernel_rng_sample_rollout(
        spec, init, table, meta, old, torch.zeros_like(keep), words, scale)
    fresh = normal_draws(words, S, R, scale)
    out["kernel3_fresh_max_err_in_scale_units"] = float(
        ((noise[:, :, 2:] - fresh[:, :, 2:]).abs() / scale.clamp(min=1e-30)[None, :, None]).max())


def kernel2(out: dict, timed, spec) -> None:
    """Kernel 2 at one and at 4 scenarios, at R = 1 and at the scenario
    study's shape, and its hashes, into ``out``."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    hashes = out["hashes"]
    init, table, controls = chip_smoke.rollout_kernel_inputs(R, S, seed=8)
    out["kernel2_x1"] = timed(lambda: cr.rollout(spec, init, table, controls))
    hashes["kernel2_x1"] = digests(cr.rollout(spec, init, table, controls))
    tables = table.expand(SCENARIOS, -1, -1).contiguous()
    out["kernel2_scenario_update"] = timed(lambda: cr.rollout(spec, init, tables, controls))
    hashes["kernel2_x4"] = digests(cr.rollout(spec, init, tables, controls))
    r1 = chip_smoke.rollout_kernel_inputs(1, S, seed=13)
    out["kernel2_r1"] = timed(lambda: cr.rollout(spec, *r1))
    hashes["kernel2_r1"] = digests(cr.rollout(spec, *r1))
    for C in (1, SCENARIOS):
        study = chip_smoke.rollout_kernel_inputs(
            chip_smoke.STUDY_ROLLOUTS, chip_smoke.STUDY_STEPS, seed=14, scenarios=C)
        out[f"kernel2_study_x{C}"] = timed(lambda: cr.rollout(spec, *study))
        hashes[f"kernel2_study_x{C}"] = digests(cr.rollout(spec, *study))
    # chip_smoke.py phase 2's partial-pair checks: R = 1 and 33, one
    # scenario and 4.
    for rollouts in (1, 33):
        for C, offset in ((1, 5), (SCENARIOS, 6)):
            small = chip_smoke.rollout_kernel_inputs(rollouts, S, seed=rollouts + offset, scenarios=C)
            hashes[f"kernel2_smoke_r{rollouts}_x{C}"] = digests(cr.rollout(spec, *small))


def cases(name: str, key: str, values: list, timed, spec) -> dict:
    """{value: ms per launch} of one kernel's timed case at each rollout
    count (``key`` "widths", its usual seed) or each input seed ("seeds",
    at R rollouts)."""
    import chip_smoke
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    launch, seed = {
        "kernel1": (lambda R, seed: (cr.fused_sample_rollout, chip_smoke.kernel_inputs(R, 2, True, seed)), 7),
        "kernel2": (lambda R, seed: (cr.rollout, chip_smoke.rollout_kernel_inputs(R, S, seed)), 8),
        "kernel3": (lambda R, seed: (cr.inkernel_rng_sample_rollout,
                                     chip_smoke.inkernel_inputs(R, 2, True, seed)), 9),
    }[name]
    out = {}
    for value in values:
        fn, inputs = launch(value, seed) if key == "widths" else launch(R, value)
        out[value] = timed(lambda: fn(spec, *inputs))
    return out


if __name__ == "__main__":
    sys.exit(main())

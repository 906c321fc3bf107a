#!/usr/bin/env python3
"""The readings each compared number's limit is set from (on the card).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 4 [--seconds 30]

For each seed it drives the cell's entry in one process, as a run does:
the program's first state and update 0, then the closed loop on to the
updates a run of ``--seconds`` would compare for that seed; the program's
updates are compared with the float64 reference (the lower readings).
For the first ``--control-seeds`` seeds it also puts the control in the
program's place: the reference computed in bfloat16, the nearest precision
below the configuration's float32, from the same states (the upper
readings). One JSON line per seed, then a summary line with each number's
largest program reading and smallest control reading. The cell's graph is
captured once and every seed's state is loaded into it. The window is not
timed: the closed loop runs only as far as the last compared update.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import update as reference  # noqa: E402


def diagnose(setup, program: dict, expected: dict) -> dict:
    """Where the widest smooth-cost gap sits: the gap, its rollout's cost
    over the batch's median and saturation count, and the median of the
    relative gaps."""
    p, r = program["costs"].double().to(expected["costs"].device), expected["costs"].double()
    ok = ~(torch.isnan(p).any(dim=1) | torch.isnan(r).any(dim=1)) & (p[:, 0] == r[:, 0])
    median = torch.median(r[ok, 1].abs())
    gaps = (p[:, 1] - r[:, 1]).abs() / torch.clamp(r[:, 1].abs(), min=median)
    gaps = torch.where(ok, gaps, torch.zeros_like(gaps))
    worst = int(torch.argmax(gaps))
    return {"widest_gap": gaps[worst].item(), "worst_rollout": worst,
            "worst_cost_over_median": (r[worst, 1].abs() / median).item(), "worst_violations": r[worst, 0].item(),
            "gap_p50": torch.quantile(gaps[ok], 0.5).item()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=4)
    parser.add_argument("--first-seed", type=int, default=4_000_000_007)
    parser.add_argument("--seconds", type=float, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    seconds = args.seconds or float(harness.read_json(ROOT / "BENCHMARK.json")["run_seconds"])
    seeds = [args.first_seed + 7919 * index for index in range(args.seeds)]
    calibrate(cell, seconds, seeds, args.control_seeds, "cuda")
    return 0


def calibrate(cell, seconds: float, seeds: list, control_seeds: int, device) -> dict:
    """Print each seed's readings and return the summary (see the module)."""
    setup = reference.Setup.from_config(cell.config, cell.traffic)
    loop = cell.loop.Loop(cell.config, cell.traffic, 0, seconds, device, torch.device(device).type == "cuda")
    lower, upper = {}, {}
    for index, seed in enumerate(seeds):
        t0 = time.perf_counter()
        loop.state, loop.k = loop.flagship.init(seed), 0
        samples = [(0, loop.snapshot(), None)]
        loop.cycle()
        samples[0] = (0, samples[0][1], loop.snapshot())
        first = 1 + int(cell.workload["warm_cycles"])
        for k in harness.sample_cycles(seed, cell.workload, seconds, first):
            while loop.k < k:
                loop.cycle()
            before = loop.snapshot()
            loop.cycle()
            samples.append((k, before, loop.snapshot()))
        driven = time.perf_counter() - t0
        expected_states = []
        readings = cell.loop.check(cell.config, cell.traffic, seed, samples, device, expected_out=expected_states)
        line = {"seed": seed, "updates": [k for k, _, _ in samples], "program": compare.worst(readings),
                "per_update": readings, "drive_s": driven, "check_s": time.perf_counter() - t0 - driven}
        line["diagnosis"] = [diagnose(setup, after, expected)
                             for (_, _, after), (_, expected) in zip(samples, expected_states)]
        controls = []
        if index < control_seeds:
            control = cell.loop.control_samples(cell.config, cell.traffic, seed, samples, device)
            controls = [compare.numbers(setup, after, expected)
                        for (_, _, after), (_, expected) in zip(control, expected_states)]
            line["control_diagnosis"] = [diagnose(setup, after, expected)
                                         for (_, _, after), (_, expected) in zip(control, expected_states)]
        for name, value in line["program"].items():
            lower[name] = max(lower.get(name, 0.0), value)
        if controls:
            line["control"] = compare.worst(controls)
            line["control_per_update"] = controls
            for name, value in line["control"].items():
                upper[name] = min(upper.get(name, float("inf")), value)
        print(json.dumps(line), flush=True)
    summary = {"workload": cell.name, "seeds": len(seeds), "control_seeds": min(control_seeds, len(seeds)),
               "lower": lower, "upper": upper,
               "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(main())

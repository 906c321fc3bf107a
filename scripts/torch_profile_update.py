#!/usr/bin/env python3
"""Where one flagship update of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_profile_update.py [--updates 30] [--scenarios 4] [--two-pass] [--inkernel-rng]

Runs ``build_flagship(scenarios=...)`` (10,000 rollouts x 50 steps; one
forecast scenario by default, on the fused sampler; more scenarios, or
``--two-pass``, take the two-pass sampler; ``--inkernel-rng`` the fused
sampler with its draws made in the kernel) on the CUDA card and prints one
JSON line with:

- the update's host wall time and its CUDA-event time, median over the run;
- a torch.profiler window over the same number of updates: device time per
  update by kernel name (top 12), the device's busy share of the window and
  the count of kernel launches per update;
- each part of ``Planner.update`` timed alone, back to back with CUDA
  events: ``_sample_meta``, the sampler's sample+rollout, ``_optimise``
  and its Savitzky-Golay smoothing (``sg_smooth``).

Needs a CUDA card; the card's name and power limit are in the output.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def events_ms(fn, repeats: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--updates", type=int, default=30)
    parser.add_argument("--scenarios", type=int, default=1)
    parser.add_argument("--two-pass", action="store_true")
    parser.add_argument("--inkernel-rng", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_update: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from assistedmanipulation_tpu_torch.kernels.philox import split_key
    from assistedmanipulation_tpu_torch.ops.sg_filter import sg_smooth
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    n = args.updates
    flagship = build_flagship(
        scenarios=args.scenarios, fused_assembly=False if args.two_pass else None,
        inkernel_rng=args.inkernel_rng,
    )
    planner, ctx, x0 = flagship.planner, flagship.make_ctx(), flagship.x0
    state = flagship.init(seed=0)
    times = torch.arange(1, 3 * n + 21, dtype=torch.float32, device="cuda") * 0.01
    tick = 0
    for _ in range(20):
        state, _ = flagship.update(state, x0, times[tick], ctx)
        tick += 1
    torch.cuda.synchronize()

    walls, event_ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = flagship.update(state, x0, times[tick], ctx)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        tick += 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = flagship.update(state, x0, times[tick], ctx)
            tick += 1
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    launches = 0
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0.0) or getattr(event, "self_cuda_time_total", 0.0)
        if device_us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((event.key, device_us / n / 1e3, event.count / n))
            launches += event.count
    kernels.sort(key=lambda item: -item[1])
    device_ms = sum(ms for _, ms, _ in kernels)

    # Each part alone, on the state the loop left.
    time_now = times[tick]
    meta = planner._sample_meta(state, time_now)
    optimal_shifted, shift_by, do_shift, _, keep_mask = meta
    sampler = planner.sampler
    seed = split_key(state.rng)[1]
    costs, noise, _ = sampler.sample_and_rollout(
        seed, keep_mask, shift_by, do_shift, state.noise, state.optimal_control,
        optimal_shifted, x0, time_now, ctx,
    )
    sg_shift = planner._sg_trim_offset(state, time_now)
    parts = {
        "sample_meta": events_ms(lambda: planner._sample_meta(state, time_now), n),
        "sample_and_rollout": events_ms(lambda: sampler.sample_and_rollout(
            seed, keep_mask, shift_by, do_shift, state.noise, state.optimal_control,
            optimal_shifted, x0, time_now, ctx), n),
        "optimise": events_ms(lambda: planner._optimise(
            costs, noise, optimal_shifted, state.sg_buffer, sg_shift), n),
        "sg_smooth": events_ms(lambda: sg_smooth(
            planner._smoother, state.sg_buffer, optimal_shifted, sg_shift), n),
    }
    print(json.dumps({
        "card": card,
        "rollouts": planner.rollout_count,
        "steps": planner.steps,
        "scenarios": args.scenarios,
        "fused_assembly": planner.sampler.fused_assembly,
        "inkernel_rng": planner.sampler.inkernel_rng,
        "updates": n,
        "update_wall_ms_median": statistics.median(walls),
        "update_event_ms_median": statistics.median(event_ms),
        "profile_window_ms_per_update": window_ms / n,
        "profile_device_ms_per_update": device_ms,
        "device_busy_share": device_ms / (window_ms / n),
        "kernel_launches_per_update": launches / n,
        "top_kernels_ms_per_update": [
            {"name": name[:90], "ms": ms, "calls": calls} for name, ms, calls in kernels[:12]
        ],
        "parts_alone_ms": parts,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

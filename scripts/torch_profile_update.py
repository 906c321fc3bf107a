#!/usr/bin/env python3
"""Where one flagship update (or one serving tick) of the PyTorch/CUDA port
spends its time.

    python3 scripts/torch_profile_update.py [--updates 30] [--scenarios 4] [--two-pass]
        [--inkernel-rng] [--resimulate] [--capture] [--serving] [--root DIR]

Runs ``build_flagship(scenarios=...)`` (10,000 rollouts x 50 steps; one
forecast scenario by default, on the fused sampler; more scenarios, or
``--two-pass``, take the two-pass sampler; ``--inkernel-rng`` the fused
sampler with its draws made in the kernel; ``--resimulate`` publishes the
re-rollout of each new optimal sequence) on the CUDA card. ``--capture``
replays one CUDA graph per update (``build_flagship(capture=True)``).
``--serving`` times the Kalman-driven serving tick instead (forecast
update, ``--scenarios`` draws, default 4, planner update), composed by hand
when eager so that a tree without ``make_serving_tick`` runs it too, and
with ``make_serving_tick(capture=True)`` when captured. ``--root`` imports
the package from another checkout (the parent's, unpacked with ``git
archive``), for before/after tables in one call.

Prints one JSON line with:

- host wall per update synchronised after each call, and its CUDA-event
  time, median over the run;
- solves/s: ``--updates`` back-to-back updates ending in one synchronise;
- a torch.profiler window over the same number of updates: device time per
  update by kernel name (top 12), the device's busy share of the window,
  device operations (kernels, copies) and host launch calls (a graph
  launch counts one) per update;
- eager only: each part of ``Planner.update`` timed alone, back to back
  with CUDA events: ``_sample_meta``, the sampler's sample+rollout,
  ``_optimise`` and its Savitzky-Golay smoothing (``sg_smooth``).

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

LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def events_ms(fn, repeats: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def make_step(args, device):
    """(flagship, step(k) running update or tick k, parts-alone fn or None)."""
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    options = {"scenarios": args.scenarios}
    if args.two_pass:
        options["fused_assembly"] = False
    if args.inkernel_rng:
        options["inkernel_rng"] = True
    if args.resimulate:
        options["optimal_rollout_mode"] = "resimulate"
    if args.capture and not args.serving:
        options["capture"] = True
    flagship = build_flagship(**options)
    times = torch.arange(1, 4 * args.updates + 41, dtype=torch.float32, device=device) * 0.01
    x0 = flagship.x0
    if not args.serving:
        ctx, carry = flagship.make_ctx(), [flagship.init(seed=0)]

        def step(k):
            carry[0], _ = flagship.update(carry[0], x0, times[k], ctx)

        return flagship, step, (lambda k: parts_alone(flagship, carry[0], times[k], ctx, args.updates))

    from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
    from assistedmanipulation_tpu_torch.forecast.scenarios import sample_scenarios
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext

    steps = flagship.planner.steps
    strategy = KalmanForecast(KalmanForecastConfiguration(
        time_step=0.01, horizon=steps * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    generator = torch.Generator(device=device).manual_seed(3)
    wrench = torch.zeros((len(times), 6), dtype=torch.float32, device=device)
    wrench[:, 0] = 20.0
    wrench[:, 1] = 2.0 * torch.sin(2 * torch.pi * times)
    carry = [strategy.init(device=device), flagship.init(seed=1)]
    if args.capture:
        from assistedmanipulation_tpu_torch.parallel.flagship import make_serving_tick

        tick = make_serving_tick(flagship, strategy, args.scenarios, generator, capture=True)

        def step(k):
            carry[0], carry[1], _, _ = tick(carry[0], carry[1], x0, wrench[k], times[k])
    else:
        def step(k):
            carry[0] = strategy.update(carry[0], wrench[k], times[k])
            horizons = sample_scenarios(strategy, carry[0], generator, args.scenarios)
            ctx = ForecastContext(horizons, carry[0].last_update, 0.01, steps * 0.01)
            carry[1], _ = flagship.update(carry[1], x0, times[k], ctx)

    return flagship, step, None


def parts_alone(flagship, state, time_now, ctx, n: int) -> dict:
    """Each part of an eager update alone, on ``state``."""
    from assistedmanipulation_tpu_torch.kernels.philox import split_key
    from assistedmanipulation_tpu_torch.ops.sg_filter import sg_smooth

    planner, x0 = flagship.planner, flagship.x0
    optimal_shifted, shift_by, do_shift, _, keep_mask = planner._sample_meta(state, time_now)
    sampler = planner.sampler
    seed = split_key(state.rng)[1]

    def sample():
        return sampler.sample_and_rollout(
            seed, keep_mask, shift_by, do_shift, state.noise, state.optimal_control,
            optimal_shifted, x0, time_now, ctx,
        )

    costs, noise, _ = sample()
    sg_shift = planner._sg_trim_offset(state, time_now)
    return {
        "sample_meta": events_ms(lambda: planner._sample_meta(state, time_now), n),
        "sample_and_rollout": events_ms(sample, n),
        "optimise": events_ms(lambda: planner._optimise(costs, noise, optimal_shifted, state.sg_buffer, sg_shift), n),
        "sg_smooth": events_ms(lambda: sg_smooth(planner._smoother, state.sg_buffer, optimal_shifted, sg_shift), n),
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--updates", type=int, default=30)
    parser.add_argument("--scenarios", type=int, default=None)
    parser.add_argument("--two-pass", action="store_true")
    parser.add_argument("--inkernel-rng", action="store_true")
    parser.add_argument("--resimulate", action="store_true")
    parser.add_argument("--capture", action="store_true")
    parser.add_argument("--serving", action="store_true")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if args.scenarios is None:
        args.scenarios = 4 if args.serving else 1
    if not torch.cuda.is_available():
        print("torch_profile_update: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    n = args.updates
    flagship, step, parts = make_step(args, "cuda")
    tick = 0
    for _ in range(20):
        step(tick)
        tick += 1
    torch.cuda.synchronize()

    walls, event_ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(tick)
        end.record()
        end.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        tick += 1

    t0 = time.perf_counter()
    for _ in range(n):
        step(tick)
        tick += 1
    torch.cuda.synchronize()
    back_to_back_ms = (time.perf_counter() - t0) * 1e3 / n

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(tick)
            tick += 1
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels, calls = [], {}
    device_ops = 0
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0.0) or getattr(event, "self_cuda_time_total", 0.0)
        if device_us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((event.key, device_us / n / 1e3, event.count / n))
            device_ops += event.count
        elif event.key in LAUNCH_CALLS:
            calls[event.key] = event.count / n
    kernels.sort(key=lambda item: -item[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    planner = flagship.planner
    out = {
        "label": args.label,
        "card": card,
        "root": str(args.root),
        "rollouts": planner.rollout_count,
        "steps": planner.steps,
        "scenarios": args.scenarios,
        "serving_tick": args.serving,
        "captured": args.capture,
        "fused_assembly": planner.sampler.fused_assembly,
        "inkernel_rng": planner.sampler.inkernel_rng,
        "optimal_rollout_mode": planner.configuration.optimal_rollout_mode,
        "updates": n,
        "update_wall_ms_median": statistics.median(walls),
        "update_event_ms_median": statistics.median(event_ms),
        "back_to_back_ms_per_update": back_to_back_ms,
        "solves_per_s": 1e3 / back_to_back_ms,
        "profile_window_ms_per_update": window_ms / n,
        "profile_device_ms_per_update": device_ms,
        "device_busy_share": device_ms / (window_ms / n),
        "device_ops_per_update": device_ops / n,
        "launch_calls_per_update": calls,
        "top_kernels_ms_per_update": [
            {"name": name[:90], "ms": ms, "calls": count} for name, ms, count in kernels[:12]
        ],
    }
    if parts is not None and not args.capture:
        out["parts_alone_ms"] = parts(tick)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

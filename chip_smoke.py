#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Four phases; any failure exits non-zero before the final ok line:

1. Build: compiles every CUDA kernel of the port with nvcc (into
   build/kernels/, all sources at once) and prints the card's name and power
   limit.
2. Kernel against its plain PyTorch version, on the card, float32: the fused
   sample+rollout kernel at R = 1,024 and R = 10,000 rollouts x 50 steps,
   three (shift, do_shift) cases each. The assembled noise must be bitwise
   equal and the violation counts exactly equal; rollout-0 states within
   |kernel - plain| <= 1e-4 * max(|plain|, 1), smooth costs too in at least
   99% of rollouts; the barrier-grazing rest are held to a float64 run of the
   plain version (see ``compare``).
3. The main path. First a small flagship (256 x 8) on the card, update by
   update against the same planner on the CPU. Then ``build_flagship()``
   (9,998 + 2 rollouts x 50 steps, the 12-dof Franka-Ridgeback, 7-term
   objective) runs 20 warm-up updates, then
   200 timed updates; every update must launch the kernel once, the
   published controls must be finite and inside the bounds, and some update
   must move the controls (not degenerate).
4. One ``{"kernels": [...]}`` JSON line: per kernel its launches on the main
   path, worst error against the plain version, time per launch, the plain
   version's time, and the least time the card could take (bound).

The last line is ``{"ok": true, "device": {...}}``. Needs a CUDA card: on a
machine without one it exits non-zero and prints no result.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import torch

STEPS = 50
SERVING_ROLLOUTS = 10_000
CHECK_ROLLOUTS = (1_024, SERVING_ROLLOUTS)
SHIFT_CASES = ((2, True), (0, False), (STEPS, True))
RTOL = 1e-4
OUTLIER_SHARE = 0.01
CONDITIONING = 100.0
WARMUP_UPDATES = 20
TIMED_UPDATES = 200
KERNEL_SOURCE = "assistedmanipulation_tpu_torch/kernels/csrc/fused_sample_rollout.cu"
KERNEL_REPLACES = "assistedmanipulation_tpu/kernels/pallas_rollout.py:272"
# Device memory rate of an H100 SXM (NVIDIA data sheet), bytes/s.
MEMORY_RATE = 3.35e12


def nvidia_smi(query: str, units: bool = True) -> str:
    csv = "--format=csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", csv],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> dict:
    """Registers, stack frame and spill bytes ptxas reported for the kernel."""
    out = {}
    match = re.search(r"Used (\d+) registers", report)
    if match:
        out["registers"] = int(match.group(1))
    match = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", report)
    if match:
        out["stack_bytes"], out["spill_store_bytes"], out["spill_load_bytes"] = map(int, match.groups())
    return out


def kernel_inputs(rollouts: int, shift: int, do_shift: bool, seed: int, device="cuda"):
    """Random old/fresh noise, keep mask and optimal sequences at one shape,
    with the flagship's forecast context, on the card."""
    from assistedmanipulation_tpu_torch.kernels.cuda_rollout import rollout_inputs
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration, ForecastContext,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import synthetic_wrench_horizons

    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=torch.float32, device=device).sqrt()
    shape = (STEPS, 12, rollouts)
    old = torch.randn(shape, generator=g, device=device) * scale[None, :, None]
    fresh = torch.randn(shape, generator=g, device=device) * scale[None, :, None]
    keep = torch.rand(rollouts, generator=g, device=device) < 0.2
    keep[:2] = False
    optimal = 0.3 * torch.randn((STEPS, 12), generator=g, device=device) * scale
    optimal_shifted = 0.3 * torch.randn((STEPS, 12), generator=g, device=device) * scale
    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float32, device=device)
    ctx = ForecastContext(
        synthetic_wrench_horizons(STEPS, device), torch.zeros((), device=device), 0.01, STEPS * 0.01
    )
    init, table = rollout_inputs(
        ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0,
        torch.tensor(0.013, device=device), ctx, optimal, optimal_shifted,
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32, device=device)
    return init, table, meta, old, fresh, keep


def compare(kernel_out, plain_out, exact_out) -> dict:
    """Hold the kernel's outputs to the plain version's; raise on mismatch.

    ``plain_out`` is the plain version in float32 on the same inputs,
    ``exact_out`` the plain version in float64. Noise must match bitwise,
    violation counts exactly, states within RTOL. Smooth costs within RTOL
    of the float32 plain version in all but OUTLIER_SHARE of the rollouts:
    the inverse barrier scale / gap amplifies float32 rounding near its
    bound (an ulp of end-effector position moves a 1e-6 m gap by percents),
    so a rollout that grazes a barrier differs more between any two float32
    evaluations. Such an outlier must still be as close to the float64 value
    as CONDITIONING times the float32 plain version's own error, which a
    fault in the kernel's arithmetic would not be."""
    noise_k, costs_k, states_k = kernel_out
    noise_p, costs_p, states_p = plain_out
    if not torch.equal(noise_k.view(torch.int32), noise_p.view(torch.int32)):
        raise AssertionError("assembled noise differs from the plain version")
    viol_k, viol_p = costs_k[:, 0], costs_p[:, 0]
    same = (viol_k == viol_p) | (torch.isnan(viol_k) & torch.isnan(viol_p))
    if not bool(same.all()):
        raise AssertionError(f"violation counts differ in {int((~same).sum())} rollouts")
    out = {"max_abs_err": 0.0}
    for name, got, want in (("smooth", costs_k[:, 1], costs_p[:, 1]), ("states", states_k, states_p)):
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{name}: NaN pattern differs")
        err = (got - want).abs().nan_to_num()
        rel = err / want.abs().nan_to_num().clamp(min=1.0)
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out[f"{name}_max_rel_err"] = float(rel.max())
        if name == "states" and float(rel.max()) > RTOL:
            raise AssertionError(f"states: relative error {float(rel.max()):.3g} > {RTOL}")
    smooth_k, smooth_p = costs_k[:, 1].double(), costs_p[:, 1].double()
    exact = exact_out[1][:, 1]
    outliers = ((smooth_k - smooth_p).abs() > RTOL * smooth_p.abs().clamp(min=1.0)).nan_to_num()
    out["smooth_outliers"] = int(outliers.sum())
    if int(outliers.sum()) > OUTLIER_SHARE * outliers.numel():
        raise AssertionError(f"smooth: {int(outliers.sum())} rollouts beyond {RTOL}")
    kernel_err = (smooth_k - exact).abs()[outliers]
    plain_err = (smooth_p - exact).abs()[outliers]
    if bool((kernel_err > CONDITIONING * plain_err + RTOL * exact.abs()[outliers]).any()):
        raise AssertionError("smooth: an outlier is further from the float64 value than float32 rounding explains")
    return out


def time_call(fn, repeats: int) -> float:
    """Milliseconds per call from CUDA events over ``repeats`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def check_planner_against_cpu(rollouts: int = 254, steps: int = 8, updates: int = 4) -> None:
    """The flagship planner on the card against the same planner on the CPU:
    each update starts both from the card's state and feeds both the same
    fresh draws. The keep mask's elite set and the noise must match exactly,
    the published controls within 1e-3 (controls span +-100; the float32
    cost differences of phase 2 move the softmax weights)."""
    import numpy as np

    from assistedmanipulation_tpu_torch import interop
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    gpu, cpu = build_flagship(rollouts, steps), build_flagship(rollouts, steps, device="cpu")
    R = gpu.planner.rollout_count
    rng = np.random.default_rng(0)
    state = gpu.init(seed=0)
    for k in range(updates):
        fresh = (rng.standard_normal((R, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)).astype(np.float32)
        arrays = interop.planner_state_to_numpy(state)
        cpu_state = interop.planner_state_from_numpy({**arrays, "rng": np.zeros(2, np.uint32)}, R)
        time_k = 0.01 * k
        state, info = gpu.update(state, gpu.x0, time_k, gpu.make_ctx(), fresh=fresh)
        cpu_state, cpu_info = cpu.update(cpu_state, cpu.x0, time_k, cpu.make_ctx(), fresh=fresh)
        got = interop.planner_state_to_numpy(state)
        want = interop.planner_state_to_numpy(cpu_state)
        if not np.array_equal(got["noise"], want["noise"]):
            raise AssertionError(f"planner update {k}: noise differs between card and CPU")
        err = float(np.abs(got["optimal_control"] - want["optimal_control"]).max())
        if err > 1e-3:
            raise AssertionError(f"planner update {k}: optimal control differs by {err:.3g}")
        print(f"phase 3 small planner R={R} S={steps} update {k}: noise equal, "
              f"optimal control max abs diff {err:.3g} against the CPU planner")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one", file=sys.stderr)
        return 2
    from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    # --- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build()
    ptxas = ptxas_summary(build.ptxas_report("fused_sample_rollout"))
    print(f"phase 1 build: {json.dumps(seconds)} nvcc seconds, wall {time.perf_counter() - t0:.1f} s")
    print(f"ptxas fused_sample_rollout: {json.dumps(ptxas)}")
    card = nvidia_smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm", units=False)) * 1e6
    fp32_instructions_per_s = props.multi_processor_count * 128 * sm_clock_hz
    print(f"{props.name}: {props.multi_processor_count} SMs, max SM clock {sm_clock_hz / 1e6:.0f} MHz, "
          f"{fp32_instructions_per_s / 1e12:.2f} T FP32 instructions/s")

    # --- phase 2: kernel against the plain version -------------------------
    spec = cuda_rollout.RolloutSpec(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01
    )
    worst = {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0}
    for rollouts in CHECK_ROLLOUTS:
        for case, (shift, do_shift) in enumerate(SHIFT_CASES):
            inputs = kernel_inputs(rollouts, shift, do_shift, seed=rollouts + case)
            kernel_out = cuda_rollout.fused_sample_rollout(spec, *inputs)
            plain_out = cuda_rollout.fused_sample_rollout_reference(spec, *inputs)
            exact_out = cuda_rollout.fused_sample_rollout_reference(
                spec, *(x.double() if x.is_floating_point() else x for x in inputs)
            )
            torch.cuda.synchronize()
            err = compare(kernel_out, plain_out, exact_out)
            print(f"phase 2 R={rollouts} S={STEPS} shift={shift} do_shift={do_shift}: noise bitwise, "
                  f"violations exact; {json.dumps(err)}")
            for key in worst:
                worst[key] = max(worst[key], err[key])

    # Kernel and plain times at the serving shape.
    inputs = kernel_inputs(SERVING_ROLLOUTS, 2, True, seed=7)
    for _ in range(3):
        cuda_rollout.fused_sample_rollout(spec, *inputs)
    kernel_ms = time_call(lambda: cuda_rollout.fused_sample_rollout(spec, *inputs), 50)
    plain_ms = time_call(lambda: cuda_rollout.fused_sample_rollout_reference(spec, *inputs), 1)
    R, S = SERVING_ROLLOUTS, STEPS
    bytes_needed = (
        (R - 2) * S * 12 * 4  # one noise source read per sampled element
        + R  # keep mask
        + 4 * (32 + S * 32 + 3)  # init, per-step table, meta
        + S * 12 * R * 4 + R * 2 * 4 + S * 24 * 4  # noise, costs, states written
    )
    bytes_ms = bytes_needed / MEMORY_RATE * 1e3
    ops_ms = R * S * cuda_rollout.STEP_FP32_INSTRUCTIONS / fp32_instructions_per_s * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    print(f"kernel at R={R} S={S}: {kernel_ms:.4f} ms/launch; plain version {plain_ms:.1f} ms; "
          f"bound {bound_ms * 1e3:.1f} us by {bound_by} (operations {ops_ms * 1e3:.1f} us, "
          f"bytes {bytes_ms * 1e3:.1f} us); {bound_ms / kernel_ms * 100:.1f}% of bound")

    # --- phase 3: the main path -------------------------------------------
    # First on a small input, update by update against the same planner on
    # the CPU (plain rollout), both fed the same state and fresh draws.
    check_planner_against_cpu()

    flagship = build_flagship()
    planner = flagship.planner
    ctx, x0 = flagship.make_ctx(), flagship.x0
    state = flagship.init(seed=0)
    times = torch.arange(1, WARMUP_UPDATES + TIMED_UPDATES + 1, dtype=torch.float32, device="cuda") * 0.01
    for i in range(WARMUP_UPDATES):
        state, info = flagship.update(state, x0, times[i], ctx)
    torch.cuda.synchronize()
    cuda_rollout.reset_launch_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_UPDATES)]
    degenerate = []
    t0 = time.perf_counter()
    for i in range(TIMED_UPDATES):
        events[i][0].record()
        state, info = flagship.update(state, x0, times[WARMUP_UPDATES + i], ctx)
        events[i][1].record()
        degenerate.append(info.degenerate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_rollout.LAUNCHES)
    update_ms = [start.elapsed_time(end) for start, end in events]
    optimal = state.optimal_control
    if not bool(torch.isfinite(optimal).all()):
        raise AssertionError("optimal control is not finite")
    low = torch.as_tensor(fr.DEFAULT_CONTROL_MIN, dtype=torch.float32, device="cuda")
    high = torch.as_tensor(fr.DEFAULT_CONTROL_MAX, dtype=torch.float32, device="cuda")
    if not bool(((optimal >= low - 1e-6) & (optimal <= high + 1e-6)).all()):
        raise AssertionError("optimal control outside the control bounds")
    if bool(torch.stack(degenerate).all()):
        raise AssertionError("every update was degenerate")
    if launches["fused_sample_rollout"] != TIMED_UPDATES:
        raise AssertionError(f"kernel launched {launches['fused_sample_rollout']} times in {TIMED_UPDATES} updates")
    if not bool(torch.isfinite(info.optimal_rollout_states).all()):
        raise AssertionError("optimal rollout states are not finite")
    print(f"phase 3 flagship R={planner.rollout_count} S={planner.steps}: {TIMED_UPDATES / wall:.2f} solves/s "
          f"(host wall {wall * 1e3 / TIMED_UPDATES:.3f} ms/update), median update {statistics.median(update_ms):.4f} ms "
          f"(CUDA events), kernel launches {launches['fused_sample_rollout']}, "
          f"degenerate updates {int(torch.stack(degenerate).sum())}; {card}")

    # --- phase 4: the kernels line ------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_sample_rollout",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches["fused_sample_rollout"],
        "max_abs_err": worst["max_abs_err"],
        "smooth_max_rel_err": worst["smooth_max_rel_err"],
        "states_max_rel_err": worst["states_max_rel_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        **ptxas,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

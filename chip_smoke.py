#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Seven phases; any failure exits non-zero before the final ok line:

1. Build: compiles every CUDA kernel of the port with nvcc (into
   build/kernels/, one nvcc per source, all started together) and prints the
   card's name and power limit and each kernel's ptxas registers and spills.
2. Kernels against their plain PyTorch versions, on the card, float32.
   The fused sample+rollout kernel at R = 1,024 and R = 10,000 rollouts x 50
   steps, three (shift, do_shift) cases each: the assembled noise must be
   bitwise equal and the violation counts exactly equal; rollout-0 states
   within |kernel - plain| <= 1e-4 * max(|plain|, 1), smooth costs too in at
   least 99% of rollouts; the barrier-grazing rest are held to a float64 run
   of the plain version (see ``compare``). The two-pass rollout kernel at
   R = 1,024 and 10,000 x 50 steps, the same rules. Then each kernel's time
   per launch at R = 10,000 x 50 (and the plain version's), and at 500 steps.
3. The main path. First a small flagship (256 x 8) on the card, update by
   update against the same planner on the CPU. Then ``build_flagship()``
   (9,998 + 2 rollouts x 50 steps, the 12-dof Franka-Ridgeback, 7-term
   objective) runs 20 warm-up updates, then 200 timed updates; every update
   must launch the fused kernel once and the two-pass kernel never, the
   published controls must be finite and inside the bounds, and some update
   must move the controls (not degenerate).
4. The scenario path: the same small check at 4 forecast scenarios, then
   ``build_flagship(scenarios=4)`` (10,000 x 50 x 4 scenarios) for 20 warm-up
   and 200 timed updates: exactly 4 two-pass launches per update and no
   fused launch, with the same checks on the controls and states.
5. The serving loop the scenario path exists for, 50 updates: measure a
   wrench, Kalman forecast update, draw 4 scenarios from its posterior
   (``sample_scenarios``), planner update; 4 two-pass launches per update,
   the same checks.
6. The long horizon: the two-pass kernel against its plain version at
   R = 1,024 x 500 steps. The violation counts must be equal and states and
   smooth costs within 1e-4 as in phase 2; where float32 drifts further over
   the 500 steps, the kernel is held to a float64 run of the plain version
   (``compare``, ``drift=True``).
7. One ``{"kernels": [...]}`` JSON line: per kernel its launches on its main
   path (phase 3 for the fused kernel, phase 4 for the two-pass one), worst
   error against the plain version, time per launch, the plain version's
   time and the least time the card could take (bound), ptxas registers and
   spills.

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
LONG_STEPS = 500
SERVING_ROLLOUTS = 10_000
CHECK_ROLLOUTS = (1_024, SERVING_ROLLOUTS)
LONG_CHECK_ROLLOUTS = 1_024
SHIFT_CASES = ((2, True), (0, False), (STEPS, True))
SCENARIOS = 4
KALMAN_UPDATES = 50
RTOL = 1e-4
OUTLIER_SHARE = 0.01
CONDITIONING = 100.0
DRIFT_FACTOR = 2.0
WARMUP_UPDATES = 20
TIMED_UPDATES = 200
KERNELS = {
    "fused_sample_rollout": (
        "assistedmanipulation_tpu_torch/kernels/csrc/fused_sample_rollout.cu",
        "assistedmanipulation_tpu/kernels/pallas_rollout.py:272",
    ),
    "rollout": (
        "assistedmanipulation_tpu_torch/kernels/csrc/rollout.cu",
        "assistedmanipulation_tpu/kernels/pallas_rollout.py:168",
    ),
}
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


def kernel_inputs(rollouts: int, shift: int, do_shift: bool, seed: int, device="cuda", steps=None):
    """Random old/fresh noise, keep mask and optimal sequences at one shape,
    with the flagship's forecast context, on the card: the fused kernel's
    (init, table, meta, old, fresh, keep). ``steps`` defaults to STEPS."""
    from assistedmanipulation_tpu_torch.kernels.cuda_rollout import rollout_inputs
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration, ForecastContext,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import synthetic_wrench_horizons

    steps = steps or STEPS
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=torch.float32, device=device).sqrt()
    shape = (steps, 12, rollouts)
    old = torch.randn(shape, generator=g, device=device) * scale[None, :, None]
    fresh = torch.randn(shape, generator=g, device=device) * scale[None, :, None]
    keep = torch.rand(rollouts, generator=g, device=device) < 0.2
    keep[:2] = False
    optimal = 0.3 * torch.randn((steps, 12), generator=g, device=device) * scale
    optimal_shifted = 0.3 * torch.randn((steps, 12), generator=g, device=device) * scale
    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float32, device=device)
    ctx = ForecastContext(
        synthetic_wrench_horizons(steps, device=device), torch.zeros((), device=device), 0.01, steps * 0.01
    )
    init, table = rollout_inputs(
        ObjectiveConfiguration(), steps, 0.01, 1.0, x0,
        torch.tensor(0.013, device=device), ctx, optimal, optimal_shifted,
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32, device=device)
    return init, table, meta, old, fresh, keep


def rollout_kernel_inputs(rollouts: int, steps: int, seed: int, device="cuda"):
    """The two-pass kernel's (init, step table, controls) for the same case
    as ``kernel_inputs(rollouts, 2, True, seed)``: the noise the fused
    kernel would assemble plus the shifted optimal, as the two-pass sampler
    forms them."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    init, table, meta, old, fresh, keep = kernel_inputs(rollouts, 2, True, seed, device, steps)
    noise = cr.assemble_noise(table[:, cr.COL_OPTIMAL:cr.COL_OPTIMAL + 12], meta, old, fresh, keep)
    controls = noise + table[:, cr.COL_OPTSHIFT:cr.COL_OPTSHIFT + 12, None]
    step_table = torch.cat([table[:, :cr.COL_OPTIMAL], table[:, -1:]], dim=1).contiguous()
    return init, step_table, controls


def compare(kernel_out, plain_out, exact_fn, drift: bool = False) -> dict:
    """Hold the kernel's outputs to the plain version's; raise on mismatch.

    ``kernel_out``/``plain_out`` are (noise or None, costs, states), the
    plain version in float32 on the same inputs; ``exact_fn()`` runs the
    plain version in float64 and is called only when needed. Noise must
    match bitwise, violation counts exactly, states within RTOL. Smooth
    costs within RTOL of the float32 plain version in all but OUTLIER_SHARE
    of the rollouts: the inverse barrier scale / gap amplifies float32
    rounding near its bound (an ulp of end-effector position moves a 1e-6 m
    gap by percents), so a rollout that grazes a barrier differs more
    between any two float32 evaluations. Such an outlier is held to the
    float64 run: no further from it than CONDITIONING times the float32
    plain version's own error on that rollout, or than the plain version's
    worst relative error over the whole batch, and over all outliers the
    kernel's median relative error to float64 no larger than CONDITIONING
    times the plain version's. (A per-rollout ratio alone is no test: the
    two float32 errors are independent draws of one spread, and where the
    plain value lands by chance within an ulp of float64 their ratio is
    unbounded.) A fault in the kernel's arithmetic moves a rollout by more
    than float32 rounding does anywhere in the batch.

    ``drift=True`` (long horizons): over hundreds of steps of random
    controls every float32 evaluation drifts from float64, kernel and plain
    version alike: by percents, and in the rollouts that graze a barrier by
    tens of percents, in a third of the smooth costs, and by a barrier
    crossing more or less (or several, for a rollout that hovers at a
    bound) in a few violation counts. Such errors are heavy-tailed, so no
    per-rollout bound tells rounding from a fault; their distribution does.
    Violation counts may differ from the float32 plain version's, and from
    the float64 run's, in at most OUTLIER_SHARE of the rollouts each. A
    rollout whose count differs from the float64 run's crossed a bound at
    another step, which changes its smooth cost by construction (quadratic
    outside, inverse inside): it is held by the violation rule and left out
    of the smooth one. Over all the other values, the median and the 90th
    and 99th percentiles of the kernel's relative error to float64 must
    each be within DRIFT_FACTOR of the plain version's (+ RTOL): a fault
    moves the distribution, rounding does not. The returned counts and
    errors say how much drifted."""
    noise_k, costs_k, states_k = kernel_out
    noise_p, costs_p, states_p = plain_out
    if noise_k is not None and not torch.equal(noise_k.view(torch.int32), noise_p.view(torch.int32)):
        raise AssertionError("assembled noise differs from the plain version")
    viol_k, viol_p = costs_k[:, 0], costs_p[:, 0]
    same = (viol_k == viol_p) | (torch.isnan(viol_k) & torch.isnan(viol_p))
    out = {"max_abs_err": 0.0, "violations_differ": int((~same).sum())}
    if out["violations_differ"] and not drift:
        raise AssertionError(f"violation counts differ in {out['violations_differ']} rollouts")
    if out["violations_differ"] > OUTLIER_SHARE * costs_k.shape[0]:
        raise AssertionError(f"violation counts differ in {out['violations_differ']} rollouts")
    beyond = {}
    for name, got, want in (("smooth", costs_k[:, 1], costs_p[:, 1]), ("states", states_k, states_p)):
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{name}: NaN pattern differs")
        err = (got - want).abs().nan_to_num()
        rel = err / want.abs().nan_to_num().clamp(min=1.0)
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out[f"{name}_max_rel_err"] = float(rel.max())
        beyond[name] = rel > RTOL
    out["smooth_outliers"] = int(beyond["smooth"].sum())
    out["states_beyond_rtol"] = int(beyond["states"].sum())
    if not drift:
        if out["states_beyond_rtol"]:
            raise AssertionError(f"states: relative error {out['states_max_rel_err']:.3g} > {RTOL}")
        if out["smooth_outliers"] > OUTLIER_SHARE * costs_k.shape[0]:
            raise AssertionError(f"smooth: {out['smooth_outliers']} rollouts beyond {RTOL}")
    if not (out["smooth_outliers"] or out["states_beyond_rtol"] or out["violations_differ"]):
        return out
    exact = exact_fn()
    viol_e = exact[1][:, 0]
    kernel_off = (viol_k.double() - viol_e).abs().nan_to_num()
    plain_off = (viol_p.double() - viol_e).abs().nan_to_num()
    crossed = (kernel_off > 0) | (plain_off > 0)
    if out["violations_differ"]:
        stats = {
            "kernel_differs_from_float64": int((kernel_off > 0).sum()),
            "plain_differs_from_float64": int((plain_off > 0).sum()),
            "kernel_worst": float(kernel_off.max()),
            "plain_worst": float(plain_off.max()),
        }
        out["violations_vs_float64"] = stats
        if stats["kernel_differs_from_float64"] > OUTLIER_SHARE * costs_k.shape[0]:
            raise AssertionError(f"violation counts differ from float64 in too many rollouts: {json.dumps(stats)}")
    if bool(crossed.any()):
        out["smooth_left_to_violation_rule"] = int((beyond["smooth"] & crossed).sum())
    for name, got, want, truth, held in (
        ("smooth", costs_k[:, 1], costs_p[:, 1], exact[1][:, 1], ~crossed),
        ("states", states_k, states_p, exact[2], torch.ones_like(states_k, dtype=torch.bool)),
    ):
        mask = beyond[name] & held
        if not bool(mask.any()) and not (drift and bool(held.any())):
            continue
        scale = truth.abs().clamp(min=1.0)
        kernel_rel = ((got.double() - truth).abs() / scale).nan_to_num()
        plain_rel = ((want.double() - truth).abs() / scale).nan_to_num()
        if drift:
            levels = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=truth.device)
            stats = {
                "values": int(held.sum()),
                "kernel_q50_q90_q99": torch.quantile(kernel_rel[held], levels).tolist(),
                "plain_q50_q90_q99": torch.quantile(plain_rel[held], levels).tolist(),
                "kernel_max": float(kernel_rel[held].max()),
                "plain_max": float(plain_rel[held].max()),
            }
            out[f"{name}_rel_err_vs_float64"] = stats
            if any(k > DRIFT_FACTOR * p + RTOL
                   for k, p in zip(stats["kernel_q50_q90_q99"], stats["plain_q50_q90_q99"])):
                raise AssertionError(
                    f"{name}: the kernel's drift from float64 exceeds the plain version's: {json.dumps(stats)}"
                )
            continue
        worst = max(RTOL, float(plain_rel[held].max()))
        stats = {
            "kernel_max": float(kernel_rel[mask].max()),
            "kernel_median": float(kernel_rel[mask].median()),
            "plain_max": float(plain_rel[mask].max()),
            "plain_median": float(plain_rel[mask].median()),
            "plain_worst_in_batch": worst,
        }
        out[f"{name}_rel_err_vs_float64"] = stats
        if bool((kernel_rel[mask] > CONDITIONING * plain_rel[mask] + worst).any()):
            raise AssertionError(
                f"{name}: a value beyond {RTOL} is further from the float64 value than float32 "
                f"rounding explains: {json.dumps(stats)}"
            )
        if stats["kernel_median"] > CONDITIONING * stats["plain_median"] + RTOL:
            raise AssertionError(
                f"{name}: the values beyond {RTOL} are further from float64 than the plain "
                f"version's: {json.dumps(stats)}"
            )
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


def bound(rollouts: int, steps: int, bytes_needed: int, fp32_instructions_per_s: float) -> tuple:
    """(bound ms, "operations" or "bytes", operations ms, bytes ms) for one
    launch: the larger of the step body's FP32 instructions over the card's
    issue rate and the bytes that must move over its memory rate."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    ops_ms = rollouts * steps * cuda_rollout.STEP_FP32_INSTRUCTIONS / fp32_instructions_per_s * 1e3
    bytes_ms = bytes_needed / MEMORY_RATE * 1e3
    return (ops_ms, "operations", ops_ms, bytes_ms) if ops_ms >= bytes_ms else (bytes_ms, "bytes", ops_ms, bytes_ms)


def fused_bytes(R: int, S: int) -> int:
    return (
        (R - 2) * S * 12 * 4  # one noise source read per sampled element
        + R  # keep mask
        + 4 * (32 + S * 32 + 3)  # init, per-step table, meta
        + S * 12 * R * 4 + R * 2 * 4 + S * 24 * 4  # noise, costs, states written
    )


def rollout_bytes(R: int, S: int) -> int:
    return (
        S * 12 * R * 4  # controls read once
        + 4 * (32 + S * 8)  # init, per-step table
        + R * 2 * 4 + S * 24 * 4  # costs, states written
    )


def check_planner_against_cpu(rollouts: int = 254, steps: int = 8, updates: int = 4, scenarios: int = 1) -> None:
    """The flagship planner on the card against the same planner on the CPU:
    each update starts both from the card's state and feeds both the same
    fresh draws. The keep mask's elite set and the noise must match exactly,
    the published controls within 1e-3 (controls span +-100; the float32
    cost differences of phase 2 move the softmax weights)."""
    import numpy as np

    from assistedmanipulation_tpu_torch import interop
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    gpu = build_flagship(rollouts, steps, scenarios=scenarios)
    cpu = build_flagship(rollouts, steps, device="cpu", scenarios=scenarios)
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
        print(f"small planner R={R} S={steps} scenarios={scenarios} update {k}: noise equal, "
              f"optimal control max abs diff {err:.3g} against the CPU planner")


def check_outputs(state, info, degenerate: list) -> None:
    """The published controls finite and inside the bounds, some update not
    degenerate, the optimal rollout's states finite."""
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr

    optimal = state.optimal_control
    if not bool(torch.isfinite(optimal).all()):
        raise AssertionError("optimal control is not finite")
    low = torch.as_tensor(fr.DEFAULT_CONTROL_MIN, dtype=torch.float32, device=optimal.device)
    high = torch.as_tensor(fr.DEFAULT_CONTROL_MAX, dtype=torch.float32, device=optimal.device)
    if not bool(((optimal >= low - 1e-6) & (optimal <= high + 1e-6)).all()):
        raise AssertionError("optimal control outside the control bounds")
    if bool(torch.stack(degenerate).all()):
        raise AssertionError("every update was degenerate")
    if not bool(torch.isfinite(info.optimal_rollout_states).all()):
        raise AssertionError("optimal rollout states are not finite")


def check_launches(expected: dict) -> dict:
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    launches = dict(cuda_rollout.LAUNCHES)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    return launches


def drive_flagship(flagship, expected_launches: dict, label: str, card: str) -> dict:
    """20 warm-up then 200 timed updates of ``flagship`` with its own
    context; the launch counts are set to 0 just before the timed updates
    and read just after."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    planner = flagship.planner
    ctx, x0 = flagship.make_ctx(), flagship.x0
    state = flagship.init(seed=0)
    times = torch.arange(1, WARMUP_UPDATES + TIMED_UPDATES + 1, dtype=torch.float32, device="cuda") * 0.01
    for i in range(WARMUP_UPDATES):
        state, info = flagship.update(state, x0, times[i], ctx)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_UPDATES)]
    degenerate = []
    cuda_rollout.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TIMED_UPDATES):
        events[i][0].record()
        state, info = flagship.update(state, x0, times[WARMUP_UPDATES + i], ctx)
        events[i][1].record()
        degenerate.append(info.degenerate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(expected_launches)
    check_outputs(state, info, degenerate)
    update_ms = statistics.median(start.elapsed_time(end) for start, end in events)
    print(f"{label} R={planner.rollout_count} S={planner.steps}: {TIMED_UPDATES / wall:.2f} solves/s "
          f"(host wall {wall * 1e3 / TIMED_UPDATES:.3f} ms/update), median update {update_ms:.4f} ms "
          f"(CUDA events), kernel launches {json.dumps(launches)}, "
          f"degenerate updates {int(torch.stack(degenerate).sum())}; {card}")
    return launches


def kalman_serving_loop(flagship, card: str) -> None:
    """measure wrench -> Kalman forecast update -> draw SCENARIOS scenarios
    -> planner update, KALMAN_UPDATES times on the card. The measured wrench
    is a 20 N x-pull with a 2 N, 1 Hz y-sway; the filter's noise model is
    set so the posterior (and the ensemble) is not degenerate."""
    from assistedmanipulation_tpu_torch.forecast.forecast import (
        KalmanForecast, KalmanForecastConfiguration,
    )
    from assistedmanipulation_tpu_torch.forecast.scenarios import sample_scenarios
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext

    steps, device = flagship.planner.steps, flagship.x0.device
    strategy = KalmanForecast(KalmanForecastConfiguration(
        time_step=0.01, horizon=steps * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    forecast_state = strategy.init(device=device)
    times = torch.arange(KALMAN_UPDATES, dtype=torch.float32, device=device) * 0.01
    wrench = torch.zeros((KALMAN_UPDATES, 6), dtype=torch.float32, device=device)
    wrench[:, 0] = 20.0
    wrench[:, 1] = 2.0 * torch.sin(2 * torch.pi * times)
    generator = torch.Generator(device=device).manual_seed(3)
    state = flagship.init(seed=1)
    degenerate, spread = [], []
    torch.cuda.synchronize()
    cuda_rollout.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(KALMAN_UPDATES):
        forecast_state = strategy.update(forecast_state, wrench[k], times[k])
        horizons = sample_scenarios(strategy, forecast_state, generator, SCENARIOS)
        ctx = ForecastContext(horizons, forecast_state.last_update, 0.01, steps * 0.01)
        state, info = flagship.update(state, flagship.x0, times[k], ctx)
        degenerate.append(info.degenerate)
        spread.append((horizons[1:] - horizons[0]).abs().max())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches({"fused_sample_rollout": 0, "rollout": SCENARIOS * KALMAN_UPDATES})
    check_outputs(state, info, degenerate)
    if horizons.shape != (SCENARIOS, steps + 1, 6) or not bool(torch.isfinite(horizons).all()):
        raise AssertionError("the sampled scenarios are not finite horizons of the expected shape")
    spread = torch.stack(spread)
    if not bool((spread > 0).all()):
        raise AssertionError("a scenario ensemble collapsed onto its mean")
    print(f"phase 5 Kalman-driven loop R={flagship.planner.rollout_count} S={steps} "
          f"scenarios={SCENARIOS}: {KALMAN_UPDATES} updates, host wall {wall * 1e3 / KALMAN_UPDATES:.3f} "
          f"ms per measure+forecast+sample+update, kernel launches {json.dumps(launches)}, "
          f"scenario spread {float(spread.min()):.3g}-{float(spread.max()):.3g} N, "
          f"degenerate updates {int(torch.stack(degenerate).sum())}; {card}")


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
    ptxas = {name: ptxas_summary(build.ptxas_report(name)) for name in KERNELS}
    print(f"phase 1 build: {json.dumps(seconds)} nvcc seconds, wall {time.perf_counter() - t0:.1f} s")
    for name, summary in ptxas.items():
        print(f"ptxas {name}: {json.dumps(summary)}")
    card = nvidia_smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm", units=False)) * 1e6
    fp32_instructions_per_s = props.multi_processor_count * 128 * sm_clock_hz
    print(f"{props.name}: {props.multi_processor_count} SMs, max SM clock {sm_clock_hz / 1e6:.0f} MHz, "
          f"{fp32_instructions_per_s / 1e12:.2f} T FP32 instructions/s")

    # --- phase 2: kernels against their plain versions ----------------------
    spec = cuda_rollout.RolloutSpec(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01
    )
    worst = {name: {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0} for name in KERNELS}

    def record(name, err):
        for key in worst[name]:
            worst[name][key] = max(worst[name][key], err[key])

    def double(inputs):
        return tuple(x.double() if x.is_floating_point() else x for x in inputs)

    for rollouts in CHECK_ROLLOUTS:
        for case, (shift, do_shift) in enumerate(SHIFT_CASES):
            inputs = kernel_inputs(rollouts, shift, do_shift, seed=rollouts + case)
            kernel_out = cuda_rollout.fused_sample_rollout(spec, *inputs)
            plain_out = cuda_rollout.fused_sample_rollout_reference(spec, *inputs)
            torch.cuda.synchronize()
            err = compare(kernel_out, plain_out,
                          lambda: cuda_rollout.fused_sample_rollout_reference(spec, *double(inputs)))
            print(f"phase 2 fused_sample_rollout R={rollouts} S={STEPS} shift={shift} do_shift={do_shift}: "
                  f"noise bitwise, violations exact; {json.dumps(err)}")
            record("fused_sample_rollout", err)
    for rollouts in CHECK_ROLLOUTS:
        inputs = rollout_kernel_inputs(rollouts, STEPS, seed=rollouts + 5)
        kernel_out = cuda_rollout.rollout(spec, *inputs)
        plain_out = cuda_rollout.rollout_reference(spec, *inputs)
        torch.cuda.synchronize()
        err = compare((None, *kernel_out), (None, *plain_out),
                      lambda: (None, *cuda_rollout.rollout_reference(spec, *double(inputs))))
        print(f"phase 2 rollout R={rollouts} S={STEPS}: violations exact; {json.dumps(err)}")
        record("rollout", err)

    # Kernel and plain times at the serving shape, and at the long horizon.
    R = SERVING_ROLLOUTS
    timing = {}
    fused_inputs = {S: kernel_inputs(R, 2, True, seed=7, steps=S) for S in (STEPS, LONG_STEPS)}
    rollout_inputs = {S: rollout_kernel_inputs(R, S, seed=8) for S in (STEPS, LONG_STEPS)}
    for name, launch, inputs_by_steps, bytes_fn in (
        ("fused_sample_rollout", cuda_rollout.fused_sample_rollout, fused_inputs, fused_bytes),
        ("rollout", cuda_rollout.rollout, rollout_inputs, rollout_bytes),
    ):
        for S, inputs in inputs_by_steps.items():
            for _ in range(3):
                launch(spec, *inputs)
            kernel_ms = time_call(lambda: launch(spec, *inputs), 50 if S == STEPS else 10)
            bound_ms, bound_by, ops_ms, bytes_ms = bound(R, S, bytes_fn(R, S), fp32_instructions_per_s)
            timing[name, S] = {"ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"{name} at R={R} S={S}: {kernel_ms:.4f} ms/launch; bound {bound_ms * 1e3:.1f} us by "
                  f"{bound_by} (operations {ops_ms * 1e3:.1f} us, bytes {bytes_ms * 1e3:.1f} us); "
                  f"{bound_ms / kernel_ms * 100:.1f}% of bound; {card}")
    timing["fused_sample_rollout", STEPS]["plain_ms"] = time_call(
        lambda: cuda_rollout.fused_sample_rollout_reference(spec, *fused_inputs[STEPS]), 1)
    timing["rollout", STEPS]["plain_ms"] = time_call(
        lambda: cuda_rollout.rollout_reference(spec, *rollout_inputs[STEPS]), 1)
    print(f"plain versions at R={R} S={STEPS}: fused_sample_rollout_reference "
          f"{timing['fused_sample_rollout', STEPS]['plain_ms']:.1f} ms, rollout_reference "
          f"{timing['rollout', STEPS]['plain_ms']:.1f} ms")
    del fused_inputs, rollout_inputs

    # --- phase 3: the main path -------------------------------------------
    # First on a small input, update by update against the same planner on
    # the CPU (plain rollout), both fed the same state and fresh draws.
    check_planner_against_cpu()
    main_launches = drive_flagship(
        build_flagship(), {"fused_sample_rollout": TIMED_UPDATES, "rollout": 0}, "phase 3 flagship", card
    )

    # --- phase 4: the scenario path -----------------------------------------
    check_planner_against_cpu(scenarios=SCENARIOS)
    scenario_flagship = build_flagship(scenarios=SCENARIOS)
    scenario_launches = drive_flagship(
        scenario_flagship, {"fused_sample_rollout": 0, "rollout": SCENARIOS * TIMED_UPDATES},
        f"phase 4 scenario flagship ({SCENARIOS} scenarios)", card,
    )

    # --- phase 5: the Kalman-driven serving loop ----------------------------
    kalman_serving_loop(scenario_flagship, card)

    # --- phase 6: the long horizon ----------------------------------------
    inputs = rollout_kernel_inputs(LONG_CHECK_ROLLOUTS, LONG_STEPS, seed=11)
    kernel_out = cuda_rollout.rollout(spec, *inputs)
    plain_out = cuda_rollout.rollout_reference(spec, *inputs)
    torch.cuda.synchronize()
    err = compare((None, *kernel_out), (None, *plain_out),
                  lambda: (None, *cuda_rollout.rollout_reference(spec, *double(inputs))), drift=True)
    print(f"phase 6 rollout R={LONG_CHECK_ROLLOUTS} S={LONG_STEPS}: {json.dumps(err)}")
    record("rollout", err)

    # --- phase 7: the kernels line ------------------------------------------
    lines = []
    for name, launches in (("fused_sample_rollout", main_launches), ("rollout", scenario_launches)):
        source, replaces = KERNELS[name]
        serving, long = timing[name, STEPS], timing[name, LONG_STEPS]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name]["max_abs_err"],
            "smooth_max_rel_err": worst[name]["smooth_max_rel_err"],
            "states_max_rel_err": worst[name]["states_max_rel_err"],
            "ms": serving["ms"],
            "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"],
            "bound_us": serving["bound_ms"] * 1e3,
            "bound_by": serving["bound_by"],
            "library_ms": None,
            f"ms_s{LONG_STEPS}": long["ms"],
            f"bound_ms_s{LONG_STEPS}": long["bound_ms"],
            **ptxas[name],
        })
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

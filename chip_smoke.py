#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Nineteen phases; any failure exits non-zero before the final ok line:

1. Build: compiles every CUDA kernel of the port with nvcc (into
   build/kernels/, one nvcc per source, all started together) and prints the
   card's name and power limit, each kernel's ptxas registers and spills,
   the fused kernels' whole ptxas reports, and each library's shared-memory
   limit (the fused kernels' longest horizon, the two-pass kernel's table
   rows), which must equal the wrapper's constant.
2. Kernels against their plain PyTorch versions, on the card, float32.
   The fused sample+rollout kernel (a pair of warps per 32 rollouts) at
   R = 33 (a last pair with one live lane), 1,024 and 10,000 rollouts x 50
   steps, three (shift, do_shift) cases at 33 and 1,024, the first at
   10,000 (``shift_cases``): the assembled noise must be
   bitwise equal and the violation counts exactly equal; rollout-0 states
   within |kernel - plain| <= 1e-4 * max(|plain|, 1), smooth costs too in at
   least 99% of rollouts; the barrier-grazing rest are held to a float64 run
   of the plain version (see ``compare``). Every rollout kernel runs a warp
   pair per 32 rollouts. The two-pass rollout kernel at R = 1 (one live
   lane per warp), 33, 1,024 and 10,000 x 50 steps, the same rules, at one
   scenario and at 4 scenarios in one launch: there each scenario's costs
   are held to the plain version, and bitwise to a one-scenario launch on
   its table; where the last warp pair is partial (R = 1, 33, 10,000),
   every live rollout bitwise a launch whose last pair is full. Then
   each kernel's time per launch at R = 10,000 x 50 (the plain version's
   is its checked call at that shape), and at 500 steps; kernel 2 at 4
   scenarios beside 4 one-scenario launches.
3. The main path. First a small flagship (256 x 8) on the card, update by
   update against the same planner on the CPU. Then ``build_flagship()``
   (9,998 + 2 rollouts x 50 steps, the 12-dof Franka-Ridgeback, 7-term
   objective) runs 20 warm-up updates, then 200 timed updates; every update
   must launch the fused kernel once and the two-pass kernel never, the
   published controls must be finite and inside the bounds, and some update
   must move the controls (not degenerate). Then the same cell captured
   (``build_flagship(capture=True)``, one CUDA-graph replay per update):
   CAPTURE_CHECK_UPDATES updates in lockstep with the eager flagship from
   the same key, every state field and info output bitwise equal (noise,
   costs, optimal control, states); the same 20 + 200 updates; and
   ``torch.profiler`` over PROFILED_UPDATES updates of each path: one graph
   launch and exactly one instance of the cell's rollout kernel per replay,
   launches per update and the device's busy share, both paths.
4. The scenario path: the same small check at 4 forecast scenarios, then
   ``build_flagship(scenarios=4)`` (10,000 x 50 x 4 scenarios) for 20 warm-up
   and 200 timed updates: exactly one two-pass launch per update (all 4
   scenarios) and no fused launch, with the same checks on the controls and
   states; then captured, as in phase 3. Then the single-forecast two-pass
   flagship (``build_flagship(fused_assembly=False)``), one one-scenario
   launch per update, eager only.
5. The serving loop the scenario path exists for, 50 ticks of
   ``make_serving_tick``: measure a wrench, Kalman forecast update, draw 4
   scenarios from its posterior (``sample_scenarios``), planner update; one
   two-pass launch per tick, the same checks. Eager, then as one CUDA graph
   per tick: in lockstep bitwise equal (horizons, both states, info), then
   timed against the 10 ms control period, and profiled as in phase 3.
6. The long horizon: the two-pass and the fused kernel against their plain
   versions at R = 1,024 x LONG_CHECK_STEPS = 128 steps (the fused
   kernel's state ring wraps 32 times; cut from 500 steps to fit the
   script's clock, the kernels' times at 500 steps stay in phases 2 and 7).
   The fused kernel's noise must be bitwise equal; violation counts, states
   and smooth costs are held to a float64 run of the plain version where
   float32 drifts over the horizon (``compare``, ``drift=True``).
7. The in-kernel-RNG kernel against its plain version at R = 33, 1,024 and
   10,000 x 50, the (shift, do_shift) cases of ``shift_cases``, and at
   1,024 x LONG_CHECK_STEPS (``compare``'s drift rule): noise that
   did not come from a fresh draw bitwise equal, fresh draws within FRESH_TOLERANCE x
   the dof's scale (the same Philox bits; logf and sincospif may differ by
   a few ulps); costs and states held by ``compare`` against the plain
   rollout of the kernel's own noise, so an RNG fault stays apart from a
   step-body fault. The distribution gate at 10,000 x 50 with no elite row
   (every sampled element fresh): per dof mean, std and skew within 5 sigma
   (scripts/tpu_crosscheck.py's rule); the same seed words give the same
   noise and two updates' seed words differ. Then its time at 50 and 500
   steps and the plain version's.
8. The in-kernel-RNG flagship: a small one (256 x 8) on the card, update by
   update against the fused flagship on the CPU fed the draws
   ``philox.normal_draws`` makes from the seed words the card's sampler
   drew; then ``build_flagship(inkernel_rng=True)`` (10,000 x 50) for 20
   warm-up and 200 timed updates: exactly 200 in-kernel-RNG launches and
   no other, the same checks on the controls and states; then captured, as
   in phase 3.
9. Resimulate mode: ``build_flagship(optimal_rollout_mode="resimulate")``
   publishes each new optimal sequence's re-rollout, one more two-pass
   launch at R = 1 per update. Its cost and states held to the plain
   version's (``compare``) on the published sequence; then eager and
   captured as in phase 3 (one fused and one two-pass launch per update,
   both inside the graph); kernel 2 timed at R = 1.
10. The safety flagship (``build_flagship(safety=True)``: kernel 1, then
   the re-rollout through the plant with the ADMM-QP filter per step, one
   launch of the QP kernel each) and
11. the vmap flagship (``build_flagship(backend="vmap")``, no kernel):
   each small against the CPU, then eager and captured (``PLANT_COUNTS``;
   the safety flagship's launches exact: 1 of kernel 1 and STEPS of the QP
   kernel per update). Phase 10 also holds the QP kernel to its plain
   version on the QPs of filtered re-rollouts (``qp_kernel_check``) and
   times it alone at the filter's 12 x 37 with N = 1, 4 blocks x 40
   iterations, over QP_TIMED_LAUNCHES launches.
12. The FP32 issue-peak probe: the chain kernel against its plain version
   at small K (1 and 16 accumulators; the add leg bitwise, the FMA leg
   within rtol 1e-5); then ``fp32_chain.probe``: its SASS loop holds
   accumulators x unroll FFMA (FADD) instructions in every instantiation,
   the FMA and add legs at 1-16 accumulators, their peaks beside the
   nominal rate, and kernels 1-3's share of the measured FMA peak.
13. The simulated experiment (``sim/episode.py`` and the harness; the
   plant planner's vmap path, no kernel), at the reference's widths (50
   rollouts, keep-best 20, 30 steps, the 20 Hz controller, the 200 Hz
   plant): a 0.25 s circle episode captured on the card (float32) against
   the CPU (float64, eager) under the same injected noise, the EE trace
   within CARD_CPU_TOLERANCE m and the controls within CARD_CPU_TOLERANCE
   x max(|u|, 1) (the CPU runs in a child process meanwhile); a captured
   episode (the first period eager, one CUDA graph per further period, 1
   replay and a partial period) bitwise equal to the eager one; the
   assisted and unassisted circle for EXPERIMENT_SECONDS (5 s), captured,
   the assisted mean force below ASSISTANCE_GATE x the unassisted, one
   period's replay timed and profiled (device operations per period); the
   CLI (``python -m assistedmanipulation_tpu_torch.harness --test circle
   --config '{"engine": "episode"}'``, CLI_SECONDS) in a subprocess, its
   CSV tree complete and finite, its wall time, real-time factor and
   metrics; the host engine for HOST_ENGINE_SECONDS paced to wall clock
   (pacing.json's overrun rate); the lagrangian case for
   LAGRANGIAN_SECONDS; the actor's update tick eager and captured; one
   Lagrangian mass matrix + nonlinear effects at batch 1. The CLI and the
   lagrangian case run as subprocesses on the card while the host engine
   and the actor run here (their walls are measured beside each other).
14. The experiment's tooling (the host engine and the plant planner, no
   kernel), at the reference widths: checkpoint and resume (the circle
   case under the host engine for RESUME_SECONDS with snapshots every
   RESUME_INTERVAL, the update captured: an uninterrupted run, a run
   stopped RESUME_LOST_TICKS ticks past its first snapshot with a CSV
   planted after it, and ``TestSuite.resume`` of it; the trees byte-equal
   apart from mppi/update.csv, the planted CSV deleted); the parameter
   sweep (reach over two cost scales, sweep.csv two passed rows); the run
   analysis (``analyse_single`` and ``analyse_multiple`` without plots on
   the resumed circle's tree and phase 13's CLI tree, every metric
   finite); the reference-pipeline replays (scripts/torch_parity_replay.py,
   recorded on the CPU in a child process during phase 13) with the
   planner on the card at float64 and float32, beside the same planner on
   the CPU, under the bounds of tests/test_reference_replay.py.
15. Rollout sharding (parallel/sharding.py, ``sharding_phase``): kernels
   1 and 3 against their plain versions on a shard's block of 5,000
   rollouts with ``meta[2] = 0`` (a block without the static rollouts; the
   first shift case there, the other two on a 1,024-rollout block) and
   kernel 2 on a rank's slice of the ensemble, each timed there;
   ``build_flagship(sampler_shards=2)``, the single-process twin, against
   the unsharded flagship fed the same draws, captured bitwise to its
   eager self, and 20 + 200 updates of 2 kernel-1 launches each; then
   scripts/torch_multihost_check.py, 2 gloo ranks on this card: the 1-D
   mesh flagship on kernel 1 and on kernel 3 bitwise equal to the twin,
   the 4-scenario flagship on the 2 x 1 mesh (kernel 2) within the
   script's tolerance, the ranks' solves/s and time per collective.
16. The experiment-level scripts, cut (``experiment_scripts_phase``): the
   matrix of scripts/torch_experiments.py, MATRIX_CELLS (the order-1
   Kalman on the pose, figure-eight and rectangle rows) for MATRIX_SECONDS
   each through ``run_cell``, and the circle's average, LOCF and order-2
   Kalman cells captured for CAPTURE_CHECK_SECONDS, bitwise their eager
   selves; every cell's metrics finite; the
   realtime check of scripts/torch_realtime_check.py (the update and the
   10 ticks of a period as two CUDA graphs): its first captured updates
   bitwise the eager ones, then REALTIME_UPDATES updates timed against the
   50 ms slot (printed, not gated) and the device operations of one replay
   of each graph; the scenario study of scripts/torch_scenario_value.py at
   STUDY_SIGMA N and C = 1 and 4 for STUDY_SECONDS: C kernel-2 launches
   per update counted, the metrics finite; kernel 2 at the study's shape
   (52 rollouts x 30 steps: one partial block) against its plain version,
   C tables in one launch bitwise C one-scenario launches, each timed.
17. The ports of the last four JAX scripts, cut (``script_ports_phase``):
   the pose-dither rows, the force-offset runs, the rectangle twin on the
   card against the CPU, the scaling bench's overhead mode on kernel 1 (n
   launches per update over n shards of the twin) and the pose
   diagnosis's draws gate.
18. The last public surface (``surface_phase``) at the serving width: a
   full (non-diagonal) covariance on the two-pass path (its draws within 5
   sigma and against the CPU's mapping of the same normals, one kernel-2
   launch per update, its costs against the CPU planner's on the same
   draws), the diagonal flagship's draws bitwise the normals times the
   deviations, the threshold elite select bitwise the lexsort at 10,000
   rollouts (both timed), the lanes backend (one update timed, its device
   operations counted, its costs against kernel 2's on its controls) and
   the lanes re-rollout against kernel 2 at R = 1.
19. One ``{"phase_seconds": {...}}`` line (seconds per phase, from the
   ``mark`` calls), then one ``{"kernels": [...]}`` JSON line: per kernel
   its launches on its main path (phase 3 for the fused kernel, phase 4 for
   the two-pass one at 4 scenarios and at one, the latter with its
   resimulate launches of phase 9 and its time at R = 1 and its launches
   and time in phase 16's
   scenario study, phase 8 for the in-kernel-RNG one, phase 10 for the QP
   kernel, phase 12's probe for the chain kernel, which no solve
   launches), worst error against the
   plain version (phase 15's checks included), time per launch, the plain
   version's time and the least time the card could take (bound), ptxas
   registers and spills; phase 15's per-shard times and launches beside
   them; kernel 1's launches and time on phase 17's scaling path; each
   kernel's design (``DESIGNS``).

The last line is ``{"ok": true, "device": {...}}``. Needs a CUDA card: on a
machine without one it exits non-zero and prints no result.
"""

import json
import multiprocessing
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import torch

STEPS = 50
LONG_STEPS = 500
SERVING_ROLLOUTS = 10_000
CHECK_ROLLOUTS = (1_024, SERVING_ROLLOUTS)
FUSED_CHECK_ROLLOUTS = (33,) + CHECK_ROLLOUTS  # 33: a last warp pair with one live lane
ROLLOUT_CHECK_ROLLOUTS = (1,) + FUSED_CHECK_ROLLOUTS  # 1: one live lane per warp (the re-rollout)
LONG_CHECK_ROLLOUTS = 1_024
LONG_CHECK_STEPS = 128  # phase 6's checks (the times at LONG_STEPS stay)
SHIFT_CASES = ((2, True), (0, False), (STEPS, True))
SCENARIOS = 4
SCENARIO_KEY = f"rollout x{SCENARIOS}"  # kernel 2 at SCENARIOS scenarios, in this script's tables
SHARDS = 2  # phase 15: rollout shards of the twin and ranks of the mesh
MESH_UPDATES = 8  # phase 15: updates of each case on the 2 ranks
KALMAN_UPDATES = 50
RTOL = 1e-4
OUTLIER_SHARE = 0.01
CONDITIONING = 100.0
DRIFT_FACTOR = 2.0
WARMUP_UPDATES = 20
TIMED_UPDATES = 200
CAPTURE_CHECK_UPDATES = 8  # captured against eager, bitwise, in lockstep
# Phase 13's timings taken while other runs share the card and the host's
# cores: not comparable with the same figures measured alone.
BESIDE_CLI = "the CLI and lagrangian subprocesses on the card"
BESIDE_HOST = "the host engine, the actor and Lagrangian timings, and the other CLI subprocess"
PROFILED_UPDATES = 10
PROFILE_MARGIN_S = 0.01  # idle host time around a profiled window's steps
# Phases 10 and 11 run tens of thousands of small operations per update
# (the plant in plain PyTorch): fewer updates, (warm-up, timed, profiled)
# on the eager and the captured path, and the captured updates held to the
# eager ones in lockstep.
PLANT_COUNTS = {"eager": (1, 1, 1), "captured": (1, 5, 1), "lockstep": 2}
CONTROL_PERIOD_MS = 10.0  # the 100 Hz tick the serving loop must fit
# Device kernel names (demangled, as torch.profiler reports them) of each
# rollout kernel; "rollout x1" is kernel 2 at one scenario, the resimulate
# re-rollout's instantiation.
KERNEL_PATTERNS = {
    "fused_sample_rollout": r"pair_sample_rollout_kernel<false>",
    "inkernel_rng_sample_rollout": r"pair_sample_rollout_kernel<true>",
    "rollout x1": r"pair_rollout_kernel<1>",
    f"rollout x{SCENARIOS}": rf"pair_rollout_kernel<{SCENARIOS}>",
}
# Each rollout kernel's design, for the kernels line.
WARP_PAIR = ("a warp pair per 32 rollouts: the dynamics warp runs FK and the dynamics, the cost warp "
             "FK again and the cost terms, up to 4 steps behind through a shared-memory ring (pipeline.cuh)")
DESIGNS = {
    "fused_sample_rollout": WARP_PAIR + "; pair_sample_rollout_kernel<false>",
    "inkernel_rng_sample_rollout": WARP_PAIR + "; the dynamics warp also draws the fresh noise (Philox); "
                                   "pair_sample_rollout_kernel<true>",
    "rollout": WARP_PAIR + "; C scenarios' trajectory terms on the cost warp; pair_rollout_kernel<C>",
    "fp32_chain": "one thread per element, dependent FMA or add chains (a probe)",
    "admm_qp": "one block per problem, 8 lanes per row of the iteration map held in registers, (s, z) "
               "double-buffered in shared memory, one barrier per iteration; warp 0 factors, inverts and "
               "takes the residuals",
}
KERNELS = {
    "fused_sample_rollout": (
        "assistedmanipulation_tpu_torch/kernels/csrc/fused_sample_rollout.cu",
        "assistedmanipulation_tpu/kernels/pallas_rollout.py:272",
    ),
    "rollout": (
        "assistedmanipulation_tpu_torch/kernels/csrc/rollout.cu",
        "assistedmanipulation_tpu/kernels/pallas_rollout.py:168",
    ),
    "inkernel_rng_sample_rollout": (
        "assistedmanipulation_tpu_torch/kernels/csrc/inkernel_rng_sample_rollout.cu",
        "assistedmanipulation_tpu/kernels/pallas_rollout.py:393",
    ),
    "fp32_chain": (
        "assistedmanipulation_tpu_torch/kernels/csrc/fp32_chain.cu",
        "scripts/vpu_roofline.py:56",
    ),
    "admm_qp": (
        "assistedmanipulation_tpu_torch/kernels/csrc/admm_qp.cu",
        "assistedmanipulation_tpu/ops/admm_qp.py:49 solve_qp (plain jnp, no Pallas kernel)",
    ),
}
# Fresh draws of the in-kernel-RNG kernel against philox.normal_draws, per
# unit of the dof's scale: the same bits, and logf/sincospif a few ulps from
# the plain version's (an ulp at |z| = 5.5 is 4.8e-7).
FRESH_TOLERANCE = 4e-6
# The QP kernel against its plain version on the filter's QPs: x and the
# residuals within this share of max(|u_target|, 1) (float32; float64 1e-9),
# z and y of their own largest magnitude; the kernel sums in another order
# than cuBLAS, through 160 iterations. Timed alone over this many launches.
QP_TOLERANCE = {torch.float32: 1e-4, torch.float64: 1e-9}
QP_TIMED_LAUNCHES = 50
QP_REPLAYS = 5  # timed replays of each graph of time_qp
# The probe in this script: K = 512 (a quarter of the roofline script's),
# 10 chained launches per timing, best of 3.
PROBE_ITERATIONS, PROBE_REPS, PROBE_BLOCKS = 512, 10, 3
# Phase 13, the experiment (harness/cases.py:47-75 of the JAX package: the
# circle case, 50 rollouts, keep-best 20, a 0.3 s horizon, the 20 Hz
# controller, the 200 Hz plant), durations in simulated seconds.
# Cut to fit the script's clock (PERF.md §6): the assisted and
# unassisted episodes from 15 s to 5 s, the CLI's run from 5 s to 2 s, the
# paced host engine from 1 s to 0.2 s, the lagrangian case from 0.5 s to
# 0.2 s.
EXPERIMENT_SECONDS = 5.0
CLI_SECONDS = 2.0
CARD_CPU_SECONDS = 0.25  # 50 ticks, 5 updates
CAPTURE_CHECK_SECONDS = 0.125  # the eager first period, 1 replay, 5 eager ticks
HOST_ENGINE_SECONDS = 0.2
LAGRANGIAN_SECONDS = 0.2
CARD_CPU_TOLERANCE = 1e-3  # m on the EE trace; x max(|u|, 1) on the controls
CARD_F32_FACTOR = 3.0  # controls past float32's own departure from float64 (experiment_phase)
ASSISTANCE_GATE = 0.7  # assisted mean force below this share of the unassisted
# EXPERIMENTS.md, circle row (TPU-era quality numbers, not speed): the
# kalman_1 cell's mean force and RMSE, the unassisted mean force.
EXPERIMENTS_CIRCLE = {"kalman_1_mean_force": 12.20, "kalman_1_rmse": 0.0625, "unassisted_mean_force": 27.57}
# Phase 14, the experiment's tooling, at the reference widths: the circle
# case under the host engine for RESUME_SECONDS with a snapshot every
# RESUME_INTERVAL (the interrupted run stops RESUME_LOST_TICKS ticks past
# the first one); the reach sweep, SWEEP_SECONDS per value; the replays
# (updates, rollouts) and their bounds (tests/test_reference_replay.py):
# per dtype (the whole series, the first update).
RESUME_SECONDS, RESUME_INTERVAL, RESUME_LOST_TICKS = 0.15, 0.1, 5
SWEEP_SECONDS, SWEEP_VALUES = 0.1, (5.0, 10.0)
POINT_REPLAY, FRANKA_REPLAY = (12, 32), (8, 34)
REPLAY_BOUNDS = {
    "point mass": {"float64": (1e-9, 1e-9), "float32": (0.03, 1e-4)},
    "franka": {"float64": (2e-6, 2e-6), "float32": (0.16, 1e-3)},
}
# Phase 16, the experiment-level scripts (scripts/torch_experiments.py,
# torch_realtime_check.py, torch_scenario_value.py), cut: the matrix's
# MATRIX_CELLS at MATRIX_SECONDS, seed 0; the realtime loop for
# REALTIME_UPDATES updates, its first REALTIME_LOCKSTEP captured updates
# held bitwise to the eager ones; the scenario study at STUDY_SIGMA N of
# observation noise, each count of STUDY_SCENARIOS, seed 0, STUDY_SECONDS,
# and kernel 2 at its shape there (STUDY_ROLLOUTS x STUDY_STEPS, up to
# SCENARIOS tables in one launch).
# Phase 13 drives the circle's unassisted and order-1 Kalman cells; the
# matrix here runs one cell per other row for MATRIX_SECONDS, and the
# circle's other strategies as the captured runs of their capture checks.
MATRIX_SECONDS = 0.5
CAPTURE_CHECK_STRATEGIES = ("average", "locf", "kalman_2")  # phase 13 holds kalman_1
MATRIX_CELLS = tuple((trajectory, "kalman_1") for trajectory in ("pose", "figure_eight", "rectangle"))
REALTIME_UPDATES, REALTIME_LOCKSTEP = 40, 2
STUDY_SIGMA, STUDY_SCENARIOS, STUDY_SECONDS = 5.0, (1, SCENARIOS), 0.5
STUDY_ROLLOUTS, STUDY_STEPS = 52, 30
# Phase 17, the ports of the last four JAX scripts (scripts/
# torch_pose_dither_sweep.py, torch_force_offset_sweep.py,
# torch_rectangle_twin.py, torch_scaling_bench.py), cut: the pose rows and
# the force-offset runs for PORTS_SECONDS, seed 0; the twin for
# TWIN_SECONDS on the card (float64) against the CPU, its EE traces within
# TWIN_TOLERANCE m; the scaling bench's overhead mode at the serving shape
# over SCALING_SHARDS shards of the twin, SCALING_UPDATES timed updates
# each; the pose diagnosis's draws gate over DRAWS_UPDATES updates.
PORTS_SECONDS = 1.0
POSE_ROWS = ("default", "keep_10", "eps_0.0001")
TWIN_SECONDS, TWIN_TOLERANCE = 0.25, 1e-6
SCALING_SHARDS, SCALING_UPDATES = (1, 2), 20
DRAWS_UPDATES = 300
# Phase 18, the last public surface at the serving width: the full
# covariance (FULL_COVARIANCE_SEED: the default deviations around a random
# correlation matrix; its fresh draws against the CPU's mapping of the same
# standard normals within CORRELATE_TOLERANCE x the largest deviation), the
# threshold select timed over SELECT_TIMINGS calls against the lexsort,
# the lanes backend, the lanes re-rollout.
FULL_COVARIANCE_SEED = 3
CORRELATE_TOLERANCE = 1e-5
SELECT_TIMINGS = 20
# Why a kernel's line has no library time.
LIBRARY_REASONS = {
    "fused_sample_rollout": "no single PyTorch call computes it",
    "rollout": "no single PyTorch call computes it",
    "inkernel_rng_sample_rollout": "no PyTorch call draws and rolls out in one call",
}
# Device memory rate of an H100 SXM (NVIDIA data sheet), bytes/s.
MEMORY_RATE = 3.35e12
# Host API calls that put work on the device, as torch.profiler names them.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def shift_cases(rollouts: int) -> tuple:
    """The (shift, do_shift) cases of a check against a plain version at
    ``rollouts``: all three up to LONG_CHECK_ROLLOUTS, the first (the
    serving update's) above, where a plain call and its float64 rerun take
    seconds (cut to fit the script's clock)."""
    return SHIFT_CASES if rollouts <= LONG_CHECK_ROLLOUTS else SHIFT_CASES[:1]


def nvidia_smi(query: str, units: bool = True) -> str:
    csv = "--format=csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", csv],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report: str, function: str = "") -> dict:
    """Registers, stack frame and spill bytes ptxas reported for the
    library's kernels (the largest over its functions, or over those whose
    mangled name holds ``function``)."""
    if function:
        report = "".join(part for part in report.split("Compiling entry function") if function in part)
    out = {}
    registers = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    if registers:
        out["registers"] = max(registers)
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", report)
    if frames:
        out["stack_bytes"], out["spill_store_bytes"], out["spill_load_bytes"] = (
            max(int(frame[i]) for frame in frames) for i in range(3)
        )
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


def rollout_kernel_inputs(rollouts: int, steps: int, seed: int, device="cuda", scenarios: int = 1):
    """The two-pass kernel's (init, step table, controls) for the same case
    as ``kernel_inputs(rollouts, 2, True, seed)``: the noise the fused
    kernel would assemble plus the shifted optimal, as the two-pass sampler
    forms them. ``scenarios`` > 1 gives the (C, S, 8) tables of the
    flagship's synthetic C-scenario ensemble in place of the (S, 8) table."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration, ForecastContext,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import synthetic_wrench_horizons

    init, table, meta, old, fresh, keep = kernel_inputs(rollouts, 2, True, seed, device, steps)
    noise = cr.assemble_noise(table[:, cr.COL_OPTIMAL:cr.COL_OPTIMAL + 12], meta, old, fresh, keep)
    controls = noise + table[:, cr.COL_OPTSHIFT:cr.COL_OPTSHIFT + 12, None]
    if scenarios == 1:
        step_table = torch.cat([table[:, :cr.COL_OPTIMAL], table[:, -1:]], dim=1).contiguous()
        return init, step_table, controls
    ctx = ForecastContext(
        synthetic_wrench_horizons(steps, scenarios, device=device), torch.zeros((), device=device), 0.01,
        steps * 0.01,
    )
    tables = cr.step_table(ObjectiveConfiguration(), steps, 0.01, 1.0, init, torch.tensor(0.013, device=device), ctx)
    return init, tables.contiguous(), controls


def compare_scenarios(kernel_out, plain_out, exact_fn, drift: bool = False) -> dict:
    """``compare`` for each scenario of a multi-scenario two-pass launch:
    ``kernel_out``/``plain_out`` are ((C, R, 2) costs, (S, 24) states),
    ``exact_fn()`` the float64 plain version's (called once, if needed).
    Returns the worst of each error over the scenarios."""
    costs_k, states_k = kernel_out
    costs_p, states_p = plain_out
    exact = []

    def exact_scenario(c):
        if not exact:
            exact.append(exact_fn())
        return None, exact[0][0][c], exact[0][1]

    worst = {}
    for c in range(costs_k.shape[0]):
        err = compare((None, costs_k[c], states_k), (None, costs_p[c], states_p),
                      lambda c=c: exact_scenario(c), drift=drift)
        for key, value in err.items():
            if isinstance(value, (int, float)):
                worst[key] = max(worst.get(key, value), value)
    return worst


def check_scenarios_bitwise(spec, inputs, costs) -> None:
    """The (C, R, 2) costs of one C-scenario launch bitwise equal to C
    one-scenario launches of the same kernel, one per scenario's table."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    init, tables, controls = inputs
    for c in range(tables.shape[0]):
        single, _ = cr.rollout(spec, init, tables[c].contiguous(), controls)
        if not torch.equal(single.view(torch.int32), costs[c].view(torch.int32)):
            differ = int((single.view(torch.int32) != costs[c].view(torch.int32)).any(dim=1).sum())
            raise AssertionError(
                f"scenario {c}: the multi-scenario launch differs from a one-scenario launch "
                f"in {differ} rollouts"
            )


def check_partial_pair_bitwise(spec, inputs, kernel_out) -> None:
    """Kernel 2 at an R that leaves its last warp pair partial: each live
    rollout's costs and rollout 0's states are bitwise those of a launch
    whose last pair is full (the controls padded with copies of the last
    rollout's), so the dead lanes, which replay the last rollout, change no
    live lane."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    init, table, controls = inputs
    R = controls.shape[2]
    padded = torch.cat([controls, controls[:, :, -1:].expand(-1, -1, -R % 32)], dim=2).contiguous()
    full_costs, full_states = cr.rollout(spec, init, table, padded)
    costs, states = kernel_out
    if not (torch.equal(full_costs[..., :R, :].view(torch.int32), costs.view(torch.int32))
            and torch.equal(full_states, states)):
        raise AssertionError(f"R={R}: the partial warp pair's live rollouts differ from a full pair's")


def inkernel_inputs(rollouts: int, shift: int, do_shift: bool, seed: int, device="cuda", steps=None):
    """The in-kernel-RNG kernel's (init, table, meta, old, keep, seed words,
    scale): ``kernel_inputs``' case without the fresh draws, 2 seed words
    drawn from a generator seeded with ``seed``, the flagship's scale."""
    from assistedmanipulation_tpu_torch.kernels.philox import seed_words
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.ops.gaussian import diagonal_scale

    init, table, meta, old, _, keep = kernel_inputs(rollouts, shift, do_shift, seed, device, steps)
    words = seed_words(torch.Generator(device=device).manual_seed(seed))
    scale = torch.tensor(diagonal_scale(fr.DEFAULT_COVARIANCE), dtype=torch.float32, device=device)
    return init, table, meta, old, keep, words, scale


def check_fresh_noise(noise_k, noise_p, mask, scale) -> float:
    """Noise from one in-kernel-RNG launch against the plain draws: bitwise
    where ``mask`` (S, 1, R) says no fresh draw was taken, within
    FRESH_TOLERANCE x scale[d] where one was. Returns the largest fresh
    error in units of the scale."""
    mask = mask.expand_as(noise_k)
    if not torch.equal(noise_k.view(torch.int32)[~mask], noise_p.view(torch.int32)[~mask]):
        raise AssertionError("noise that is not a fresh draw differs from the plain version")
    err = (noise_k - noise_p).abs()
    limit = FRESH_TOLERANCE * scale[None, :, None]
    if bool((err > limit)[mask].any()):
        raise AssertionError(f"fresh draws differ from philox.normal_draws by up to {float(err[mask].max()):.3g}")
    units = (err / scale.clamp(min=1e-30)[None, :, None])[mask]
    return float(units.max()) if units.numel() else 0.0


def check_inkernel(spec, inputs, kernel_out, drift: bool = False) -> dict:
    """Phase 7's rule for one launch: the noise against the plain draws
    (``check_fresh_noise``), the costs and states against the plain rollout
    of the kernel's own noise through ``compare``."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels.philox import normal_draws

    init, table, meta, old, keep, words, scale = inputs
    noise_k, costs_k, states_k = kernel_out
    S, _, R = old.shape
    fresh = normal_draws(words, S, R, scale)
    noise_p = cr.assemble_noise(table[:, cr.COL_OPTIMAL:cr.COL_OPTIMAL + 12], meta, old, fresh, keep)
    fresh_err = check_fresh_noise(noise_k, noise_p, cr.fresh_mask(meta, keep, S), scale)
    controls = noise_k + table[:, cr.COL_OPTSHIFT:cr.COL_OPTSHIFT + 12, None]
    step_table = torch.cat([table[:, :cr.COL_OPTIMAL], table[:, -1:]], dim=1).contiguous()
    err = compare(
        (None, costs_k, states_k), (None, *cr.rollout_reference(spec, init, step_table, controls)),
        lambda: (None, *cr.rollout_reference(spec, init.double(), step_table.double(), controls.double())),
        drift=drift,
    )
    return {"fresh_max_err_in_scale_units": fresh_err, **err}


def distribution_gate(noise, scale) -> list:
    """Per dof over rows 2..R of (S, 12, R) all-fresh noise: mean, std and
    skew within 5 sigma of N(0, scale^2) (scripts/tpu_crosscheck.py:164-176);
    a dof of scale 0 exactly 0. Raises on a miss; returns the statistics."""
    rows = []
    for d in range(noise.shape[1]):
        z = noise[:, d, 2:].double().flatten()
        expected = float(scale[d])
        n = z.numel()
        mean, std = float(z.mean()), float(z.std(unbiased=False))
        entry = {"dof": d, "mean": mean, "std": std, "expected_std": expected}
        if expected > 0:
            skew = float(((z - mean) ** 3).mean()) / std ** 3
            entry["skew"] = skew
            if (abs(mean) > 5 * expected / n ** 0.5 or abs(std - expected) > 5 * expected / (2 * n) ** 0.5
                    or abs(skew) > 5 * (6.0 / n) ** 0.5):
                raise AssertionError(f"in-kernel draws fail the 5-sigma gate: {json.dumps(entry)}")
        elif std != 0.0 or mean != 0.0:
            raise AssertionError(f"a zero-scale dof drew nonzero noise: {json.dumps(entry)}")
        rows.append(entry)
    return rows


def outlier_allowance(rollouts: int) -> float:
    """The rollouts ``compare``'s share rules allow: OUTLIER_SHARE of them,
    at least one."""
    return max(1.0, OUTLIER_SHARE * rollouts)


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
    than float32 rounding does anywhere in the batch. How many rollouts
    graze a barrier depends on the batch: in some batches of 1,024
    rollouts the plain float32 version alone is beyond RTOL / 2 of float64
    in more than 1% of them. Where there are more outliers than
    OUTLIER_SHARE of the rollouts, the kernel itself is held to float64:
    it may be beyond RTOL / 2 of the float64 value in at most as many
    rollouts as the plain float32 version is, plus OUTLIER_SHARE of the
    rollouts (the share the first rule allows). A correct kernel is as
    often beyond RTOL / 2 as the plain version; a fault in more than that
    share of the rollouts adds its own. Every outlier is still held to
    float64 as above. A share is counted in whole rollouts, at least one
    (``outlier_allowance``): below 100 rollouts 1% is less than one, and a
    rule that refused the one barrier-grazing rollout a small batch may
    hold (R = 33: kernel 2's partial warp pair) would refuse rounding.

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
    allowance = outlier_allowance(costs_k.shape[0])
    if out["violations_differ"] > allowance:
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
    if not (out["smooth_outliers"] or out["states_beyond_rtol"] or out["violations_differ"]):
        return out
    exact = exact_fn()
    if not drift and out["smooth_outliers"] > allowance:
        truth = exact[1][:, 1]
        truth_scale = truth.abs().nan_to_num().clamp(min=1.0)
        for who, values in (("kernel", costs_k[:, 1]), ("plain", costs_p[:, 1])):
            rel = (values.double() - truth).abs().nan_to_num() / truth_scale
            out[f"{who}_smooth_beyond_half_rtol_of_float64"] = int((rel > RTOL / 2).sum())
        allowed = out["plain_smooth_beyond_half_rtol_of_float64"] + allowance
        if out["kernel_smooth_beyond_half_rtol_of_float64"] > allowed:
            raise AssertionError(
                f"smooth: {out['smooth_outliers']} rollouts beyond {RTOL}, more than {OUTLIER_SHARE} of the "
                f"rollouts, and the kernel is beyond {RTOL / 2} of float64 in "
                f"{out['kernel_smooth_beyond_half_rtol_of_float64']}, more than the plain version's "
                f"{out['plain_smooth_beyond_half_rtol_of_float64']} + {OUTLIER_SHARE} of the rollouts"
            )
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
        if stats["kernel_differs_from_float64"] > allowance:
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


def timed_call(fn) -> tuple:
    """(fn(), the milliseconds of that one call from CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_call(fn, repeats: int) -> float:
    """Milliseconds per call from CUDA events over ``repeats`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def bound(instructions: float, bytes_needed: int, fp32_instructions_per_s: float) -> tuple:
    """(bound ms, "operations" or "bytes", operations ms, bytes ms) for one
    launch: the larger of the instructions it must issue over the card's
    FP32 issue rate and the bytes that must move over its memory rate."""
    ops_ms = instructions / fp32_instructions_per_s * 1e3
    bytes_ms = bytes_needed / MEMORY_RATE * 1e3
    return (ops_ms, "operations", ops_ms, bytes_ms) if ops_ms >= bytes_ms else (bytes_ms, "bytes", ops_ms, bytes_ms)


def report_bound(label: str, R: int, S: int, kernel_ms: float, instructions: int, bytes_needed: int,
                 fp32_instructions_per_s: float, card: str) -> dict:
    """Print one launch's time beside its bound; returns the bound's entry."""
    bound_ms, bound_by, ops_ms, bytes_ms = bound(instructions, bytes_needed, fp32_instructions_per_s)
    print(f"{label} at R={R} S={S}: {kernel_ms:.4f} ms/launch; bound {bound_ms * 1e3:.4g} us by "
          f"{bound_by} (operations {ops_ms * 1e3:.4g} us, bytes {bytes_ms * 1e3:.4g} us); "
          f"{bound_ms / kernel_ms * 100:.3g}% of bound; {card}")
    return {"bound_ms": bound_ms, "bound_by": bound_by}


def fused_bytes(R: int, S: int) -> int:
    return (
        (R - 2) * S * 12 * 4  # one noise source read per sampled element
        + R  # keep mask
        + 4 * (32 + S * 32 + 3)  # init, per-step table, meta
        + S * 12 * R * 4 + R * 2 * 4 + S * 24 * 4  # noise, costs, states written
    )


def inkernel_work(inputs) -> tuple:
    """(instructions, bytes) one in-kernel-RNG launch needs on ``inputs``:
    the step body at every rollout-step plus the draws' slots where a draw
    is taken; the old noise read where an elite row keeps it, the noise,
    costs and states written."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    init, table, meta, old, keep, words, scale = inputs
    S, _, R = old.shape
    mask = cr.fresh_mask(meta, keep, S)
    draws = int(mask.sum())
    reads_old = int((keep[None, None, :] & ~mask).sum())  # elite row-steps that keep old noise
    instructions = R * S * cr.STEP_FP32_INSTRUCTIONS + draws * (cr.DRAW_FP32_SLOTS + cr.DRAW_INTEGER_INSTRUCTIONS)
    bytes_needed = (
        reads_old * 12 * 4 + R + 4 * (32 + S * 32 + 3 + 2 + 12)  # old, keep, init, table, meta, seed, scale
        + S * 12 * R * 4 + R * 2 * 4 + S * 24 * 4  # noise, costs, states written
    )
    return instructions, bytes_needed


def rollout_bytes(R: int, S: int, C: int = 1) -> int:
    return (
        S * 12 * R * 4  # controls read once
        + 4 * (32 + C * S * 8)  # init, per-step tables
        + C * R * 2 * 4 + S * 24 * 4  # costs, states written
    )


def rollout_instructions(R: int, S: int, C: int = 1) -> int:
    """FP32 instructions a C-scenario two-pass launch needs: the step body
    once per rollout-step, each further scenario's trajectory term and
    accumulations."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr

    return R * S * (cr.STEP_FP32_INSTRUCTIONS + (C - 1) * cr.SCENARIO_FP32_INSTRUCTIONS)


def check_planner_against_cpu(rollouts: int = 254, steps: int = 8, updates: int = 4, scenarios: int = 1,
                              options=None):
    """The flagship planner (``build_flagship(**options)``) on the card
    against the same planner on the CPU: each update starts both from the
    card's state and feeds both the same fresh draws. The keep mask's elite
    set and the noise must match exactly, the published controls within
    1e-3 (controls span +-100; the float32 cost differences of phase 2 move
    the softmax weights). Returns the card's last state."""
    import numpy as np

    from assistedmanipulation_tpu_torch import interop
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    options = options or {}
    gpu = build_flagship(rollouts, steps, scenarios=scenarios, **options)
    cpu = build_flagship(rollouts, steps, device="cpu", scenarios=scenarios, **options)
    R = gpu.planner.rollout_count
    rng = np.random.default_rng(0)
    state = gpu.init(seed=0)
    for k in range(updates):
        fresh = (rng.standard_normal((R, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)).astype(np.float32)
        arrays = interop.planner_state_to_numpy(state)
        cpu_state = interop.planner_state_from_numpy({**arrays, "rng": np.zeros(2, np.uint32)}, R, device="cpu")
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
        print(f"small planner {json.dumps(options)} R={R} S={steps} scenarios={scenarios} update {k}: noise "
              f"equal, optimal control max abs diff {err:.3g} against the CPU planner")
    return state


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
    """Every kernel's launches since the last reset against ``expected``
    (kernels it does not name: 0)."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    launches = dict(cuda_rollout.LAUNCHES)
    expected = {name: expected.get(name, 0) for name in launches}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    return launches


def check_inkernel_planner_against_cpu(rollouts: int = 254, steps: int = 8, updates: int = 4) -> None:
    """The in-kernel-RNG flagship on the card against the fused flagship on
    the CPU: each update starts both from the card's state; the CPU side is
    fed as fresh draws what ``philox.normal_draws`` makes of the seed words
    the card's sampler takes (``split_key`` of the state's key). The keep
    mask and the noise that is not a fresh draw must match exactly, fresh
    draws within FRESH_TOLERANCE x scale, the controls within 1e-3."""
    from assistedmanipulation_tpu_torch import interop
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels.philox import normal_draws, split_key
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.ops.gaussian import diagonal_scale
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    gpu = build_flagship(rollouts, steps, inkernel_rng=True)
    cpu = build_flagship(rollouts, steps, device="cpu")
    R = gpu.planner.rollout_count
    scale = torch.tensor(diagonal_scale(fr.DEFAULT_COVARIANCE), dtype=torch.float32)
    state = gpu.init(seed=0)
    for k in range(updates):
        arrays = interop.planner_state_to_numpy(state)
        cpu_state = interop.planner_state_from_numpy(arrays, R, device="cpu")
        fresh = normal_draws(split_key(state.rng)[1], steps, R, scale)
        time_k = torch.tensor(0.01 * k)
        _, shift, do_shift, _, keep = gpu.planner._sample_meta(state, time_k.cuda())
        _, cpu_shift, cpu_do_shift, _, cpu_keep = cpu.planner._sample_meta(cpu_state, time_k)
        if not (torch.equal(keep.cpu(), cpu_keep) and int(shift) == int(cpu_shift)):
            raise AssertionError(f"in-kernel planner update {k}: keep mask or shift differs from the CPU's")
        state, info = gpu.update(state, gpu.x0, time_k.cuda(), gpu.make_ctx())
        cpu_state, _ = cpu.update(cpu_state, cpu.x0, time_k, cpu.make_ctx(), fresh=cr.noise_to_logical(fresh))
        meta = torch.tensor([int(cpu_shift), int(cpu_do_shift), 1], dtype=torch.int32)
        fresh_err = check_fresh_noise(state.noise.cpu(), cpu_state.noise, cr.fresh_mask(meta, cpu_keep, steps), scale)
        err = float((state.optimal_control.cpu() - cpu_state.optimal_control).abs().max())
        if err > 1e-3:
            raise AssertionError(f"in-kernel planner update {k}: optimal control differs by {err:.3g}")
        print(f"small in-kernel-RNG planner R={R} S={steps} update {k}: keep mask and non-fresh noise equal, "
              f"fresh draws within {fresh_err:.3g} x scale, optimal control max abs diff {err:.3g} "
              f"against the CPU planner")


def drive_flagship(flagship, expected_launches: dict, label: str, card: str, kernels: list,
                   warmup: int = WARMUP_UPDATES, timed: int = TIMED_UPDATES,
                   profiled: int = PROFILED_UPDATES, per_step: int = 1) -> tuple:
    """``warmup`` then ``timed`` updates of ``flagship`` with its own
    context; the launch counts are set to 0 just before the timed updates
    and read just after (``expected_launches``: per kernel, launches per
    update). Then ``profile_steps`` over ``profiled`` more, each of
    ``kernels`` (keys of KERNEL_PATTERNS) ``per_step`` times per update.
    Returns (launches, summary)."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    planner = flagship.planner
    ctx, x0 = flagship.make_ctx(), flagship.x0
    state = flagship.init(seed=0)
    times = torch.arange(1, warmup + timed + profiled + 1, dtype=torch.float32, device="cuda") * 0.01
    for i in range(warmup):
        state, info = flagship.update(state, x0, times[i], ctx)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(timed)]
    degenerate = []
    cuda_rollout.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(timed):
        events[i][0].record()
        state, info = flagship.update(state, x0, times[warmup + i], ctx)
        events[i][1].record()
        degenerate.append(info.degenerate.clone())  # a captured update rewrites its info in place
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches({name: per_update * timed for name, per_update in expected_launches.items()})
    check_outputs(state, info, degenerate)
    update_ms = statistics.median(start.elapsed_time(end) for start, end in events)
    print(f"{label} R={planner.rollout_count} S={planner.steps}: {timed / wall:.2f} solves/s "
          f"(host wall {wall * 1e3 / timed:.3f} ms/update over {timed}), median update {update_ms:.4f} ms "
          f"(CUDA events), kernel launches {json.dumps(launches)}, "
          f"degenerate updates {int(torch.stack(degenerate).sum())}; {card}")
    profile = profile_steps(
        lambda k: flagship.update(state, x0, times[warmup + timed + k], ctx), profiled, kernels, label, card,
        per_step,
    )
    return launches, {"solves_per_s": timed / wall, "update_ms_median": update_ms,
                      "host_wall_ms": wall * 1e3 / timed, **profile}


def profile_steps(step, n: int, kernels: list, label: str, card: str, per_step: int = 1) -> dict:
    """``step(k)`` for k < n under torch.profiler: device kernels (and
    copies) per step, host launch calls per step (a graph launch counts
    one), device time and its share of the window's host wall. Each name in
    ``kernels`` (a key of KERNEL_PATTERNS) must have run exactly
    ``per_step`` times per step (once, or once per rollout shard), so no
    graph can hide a missing kernel. The steps start PROFILE_MARGIN_S
    after the trace does and end as long before it stops, so that no
    device record of theirs lies at an edge of the trace's window (a
    window's first kernel was once missing from its count). The trace
    takes the CUDA activity alone: it holds the device's kernels, copies
    and memsets and the host's CUDA runtime calls (the launch calls counted
    here), and leaves out the record of every ATen operation on the host;
    and it is read raw (``trace_events``). On a plant path's eager update
    (~80,000 operations) the window and its summary took ~50 s with the ATen
    record and ``key_averages``, ~7 s so (PERF.md §6)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for k in range(n):
            step(k)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    # The profiler turned the port's tracer on; nothing here reads it, so
    # the phases after this one run with it off, as before it existed.
    from assistedmanipulation_tpu_torch import tracing

    tracing.stop()
    device_us, device_ops, calls = 0.0, 0, {}
    found = {name: 0 for name in kernels}
    for name, device_type, duration_ns in trace_events(prof):
        if device_type == torch.autograd.DeviceType.CUDA:
            device_us += duration_ns / 1e3
            device_ops += 1
            for kernel in kernels:
                if re.search(KERNEL_PATTERNS[kernel], name):
                    found[kernel] += 1
        elif name in LAUNCH_CALLS:
            calls[name] = calls.get(name, 0) + 1
    if any(count != n * per_step for count in found.values()):
        raise AssertionError(f"{label}: the rollout kernels ran {found} times in {n} steps, not {per_step} each")
    out = {
        "device_ops_per_update": device_ops / n,
        "launch_calls_per_update": sum(calls.values()) / n,
        "graph_launches_per_update": calls.get("cudaGraphLaunch", 0) / n,
        "device_ms_per_update": device_us / 1e3 / n,
        "busy_share": device_us / 1e3 / window_ms,
    }
    print(f"{label} profile over {n} updates: {json.dumps(out)}; launch calls {json.dumps(calls)}; "
          f"rollout kernels {json.dumps(found)}; {card}")
    return out


def trace_events(prof):
    """(demangled name, device type, duration in ns) of each event of a
    finished ``torch.profiler`` trace, read from its raw results as the
    profiler's own parse reads them (hidden events left out). The
    profiler's summary (``key_averages``) builds an object per event: 13.5
    s over the ~80,000 device records of a plant path's update, where this
    reads them in 3.1 s."""
    for event in prof.profiler.kineto_results.events():
        if getattr(event, "is_hidden_event", lambda: False)():
            continue
        yield torch._C._demangle(event.name()), event.device_type(), event.duration_ns()


def bitwise_equal(got, want, label: str) -> None:
    """Every tensor of (nested) NamedTuples ``got`` and ``want`` equal to
    the last bit (NaN included)."""
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, tuple):
            bitwise_equal(g, w, f"{label}.{name}")
            continue
        if g.dtype in (torch.float32, torch.float64):
            g, w = g.view(torch.int32 if g.dtype == torch.float32 else torch.int64), w.view(
                torch.int32 if w.dtype == torch.float32 else torch.int64)
        if g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{label}.{name}: the captured value differs from the eager one")


def check_captured_against_eager(options: dict, label: str, updates: int = CAPTURE_CHECK_UPDATES):
    """``build_flagship(capture=True, **options)`` in lockstep with the
    eager ``build_flagship(**options)`` over ``updates`` updates from the
    same key, every state field and info output bitwise equal. Returns the
    captured flagship (its graph captured)."""
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    eager, captured = build_flagship(**options), build_flagship(capture=True, **options)
    ctx = eager.make_ctx()
    times = torch.arange(1, updates + 1, dtype=torch.float32, device="cuda") * 0.01
    state = want = eager.init(seed=0)
    for k in range(updates):
        want, want_info = eager.update(want, eager.x0, times[k], ctx)
        state, info = captured.update(state, captured.x0, times[k], ctx)
        bitwise_equal(state, want, f"{label} update {k}: state")
        bitwise_equal(info, want_info, f"{label} update {k}: info")
    print(f"{label}: {updates} captured updates bitwise equal to the eager ones (noise, costs, "
          f"optimal control, states, every field); graph's kernel nodes "
          f"{json.dumps(captured.update.captured.graph.launches)}")
    return captured


def drive_both(options: dict, expected_launches: dict, label: str, card: str, kernels: list,
               counts=None) -> tuple:
    """A cell eager and captured, one after the other: ``drive_flagship``
    on each, the captured one first held bitwise to the eager one.
    ``counts``: as PLANT_COUNTS, the (warm-up, timed, profiled) updates of
    each path and the lockstep ones; by default (WARMUP_UPDATES,
    TIMED_UPDATES, PROFILED_UPDATES) and CAPTURE_CHECK_UPDATES. Returns
    (eager launches, {"eager": summary, "captured": summary})."""
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    default = (WARMUP_UPDATES, TIMED_UPDATES, PROFILED_UPDATES)
    counts = counts or {"eager": default, "captured": default, "lockstep": CAPTURE_CHECK_UPDATES}
    launches, eager = drive_flagship(
        build_flagship(**options), expected_launches, f"{label} eager", card, kernels, *counts["eager"]
    )
    captured_flagship = check_captured_against_eager(options, f"{label} captured", counts["lockstep"])
    _, captured = drive_flagship(
        captured_flagship, expected_launches, f"{label} captured", card, kernels, *counts["captured"]
    )
    if captured["graph_launches_per_update"] != 1:
        raise AssertionError(f"{label}: {captured['graph_launches_per_update']} graph launches per update, not 1")
    return launches, {"eager": eager, "captured": captured}


def kalman_serving_loop(flagship, card: str) -> dict:
    """KALMAN_UPDATES ticks of ``make_serving_tick``: measure wrench ->
    Kalman forecast update -> draw SCENARIOS scenarios -> planner update,
    on the card. The measured wrench is a 20 N x-pull with a 2 N, 1 Hz
    y-sway; the filter's noise model is set so the posterior (and the
    ensemble) is not degenerate. Eager and captured (one CUDA graph per
    tick) in lockstep, bitwise equal; then each timed from fresh states and
    profiled. Returns {"eager": summary, "captured": summary}."""
    from assistedmanipulation_tpu_torch.forecast.forecast import (
        KalmanForecast, KalmanForecastConfiguration,
    )
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.parallel.flagship import make_serving_tick

    steps, device = flagship.planner.steps, flagship.x0.device
    strategy = KalmanForecast(KalmanForecastConfiguration(
        time_step=0.01, horizon=steps * 0.01, observation_variance=0.25, transition_variance=0.01,
    ))
    times = torch.arange(KALMAN_UPDATES, dtype=torch.float32, device=device) * 0.01
    wrench = torch.zeros((KALMAN_UPDATES, 6), dtype=torch.float32, device=device)
    wrench[:, 0] = 20.0
    wrench[:, 1] = 2.0 * torch.sin(2 * torch.pi * times)
    generators = {path: torch.Generator(device=device) for path in ("eager", "captured")}
    ticks = {path: make_serving_tick(flagship, strategy, SCENARIOS, generators[path], capture=path == "captured")
             for path in generators}

    def fresh_start():
        for generator in generators.values():
            generator.manual_seed(3)
        return {path: (strategy.init(device=device), flagship.init(seed=1)) for path in ticks}

    # Lockstep: the captured tick bitwise the eager one, tick by tick.
    states = fresh_start()
    for k in range(CAPTURE_CHECK_UPDATES):
        out = {}
        for path, tick in ticks.items():
            out[path] = tick(*states[path], flagship.x0, wrench[k], times[k])
            states[path] = out[path][:2]
        for index, name in enumerate(("forecast state", "planner state", "info")):
            bitwise_equal(out["captured"][index], out["eager"][index], f"phase 5 tick {k}: {name}")
        if not torch.equal(out["captured"][3].view(torch.int32), out["eager"][3].view(torch.int32)):
            raise AssertionError(f"phase 5 tick {k}: the captured horizons differ from the eager ones")
    print(f"phase 5 captured serving tick: {CAPTURE_CHECK_UPDATES} ticks bitwise equal to the eager ones "
          f"(horizons, forecast and planner states, info)")

    summary = {}
    states = fresh_start()
    for path, tick in ticks.items():
        forecast_state, state = states[path]
        degenerate, spread = [], []
        torch.cuda.synchronize()
        cuda_rollout.reset_launch_counts()
        t0 = time.perf_counter()
        for k in range(KALMAN_UPDATES):
            forecast_state, state, info, horizons = tick(forecast_state, state, flagship.x0, wrench[k], times[k])
            degenerate.append(info.degenerate.clone())
            spread.append((horizons[1:] - horizons[0]).abs().max())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches({"rollout": KALMAN_UPDATES})  # one launch for all scenarios
        check_outputs(state, info, degenerate)
        if horizons.shape != (SCENARIOS, steps + 1, 6) or not bool(torch.isfinite(horizons).all()):
            raise AssertionError("the sampled scenarios are not finite horizons of the expected shape")
        spread = torch.stack(spread)
        if not bool((spread > 0).all()):
            raise AssertionError("a scenario ensemble collapsed onto its mean")
        tick_ms = wall * 1e3 / KALMAN_UPDATES
        label = f"phase 5 Kalman-driven loop {path}"
        print(f"{label} R={flagship.planner.rollout_count} S={steps} scenarios={SCENARIOS}: "
              f"{KALMAN_UPDATES} ticks, host wall {tick_ms:.3f} ms per measure+forecast+sample+update "
              f"({'within' if tick_ms <= CONTROL_PERIOD_MS else 'over'} the {CONTROL_PERIOD_MS} ms period), "
              f"kernel launches {json.dumps(launches)}, scenario spread {float(spread.min()):.3g}-"
              f"{float(spread.max()):.3g} N, degenerate updates {int(torch.stack(degenerate).sum())}; {card}")
        profile = profile_steps(
            lambda k: tick(forecast_state, state, flagship.x0, wrench[k], times[k]),
            PROFILED_UPDATES, [f"rollout x{SCENARIOS}"], label, card,
        )
        summary[path] = {"tick_ms": tick_ms, **profile}
    if summary["captured"]["graph_launches_per_update"] != 1:
        raise AssertionError("phase 5: the captured tick is not one graph launch")
    return summary


def resimulate_phase(spec, card: str, fp32_instructions_per_s: float) -> tuple:
    """Phase 9: ``build_flagship(optimal_rollout_mode="resimulate")``. The
    published re-rollout held to the plain version on the published
    sequence; eager and captured driven (``drive_both``); kernel 2 timed at
    R = 1. Returns (worst errors, launches, summaries, R = 1 timing)."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.mppi import compose_cost
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    options = {"optimal_rollout_mode": "resimulate"}
    flagship = build_flagship(**options)
    ctx, x0 = flagship.make_ctx(), flagship.x0
    state = flagship.init(seed=5)
    worst = {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0}
    for k in range(4):
        time_k = torch.tensor(0.01 * (k + 1), device="cuda")
        state, info = flagship.update(state, x0, time_k, ctx)
        # The re-rollout's channels and states from the kernel again (it is
        # deterministic: the published ones must be these, bitwise), held to
        # the plain version on the published sequence.
        channels, states = flagship.planner.filter_rollout_fn(state.optimal_control, x0, time_k, ctx)
        if not (torch.equal(info.optimal_rollout_states, states)
                and torch.equal(info.optimal_cost, compose_cost(channels))):
            raise AssertionError(f"phase 9 update {k}: the published optimal rollout is not the re-rollout's")
        init = cr.initial_state(x0)
        table = cr.step_table(ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0, time_k, ctx)
        controls = state.optimal_control[:, :, None].contiguous()
        err = compare(
            (None, channels[None], states[:, :24]), (None, *cr.rollout_reference(spec, init, table, controls)),
            lambda: (None, *cr.rollout_reference(spec, init.double(), table.double(), controls.double())),
        )
        for key in worst:
            worst[key] = max(worst[key], err[key])
        print(f"phase 9 resimulate update {k}: the published optimal rollout is the R = 1 kernel-2 re-rollout "
              f"of the published sequence; against the plain version {json.dumps(err)}")
    del flagship
    launches, summaries = drive_both(
        options, {"fused_sample_rollout": 1, "rollout": 1},
        "phase 9 resimulate flagship", card, ["fused_sample_rollout", "rollout x1"],
    )

    # Kernel 2 at R = 1: one thread through STEPS dependent steps.
    inputs = rollout_kernel_inputs(1, STEPS, seed=13)
    for _ in range(3):
        cr.rollout(spec, *inputs)
    kernel_ms = time_call(lambda: cr.rollout(spec, *inputs), 200)
    timing = {"ms": kernel_ms, **report_bound(
        "rollout x1 (resimulate)", 1, STEPS, kernel_ms, rollout_instructions(1, STEPS), rollout_bytes(1, STEPS),
        fp32_instructions_per_s, card)}
    timing["plain_ms"] = time_call(lambda: cr.rollout_reference(spec, *inputs), 1)
    print(f"plain version at R=1 S={STEPS}: rollout_reference {timing['plain_ms']:.3f} ms; {card}")
    return worst, launches, summaries, timing


def check_safe_velocity(state) -> float:
    """The first published control of a safety planner applied to the
    huddled state by the float64 plant on the CPU: the next velocity within
    the filter's velocity limit + 5e-3 (JAX tests/test_safety.py's bound).
    Returns the largest excess over the limit (negative inside)."""
    from assistedmanipulation_tpu_torch import safety
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr

    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float64)
    control = state.optimal_control[0].double().cpu()
    x1, _ = fr.make_plant_step()(x0, control, torch.zeros(6, dtype=torch.float64), 0.01)
    excess = float((x1[fr.VELOCITY].abs() - torch.tensor(safety.DEFAULT_VELOCITY_LIMIT)).max())
    if excess > 5e-3:
        raise AssertionError(f"the filtered first control's next velocity exceeds the limit by {excess:.3g}")
    return excess


def time_graph(fn, repeats: int) -> float:
    """Milliseconds per replay of ``fn`` captured as one CUDA graph (after
    one eager call), from CUDA events over ``repeats`` replays."""
    from assistedmanipulation_tpu_torch import graphs

    fn()
    graph = graphs.CapturedGraph(fn)
    graph.replay()
    return time_call(graph.replay, repeats)


def filter_state(name: str, device="cuda") -> torch.Tensor:
    """A start of the safety flagship's re-rollout: "x0", the huddled state
    (the flagship's and the benchmark's; no limit binds in its first
    update); "base_velocity", the same with the base at 98-99% of its
    velocity limits (18 of the 50 QPs bind, every one feasible); "reach",
    the reach pose (every QP binds and none can be met)."""
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr

    x = torch.tensor(fr.make_state("reach" if name == "reach" else "huddled"), dtype=torch.float32, device=device)
    if name == "base_velocity":
        x[12:15] = torch.tensor([0.49, 0.49, 0.99])
    return x


def filter_qps(flagship, x) -> list:
    """The (args, kwargs) of every ``solve_qp`` call of one update of the
    safety ``flagship`` from state ``x``: its re-rollout's QPs."""
    from assistedmanipulation_tpu_torch.ops import admm_qp

    recorded, solve = [], admm_qp.solve_qp

    def record(*args, **kwargs):
        recorded.append((args, kwargs))
        return solve(*args, **kwargs)

    admm_qp.solve_qp = record
    try:
        flagship.update(flagship.init(seed=3), x, torch.tensor(0.01, device=x.device), flagship.make_ctx())
    finally:
        admm_qp.solve_qp = solve
    return recorded


def qp_fmas(n: int, m: int, iterations: int, blocks: int) -> int:
    """FMAs one solve needs, as csrc/admm_qp.cu computes it: A^T A and the
    first z; per block K, the factor and its inverse, K^-1, E, the maps
    (their n + m rows by n + 2m + 1 columns, n each), the iterations (n + m
    + 1 rows by n + 2m + 1 columns) and the residuals."""
    rows, columns = n + m + 1, n + 2 * m + 1
    per_block = (n * n + n ** 3 // 3 + n ** 3 + m * n * n + (rows - 1) * columns * n
                 + iterations * rows * columns + 2 * m * n + n * n)
    return n * n * m + m * n + blocks * per_block


def qp_kernel_check(card: str, fp32_instructions_per_s: float) -> dict:
    """The QP kernel against ``solve_qp_plain`` on the card, float32 and
    float64, on the QPs of a filtered re-rollout (510 rollouts x STEPS) from
    the flagship's state and from the base at 98-99% of its velocity limits
    (some bind): x and the residuals within QP_TOLERANCE x max(|u_target|,
    1), z and y within it x their largest magnitude. Then one of the
    filter's 12 x 37 QPs (N = 1, 4 blocks x 40 iterations) timed alone
    (``time_qp``) beside the plain version and the bound. Returns the
    kernel's entry."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.ops import admm_qp
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    flagship = build_flagship(rollouts=510, steps=STEPS, safety=True)
    worst = {"max_abs_err": 0.0, "max_err_in_target_units": 0.0}
    moved = 0
    for label in ("x0", "base_velocity"):
        qps = filter_qps(flagship, filter_state(label))
        for dtype in (torch.float32, torch.float64):
            tol = QP_TOLERANCE[dtype]
            for step, (args, kwargs) in enumerate(qps):
                args = [value.to(dtype) for value in args]
                kwargs = {key: value.to(dtype) if isinstance(value, torch.Tensor) else value
                          for key, value in kwargs.items()}
                got, want = admm_qp.solve_qp(*args, **kwargs), admm_qp.solve_qp_plain(*args, **kwargs)
                target = max(float(kwargs["x0"].abs().max()), 1.0)
                for name in ("x", "primal_residual", "dual_residual", "z", "y"):
                    g, w = getattr(got, name), getattr(want, name)
                    err = float((g - w).abs().max())
                    scale = max(float(w.abs().max()), 1.0) if name in ("z", "y") else target
                    if not err <= tol * scale:
                        raise AssertionError(f"phase 10 QP kernel, {label}, step {step}, {dtype}: {name} off by "
                                             f"{err:.3g}, beyond {tol:g} x {scale:.3g}")
                    if name == "x" and dtype == torch.float32:
                        worst["max_abs_err"] = max(worst["max_abs_err"], err)
                        worst["max_err_in_target_units"] = max(worst["max_err_in_target_units"], err / target)
                moved += int(dtype == torch.float32 and bool((want.x - kwargs["x0"]).abs().max() > 1e-3))
    if not moved:
        raise AssertionError("phase 10 QP kernel: no recorded QP moved its control")
    print(f"phase 10 QP kernel against its plain version on 2 x {STEPS} filter QPs ({moved} bind), float32 "
          f"and float64: within {json.dumps({str(k): v for k, v in QP_TOLERANCE.items()})}; float32 x "
          f"{json.dumps(worst)}")

    args, kwargs = filter_qps(flagship, filter_state("base_velocity"))[0]
    n, m = args[1].shape[-1], args[2].shape[-2]
    cuda_rollout.reset_launch_counts()
    timing = time_qp(args, kwargs)
    if cuda_rollout.LAUNCHES["admm_qp"] != 2 * QP_TIMED_LAUNCHES * (2 + QP_REPLAYS):
        raise AssertionError(f"phase 10 QP kernel: {cuda_rollout.LAUNCHES['admm_qp']} launches, not "
                             f"{QP_TIMED_LAUNCHES} per eager pass and per replay of each of two graphs")
    ms = timing["ms"]
    fmas = qp_fmas(n, m, kwargs["iterations"], kwargs["adaptive_blocks"])
    entry = report_bound(f"phase 10 admm_qp {n} x {m}, N = 1", 1, kwargs["iterations"], ms, fmas,
                         4 * (n * n + 3 * n + m * n + 2 * m + n + 2 * m + 2), fp32_instructions_per_s, card)
    print(f"phase 10 admm_qp: {json.dumps(timing)} ms; {fmas} FMAs a solve; {card}")
    return {**timing, "fmas": fmas, "n": n, "m": m, **entry, **worst}



def time_qp(args, kwargs) -> dict:
    """One QP (``solve_qp``'s args and kwargs) solved QP_TIMED_LAUNCHES times
    in one CUDA graph, ms per solve over QP_REPLAYS replays: ``ms`` by the
    kernel, ``no_iterations_ms`` by the kernel at 0 iterations (the set-up:
    staging, the blocks' factorisations and maps, the residuals),
    ``us_per_iteration`` the difference over the blocks' iterations,
    ``plain_ms`` by the plain version in a graph (what the filter's span
    paid per step before the kernel), ``plain_eager_ms`` eagerly. A graph
    replay is timed, not an eager call, because the kernel takes less time
    than the host's call into it."""
    from assistedmanipulation_tpu_torch.ops import admm_qp

    def per_solve(fn, launches=QP_TIMED_LAUNCHES):
        return time_graph(lambda: [fn() for _ in range(launches)], QP_REPLAYS) / launches

    idle = {**kwargs, "iterations": 0}
    out = {
        "ms": per_solve(lambda: admm_qp.solve_qp(*args, **kwargs)),
        "no_iterations_ms": per_solve(lambda: admm_qp.solve_qp(*args, **idle)),
        "plain_ms": per_solve(lambda: admm_qp.solve_qp_plain(*args, **kwargs), 5),
        "plain_eager_ms": time_call(lambda: admm_qp.solve_qp_plain(*args, **kwargs), 5),
    }
    iterations = kwargs["iterations"] * kwargs["adaptive_blocks"]
    out["us_per_iteration"] = (out["ms"] - out["no_iterations_ms"]) * 1e3 / iterations
    return out


def safety_phase(card: str, fp32_instructions_per_s: float) -> tuple:
    """Phase 10: ``build_flagship(safety=True)``. The small card-against-CPU
    check and the filtered first control's next velocity; the published
    re-rollout held to the plant on the published sequence (float32 on the
    CPU, float64); the QP kernel against its plain version and timed
    (``qp_kernel_check``); eager and captured driven (``drive_both``,
    PLANT_COUNTS); the filtered re-rollout's share of the captured update's
    device time. Returns (worst errors, launches, summaries, the QP
    kernel's entry)."""
    from assistedmanipulation_tpu_torch import mppi
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    options = {"safety": True}
    excess = check_safe_velocity(check_planner_against_cpu(options=options))
    print(f"phase 10 small safety planner: the first published control's next velocity within the limit "
          f"(largest excess {excess:.3g} rad/s or m/s, bound 5e-3)")

    flagship = build_flagship(**options)
    planner, ctx, x0 = flagship.planner, flagship.make_ctx(), flagship.x0
    cpu = build_flagship(rollouts=14, steps=STEPS, device="cpu", **options)
    cpu_ctx = cpu.make_ctx()
    state = flagship.init(seed=5)
    worst = {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0}
    for k in range(2):
        time_k = torch.tensor(0.01 * (k + 1), device="cuda")
        state, info = flagship.update(state, x0, time_k, ctx)
        published = state.optimal_control
        # The plant alone on the published (filtered) sequence: on the card
        # it is the published re-rollout, bitwise; held to the CPU's float32
        # and float64 runs.
        channels, states, _ = mppi.plant_rollout(planner.plant, published, x0, time_k, ctx, 0.01)
        if not (torch.equal(states, info.optimal_rollout_states)
                and torch.equal(mppi.compose_cost(channels), info.optimal_cost)):
            raise AssertionError(f"phase 10 update {k}: the published optimal rollout is not the plant's re-rollout")

        def on_cpu(dtype):
            c, st, _ = mppi.plant_rollout(
                cpu.planner.plant, published.cpu().to(dtype), x0.cpu().to(dtype), time_k.cpu().to(dtype),
                cpu_ctx, 0.01,
            )
            return None, c[None], st

        err = compare((None, channels[None].cpu(), states.cpu()), on_cpu(torch.float32), lambda: on_cpu(torch.float64))
        for key in worst:
            worst[key] = max(worst[key], err[key])
        print(f"phase 10 safety update {k}: the published optimal rollout is the plant's re-rollout of the "
              f"published (filtered) sequence; against the CPU float32 and float64 runs {json.dumps(err)}")
    qp = qp_kernel_check(card, fp32_instructions_per_s)
    launches, summaries = drive_both(
        options, {"fused_sample_rollout": 1, "admm_qp": STEPS}, "phase 10 safety flagship", card,
        ["fused_sample_rollout"], PLANT_COUNTS,
    )

    # The filtered re-rollout alone, captured, against the captured update.
    time_k = torch.tensor(0.5, device="cuda")
    rerollout_ms = time_graph(
        lambda: mppi.plant_rollout(planner.plant, state.optimal_control, x0, time_k, ctx, 0.01,
                                   filter_fn=planner.filter_fn), 5,
    )
    update_ms = summaries["captured"]["update_ms_median"]
    summaries["filtered_rerollout"] = {"graph_ms": rerollout_ms, "share_of_captured_update": rerollout_ms / update_ms}
    print(f"phase 10 filtered re-rollout (50 steps of derive, objective, QP filter, integrate) captured alone: "
          f"{rerollout_ms:.3f} ms per replay, {rerollout_ms / update_ms:.3f} of the captured update's "
          f"{update_ms:.3f} ms; {card}")
    return worst, launches, summaries, qp


def vmap_phase(card: str) -> dict:
    """Phase 11: ``build_flagship(backend="vmap")``: the small card-against-
    CPU check, then eager and captured (``drive_both``, PLANT_COUNTS) with
    no kernel launch. Returns the summaries."""
    options = {"backend": "vmap"}
    check_planner_against_cpu(options=options)
    _, summaries = drive_both(options, {}, "phase 11 vmap flagship", card, [], PLANT_COUNTS)
    return summaries


def inkernel_phase(spec, card: str, fp32_instructions_per_s: float) -> tuple:
    """Phase 7: the in-kernel-RNG kernel against its plain version, the
    distribution gate, its times. Returns (worst errors, {S: timing})."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels.philox import seed_words

    name = "inkernel_rng_sample_rollout"
    worst = {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0,
             "fresh_max_err_in_scale_units": 0.0}
    for rollouts in FUSED_CHECK_ROLLOUTS:
        for case, (shift, do_shift) in enumerate(shift_cases(rollouts)):
            inputs = inkernel_inputs(rollouts, shift, do_shift, seed=rollouts + case)
            kernel_out = cr.inkernel_rng_sample_rollout(spec, *inputs)
            torch.cuda.synchronize()
            err = check_inkernel(spec, inputs, kernel_out)
            print(f"phase 7 {name} R={rollouts} S={STEPS} shift={shift} do_shift={do_shift}: non-fresh noise "
                  f"bitwise, fresh draws within {FRESH_TOLERANCE} x scale, violations exact; {json.dumps(err)}")
            for key in worst:
                worst[key] = max(worst[key], err[key])
    # The long horizon, as phase 6 holds kernels 1 and 2 (the ring wraps
    # LONG_CHECK_STEPS / 4 times).
    inputs = inkernel_inputs(LONG_CHECK_ROLLOUTS, 2, True, seed=23, steps=LONG_CHECK_STEPS)
    kernel_out = cr.inkernel_rng_sample_rollout(spec, *inputs)
    torch.cuda.synchronize()
    err = check_inkernel(spec, inputs, kernel_out, drift=True)
    print(f"phase 7 {name} R={LONG_CHECK_ROLLOUTS} S={LONG_CHECK_STEPS}: non-fresh noise bitwise, fresh draws "
          f"within {FRESH_TOLERANCE} x scale; {json.dumps(err)}")
    for key in worst:
        worst[key] = max(worst[key], err[key])

    # The distribution gate: no elite row, so every sampled element is fresh.
    R = SERVING_ROLLOUTS
    init, table, meta, old, keep, words, scale = inkernel_inputs(R, 0, False, seed=21)
    keep = torch.zeros_like(keep)
    noise, _, _ = cr.inkernel_rng_sample_rollout(spec, init, table, meta, old, keep, words, scale)
    again, _, _ = cr.inkernel_rng_sample_rollout(spec, init, table, meta, old, keep, words, scale)
    if not torch.equal(noise, again):
        raise AssertionError("the same seed words gave different noise")
    stats = distribution_gate(noise, scale)
    generator = torch.Generator(device="cuda").manual_seed(22)
    if torch.equal(seed_words(generator), seed_words(generator)):
        raise AssertionError("two updates drew the same seed words")
    print(f"phase 7 distribution gate R={R} S={STEPS}: {noise.shape[0] * (R - 2)} draws per dof within 5 sigma "
          f"(mean, std, skew), same seed -> same noise, successive seed words differ; {json.dumps(stats)}")

    timing = {}
    for S in (STEPS, LONG_STEPS):
        inputs = inkernel_inputs(R, 2, True, seed=9, steps=S)
        for _ in range(3):
            cr.inkernel_rng_sample_rollout(spec, *inputs)
        kernel_ms = time_call(lambda: cr.inkernel_rng_sample_rollout(spec, *inputs), 50 if S == STEPS else 10)
        instructions, bytes_needed = inkernel_work(inputs)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(instructions, bytes_needed, fp32_instructions_per_s)
        timing[S] = {"ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by, "instructions": instructions}
        print(f"{name} at R={R} S={S}: {kernel_ms:.4f} ms/launch; bound {bound_ms * 1e3:.1f} us by {bound_by} "
              f"(operations {ops_ms * 1e3:.1f} us, bytes {bytes_ms * 1e3:.1f} us); "
              f"{bound_ms / kernel_ms * 100:.1f}% of bound; {card}")
        if S == STEPS:
            timing[S]["plain_ms"] = time_call(
                lambda: cr.inkernel_rng_sample_rollout_reference(spec, *inputs), 1)
            print(f"plain version at R={R} S={S}: inkernel_rng_sample_rollout_reference "
                  f"{timing[S]['plain_ms']:.1f} ms")
    return worst, timing


def check_twin_against_unsharded(updates: int = 4) -> dict:
    """``build_flagship(sampler_shards=SHARDS)`` against the unsharded card
    flagship at the serving shape, update by update from the twin's state,
    both fed the same fresh draws: the noise bitwise, the costs and states
    held by ``compare`` (the same kernel on blocks of the same rollouts),
    the controls within 1e-3 (the twin adds its shards' weighted sums in
    shard order, one product adds them all). Returns the worst errors."""
    import numpy as np

    from assistedmanipulation_tpu_torch import interop
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    twin, single = build_flagship(sampler_shards=SHARDS), build_flagship()
    R, S = twin.planner.rollout_count, twin.planner.steps
    rng = np.random.default_rng(1)
    ctx = twin.make_ctx()
    state = twin.init(seed=0)
    worst = {"max_abs_err": 0.0, "optimal_control_max_abs_err": 0.0}
    for k in range(updates):
        fresh = torch.as_tensor((rng.standard_normal((R, S, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)).astype(np.float32))
        arrays = interop.planner_state_to_numpy(state)
        single_state = interop.planner_state_from_numpy(arrays, R)
        time_k = torch.tensor(0.01 * (k + 1), device="cuda")
        state, info = twin.update(state, twin.x0, time_k, ctx, fresh=fresh)
        want, want_info = single.update(single_state, single.x0, time_k, ctx, fresh=fresh)
        def beyond():
            raise AssertionError(f"sharded twin update {k}: costs or states beyond {RTOL} of the unsharded ones")

        err = compare((state.noise, state.costs, info.optimal_rollout_states),
                      (want.noise, want.costs, want_info.optimal_rollout_states), beyond)
        control_err = float((state.optimal_control - want.optimal_control).abs().max())
        if control_err > 1e-3:
            raise AssertionError(f"sharded twin update {k}: optimal control differs by {control_err:.3g}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err["max_abs_err"])
        worst["optimal_control_max_abs_err"] = max(worst["optimal_control_max_abs_err"], control_err)
        print(f"phase 15 twin update {k}: noise bitwise, costs and states by compare {json.dumps(err)}, "
              f"optimal control max abs diff {control_err:.3g} against the unsharded flagship")
    return worst


def sharding_phase(spec, card: str, fp32_instructions_per_s: float, scratch: str) -> dict:
    """Phase 15: rollout sharding (parallel/sharding.py).

    (a) Kernels 1 and 3 against their plain versions on one rollout shard's
    block (R = SERVING_ROLLOUTS / SHARDS) with ``meta[2] = 0`` (a shard
    that does not hold static rollouts 0 and 1, the branch no other phase
    reaches), the first shift case each (the other two on a
    LONG_CHECK_ROLLOUTS block with ``meta[2] = 0``), by ``compare`` and
    ``check_inkernel``;
    kernel 2 on a rank's block of the SCENARIOS x 1 mesh (all 10,000
    rollouts) with its slice of the ensemble (scenarios 2 and 3), by
    ``compare_scenarios``, bitwise to one-scenario launches. Each timed per
    launch at that shape, beside its plain version and its bound.
    (b) ``build_flagship(sampler_shards=SHARDS)``, the single-process twin:
    against the unsharded flagship with the same fresh draws
    (``check_twin_against_unsharded``); captured in lockstep with its eager
    self, bitwise; WARMUP_UPDATES + TIMED_UPDATES eager updates of SHARDS
    kernel-1 launches each (``check_launches``), the outputs checked.
    (c) scripts/torch_multihost_check.py: 2 gloo ranks on this card (built
    kernels reused), the 1-D mesh flagship (kernel 1) and in-kernel-RNG one
    (kernel 3) bitwise equal to the twin over MESH_UPDATES updates, the
    SCENARIOS-scenario flagship on the 2 x 1 mesh (kernel 2) within the
    script's tolerance; each rank one launch per update; the ranks' solves/s
    and the time per collective printed (not targets: two processes share
    one card, gloo stages through the host). The script runs in a
    subprocess started after (a)'s LONG_CHECK_ROLLOUTS checks, while the
    rest of (a) runs here; (a)'s timings wait for it.

    Returns the phase's report: worst errors and times per kernel, the
    twin's cell, the ranks' result."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    def not_first(inputs):
        meta = inputs[2].clone()
        meta[2] = 0
        return (*inputs[:2], meta, *inputs[3:])

    def double(inputs):
        return tuple(x.double() if x.is_floating_point() else x for x in inputs)

    block = SERVING_ROLLOUTS // SHARDS
    report = {"fused_sample_rollout": {"max_abs_err": 0.0}, "inkernel_rng_sample_rollout": {"max_abs_err": 0.0},
              SCENARIO_KEY: {"max_abs_err": 0.0}}

    def check_first_zero(case, rollouts, shift, do_shift):
        inputs = not_first(kernel_inputs(rollouts, shift, do_shift, seed=40 + case))
        kernel_out = cr.fused_sample_rollout(spec, *inputs)
        err = compare(kernel_out, cr.fused_sample_rollout_reference(spec, *inputs),
                      lambda: cr.fused_sample_rollout_reference(spec, *double(inputs)))
        rows = kernel_out[0][:, :, :2]
        if not bool(rows[:, :10].ne(0).all()):  # dofs 10 and 11 have zero variance
            raise AssertionError("first = 0: rollouts 0 and 1 of the block are not sampled")
        report["fused_sample_rollout"]["max_abs_err"] = max(report["fused_sample_rollout"]["max_abs_err"],
                                                            err["max_abs_err"])
        print(f"phase 15 fused_sample_rollout R={rollouts} S={STEPS} first=0 shift={shift} do_shift={do_shift}: "
              f"noise bitwise (rows 0 and 1 sampled), violations exact; {json.dumps(err)}")
        inputs = not_first(inkernel_inputs(rollouts, shift, do_shift, seed=50 + case))
        err = check_inkernel(spec, inputs, cr.inkernel_rng_sample_rollout(spec, *inputs))
        report["inkernel_rng_sample_rollout"]["max_abs_err"] = max(
            report["inkernel_rng_sample_rollout"]["max_abs_err"], err["max_abs_err"])
        print(f"phase 15 inkernel_rng_sample_rollout R={rollouts} S={STEPS} first=0 shift={shift} "
              f"do_shift={do_shift}: non-fresh noise bitwise, fresh draws within {FRESH_TOLERANCE} x scale; "
              f"{json.dumps(err)}")

    # The shard's block where a plain call is cheap enough; the other cases
    # at LONG_CHECK_ROLLOUTS, so every case meets a block without the
    # static rows. Those run first, alone: beside the ranks they contend
    # with them for the card.
    cases = list(enumerate(shift_cases(block)))
    for case, (shift, do_shift) in list(enumerate(SHIFT_CASES))[len(cases):]:
        check_first_zero(case, LONG_CHECK_ROLLOUTS, shift, do_shift)

    # (c), started next: its ranks run while the rest of (a)'s checks do.
    out = f"{scratch}/multihost.json"
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_multihost_check.py")
    command = [sys.executable, script, "--device", "cuda", "--updates",
               str(MESH_UPDATES), "--scenarios", str(SCENARIOS), "--cases", "fused,inkernel,scenario",
               "--timeout", "300", "--out", out]
    t0 = time.perf_counter()
    ranks_proc = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  start_new_session=True)
    try:
        for case, (shift, do_shift) in cases:
            check_first_zero(case, block, shift, do_shift)
        init, tables, controls = rollout_kernel_inputs(SERVING_ROLLOUTS, STEPS, seed=60, scenarios=SCENARIOS)
        inputs = (init, tables[SCENARIOS // 2:].contiguous(), controls)  # the second scenario rank's slice
        kernel_out = cr.rollout(spec, *inputs)
        err = compare_scenarios(kernel_out, cr.rollout_reference(spec, *inputs),
                                lambda: cr.rollout_reference(spec, *double(inputs)))
        check_scenarios_bitwise(spec, inputs, kernel_out[0])
        report[SCENARIO_KEY]["max_abs_err"] = err["max_abs_err"]
        print(f"phase 15 rollout R={SERVING_ROLLOUTS} S={STEPS} on a rank's slice (scenarios "
              f"{SCENARIOS // 2}-{SCENARIOS - 1}): violations exact, bitwise equal to one-scenario launches; "
              f"{json.dumps(err)}")
    except BaseException:  # stop the subprocesses before the error leaves
        stop(ranks_proc)
        raise

    # (c)'s result: its ranks are done before anything is timed here.
    try:
        ranks_output, _ = ranks_proc.communicate(timeout=400)
    finally:
        stop(ranks_proc)
    if ranks_proc.returncode != 0:
        raise AssertionError(f"torch_multihost_check failed ({ranks_proc.returncode}):\n{ranks_output[-4000:]}")
    ranks = json.loads(open(out).read())
    ranks["wall_s"] = time.perf_counter() - t0
    ranks["overlapped_with"] = "phase 15 (a): kernels 1-3 and their plain versions (float64 reruns) on the card"
    print(f"phase 15 two gloo ranks on one card (run while the checks above ran): {json.dumps(ranks)}; {card}")
    report["ranks"] = ranks

    # Per-launch times at the shard's shapes, beside the plain versions.
    fused = not_first(kernel_inputs(block, 2, True, seed=70))
    inkernel = not_first(inkernel_inputs(block, 2, True, seed=71))
    C = SCENARIOS // 2
    launches = {
        "fused_sample_rollout": (lambda: cr.fused_sample_rollout(spec, *fused),
                                 lambda: cr.fused_sample_rollout_reference(spec, *fused),
                                 block * STEPS * cr.STEP_FP32_INSTRUCTIONS, fused_bytes(block, STEPS), block),
        "inkernel_rng_sample_rollout": (lambda: cr.inkernel_rng_sample_rollout(spec, *inkernel),
                                        lambda: cr.inkernel_rng_sample_rollout_reference(spec, *inkernel),
                                        *inkernel_work(inkernel), block),
        SCENARIO_KEY: (lambda: cr.rollout(spec, *inputs), lambda: cr.rollout_reference(spec, *inputs),
                       rollout_instructions(SERVING_ROLLOUTS, STEPS, C), rollout_bytes(SERVING_ROLLOUTS, STEPS, C),
                       SERVING_ROLLOUTS),
    }
    for name, (kernel, plain, instructions, bytes_needed, R) in launches.items():
        for _ in range(3):
            kernel()
        ms = time_call(kernel, 50)
        report[name].update({"ms": ms, "plain_ms": time_call(plain, 1), **report_bound(
            f"phase 15 {name} (shard)", R, STEPS, ms, instructions, bytes_needed, fp32_instructions_per_s, card)})

    # (b) The single-process twin.
    report["twin_against_unsharded"] = check_twin_against_unsharded()
    check_captured_against_eager({"sampler_shards": SHARDS}, f"phase 15 twin ({SHARDS} shards) captured")
    launches, report["sharded-flagship-2x5k"] = drive_flagship(
        build_flagship(sampler_shards=SHARDS), {"fused_sample_rollout": SHARDS},
        f"phase 15 twin ({SHARDS} shards) eager", card, ["fused_sample_rollout"], per_step=SHARDS,
    )
    report["twin_launches"] = launches
    return report


def probe_phase(card: str, kernel_work: dict) -> dict:
    """Phase 10: the FP32 chain kernel against its plain version, then
    ``fp32_chain.probe`` (SASS loop counts, the measured FMA and add peaks,
    ``kernel_work``'s kernels against them; ``kernel_work`` maps a rollout
    kernel to (instructions, ms) of one serving launch). Returns the chain
    kernel's entry for the kernels line."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout, fp32_chain

    n = fp32_chain.default_elements()
    g = torch.Generator(device="cuda").manual_seed(12)
    worst = fp32_chain.check_chain(1.0 + 0.001 * torch.rand(n, generator=g, device="cuda"))
    print(f"phase 12 fp32_chain N={n} K={fp32_chain.CHECK_ITERATIONS}: add leg bitwise, FMA leg within "
          f"{fp32_chain.FMA_RTOL} relative of its plain version (max abs err {worst:.3g})")

    ones = torch.ones(n, device="cuda")
    cuda_rollout.reset_launch_counts()
    report = fp32_chain.probe(ones, PROBE_ITERATIONS, PROBE_REPS, PROBE_BLOCKS, kernel_work)
    launches = check_launches({"fp32_chain": 2 * len(fp32_chain.CHOICES) * 2 * (1 + PROBE_BLOCKS * PROBE_REPS)})
    print(f"phase 12 FP32 issue peak: FMA {report['peak_fma_per_s'] / 1e12:.3f} T/s, add "
          f"{report['peak_add_per_s'] / 1e12:.3f} T/s (nominal {report['nominal_per_s'] / 1e12:.2f} T/s); "
          f"{json.dumps(report)}; {card}")
    a, k = 16, PROBE_ITERATIONS
    instructions = n * k * a * fp32_chain.UNROLL
    plain_ms = time_call(lambda: fp32_chain.chain_reference(ones, k, a, True), 1)
    bound_ms, bound_by, _, _ = bound(instructions, 8 * n, report["nominal_per_s"])
    return {
        "launches": launches["fp32_chain"],
        "max_abs_err": worst,
        "ms": report["ms_per_launch_k_4k"]["fma"][str(a)][0],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launch_shape": {"elements": n, "iterations": k, "accumulators": a, "unroll": fp32_chain.UNROLL, "fma": True},
        "peak_fma_per_s": report["peak_fma_per_s"],
        "peak_add_per_s": report["peak_add_per_s"],
        "nominal_per_s": report["nominal_per_s"],
        "launches_per_solve": 0,
    }


def circle_episode(device, seconds: float, dtype=torch.float32, assisted: bool = True, collect_logs: bool = False,
                   capture=None):
    """The circle experiment as the JAX package's scripts/experiments.py
    builds it (the reference's defaults; unassisted = the controller on,
    no forecast reaching it), on ``device``."""
    import dataclasses

    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation
    from assistedmanipulation_tpu_torch.sim import actor, episode, trajectories

    configuration = actor.Configuration().mppi
    if dtype == torch.float64:
        configuration = dataclasses.replace(configuration, dtype="float64")
    return episode.Episode(
        configuration, AssistedManipulation(), trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
        episode.EpisodeConfiguration(duration=seconds, assisted=assisted), dtype=dtype,
        collect_logs=collect_logs, device=device, capture=capture,
    )


def tree_bitwise(got, want, label: str) -> None:
    """Every tensor of the (nested) tuples ``got`` and ``want`` equal to the
    last bit, every other leaf equal."""
    if isinstance(got, tuple):
        names = getattr(got, "_fields", range(len(got)))
        for name, g, w in zip(names, got, want):
            tree_bitwise(g, w, f"{label}.{name}")
    elif isinstance(got, torch.Tensor):
        g, w = got.cpu(), want.cpu()
        if g.dtype in (torch.float32, torch.float64):
            kind = torch.int32 if g.dtype == torch.float32 else torch.int64
            g, w = g.view(kind), w.view(kind)
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: the captured value differs from the eager one")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


def csv_rows(path: str):
    import numpy as np

    with open(path) as handle:
        handle.readline()
        rows = [[float(v) for v in line.split(",")] for line in handle.read().splitlines() if line]
    return np.array(rows) if rows else np.zeros((0, 0))


def check_tree(folder: str, ticks: int, updates: int, label: str, host_engine: bool = False) -> dict:
    """The harness's CSV tree: one row per tick in dynamics/ and pid/force/,
    one per update in mppi/ (costs, weights, optimal cost, update) and
    objective/ (per tick under the host engine), every value finite.
    Returns the metrics of sim/episode.episode_metrics read from it."""
    import os

    import numpy as np

    per_tick = [os.path.join("dynamics", name) for name in sorted(os.listdir(os.path.join(folder, "dynamics")))]
    per_tick += [os.path.join("pid", "force", name) for name in sorted(os.listdir(os.path.join(folder, "pid", "force")))]
    per_update = [os.path.join("mppi", name) for name in ("costs.csv", "weights.csv", "optimal_cost.csv",
                                                          "update.csv")]
    (per_tick if host_engine else per_update).append(os.path.join("objective", "costs.csv"))
    for rel, rows in [(rel, ticks) for rel in per_tick] + [(rel, updates) for rel in per_update]:
        data = csv_rows(os.path.join(folder, rel))
        if data.shape[0] != rows or not np.isfinite(data).all():
            raise AssertionError(f"{label}: {rel} has {data.shape[0]} rows (want {rows}) or a non-finite value")
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if name.endswith(".csv") and not np.isfinite(csv_rows(os.path.join(dirpath, name))).all():
                raise AssertionError(f"{label}: {name} holds a non-finite value")
    force = csv_rows(os.path.join(folder, "pid", "force", "control.csv"))[:, 1:]
    position = csv_rows(os.path.join(folder, "dynamics", "end_effector_position.csv"))[:, 1:]
    reference = csv_rows(os.path.join(folder, "pid", "force", "reference.csv"))[:, 1:]
    magnitude = np.linalg.norm(force, axis=-1)
    return {
        "mean_force": float(magnitude.mean()),
        "max_force": float(magnitude.max()),
        "rmse": float(np.sqrt(np.mean(np.sum((position - reference) ** 2, axis=-1)))),
        "final_energy": float(csv_rows(os.path.join(folder, "dynamics", "tank_energy.csv"))[-1, 1]),
    }


def stop(process) -> None:
    """Kill a subprocess this script started (in a session of its own) and
    its children, if it still runs."""
    if process.poll() is None:
        os.killpg(process.pid, signal.SIGKILL)
        process.wait()


def start_cli(out: str, seconds: float, config: str, test: str = "circle") -> tuple:
    """``python -m assistedmanipulation_tpu_torch.harness`` started in a
    subprocess from this checkout; ``finish_cli`` waits for it."""
    root = os.path.dirname(os.path.abspath(__file__))
    process = subprocess.Popen(
        [sys.executable, "-m", "assistedmanipulation_tpu_torch.harness", "--test", test, "--out", out,
         "--duration", str(seconds), "--config", config],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
    )
    return process, out, test, time.perf_counter()


def finish_cli(started: tuple) -> tuple:
    """(run folder, the episode's wall seconds as it prints them, or None
    under the host engine, subprocess wall seconds) of ``start_cli``'s
    run."""
    process, out, test, t0 = started
    try:
        output, _ = process.communicate(timeout=900)
    finally:
        stop(process)
    wall = time.perf_counter() - t0
    if process.returncode != 0:
        raise AssertionError(f"harness {test} failed ({process.returncode}):\n{output[-6000:]}")
    (folder,) = [entry.path for entry in os.scandir(out) if entry.is_dir()]
    match = re.search(r"episode: \d+ ticks in ([0-9.]+)s", output)
    return folder, (float(match.group(1)) if match else None), wall


def card_check_cpu_runs(noise) -> dict:
    """Phase 13's CPU runs of the card-against-CPU check, in a child
    process while the card runs: the circle episode under ``noise`` at
    float64 and at float32, eager. Returns {dtype name: (EE trace,
    controls, wall s)}."""
    torch.set_num_threads(2)
    out = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        run = circle_episode("cpu", CARD_CPU_SECONDS, dtype).run(
            seed=0, noise_override=torch.tensor(noise, dtype=dtype))
        out[str(dtype)] = (run.ee_position, run.control, time.perf_counter() - t0)
    return out


def experiment_phase(card: str, scratch: str, pool) -> dict:
    """Phase 13: the simulated experiment (the JAX package's sim/episode.py
    and harness on the card, no kernel: the plant planner's vmap path).
    Its runs write under ``scratch``; ``summary["cli"]["folder"]`` is the
    CLI run's CSV tree. The CPU runs of the card-against-CPU check run in
    ``pool``'s child process."""
    import os

    import numpy as np

    from assistedmanipulation_tpu_torch.harness.runner import TestSuite
    from assistedmanipulation_tpu_torch.models import lagrangian
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.sim import actor, episode

    summary = {"card": card}
    t_phase = time.perf_counter()

    # 1. Card (float32, captured) against the CPU (float64, eager), the
    # same injected noise. The EE trace is held to CARD_CPU_TOLERANCE m
    # throughout; the controls to CARD_CPU_TOLERANCE x max(|u|, 1) up to
    # the update where float32 itself leaves float64 by more (the CPU's own
    # float32 run shows where: a barrier's saturation count or the softmax
    # of 3e11-sized composed costs flips under float32 rounding, and the
    # published sequence jumps); from there to within CARD_F32_FACTOR x the
    # CPU float32 run's own largest control deviation.
    steps = actor.Configuration().mppi.step_count
    noise = np.random.default_rng(21).standard_normal((5, 50, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
    cpu_runs = pool.submit(card_check_cpu_runs, noise)
    card_episode = circle_episode("cuda", CARD_CPU_SECONDS)
    t0 = time.perf_counter()
    card_out = card_episode.run(seed=0, noise_override=torch.tensor(noise, dtype=torch.float32))
    torch.cuda.synchronize()
    card_wall = time.perf_counter() - t0

    # 2. Captured against eager on the card, bitwise, from the same key
    # (while the CPU runs of 1 finish).
    eager = circle_episode("cuda", CAPTURE_CHECK_SECONDS, collect_logs=True, capture=False)
    captured = circle_episode("cuda", CAPTURE_CHECK_SECONDS, collect_logs=True)
    t0 = time.perf_counter()
    want = eager.run(seed=1)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    got = captured.run(seed=1)
    tree_bitwise(got, want, "phase 13 episode")
    tree_bitwise(captured.final_carry, eager.final_carry, "phase 13 final carry")
    periods = eager.ticks / eager.countdown_max
    summary["eager_ms_per_period"] = eager_wall * 1e3 / periods
    print(f"phase 13 captured episode: {captured.ticks} ticks (the first period eager, 1 replay, 5 eager ticks) "
          f"bitwise equal to the eager one, every output, log and the final carry; eager "
          f"{summary['eager_ms_per_period']:.1f} ms per period; {card}")

    cpu = cpu_runs.result()
    cpu_ee, cpu_control, cpu_wall = cpu[str(torch.float64)]

    def deviation(ee_position, control):
        ee = (ee_position.double().cpu() - cpu_ee).abs().amax(dim=-1)
        u = ((control.double().cpu() - cpu_control).abs() / cpu_control.abs().clamp(min=1.0)).amax(dim=-1)
        return ee, u

    ee, u = deviation(card_out.ee_position, card_out.control)
    ee32, u32 = deviation(*cpu[str(torch.float32)][:2])
    period = card_episode.countdown_max
    # The update (a period's first tick) at which the CPU's float32 controls
    # first leave float64 by more than the tolerance.
    apart = torch.nonzero(u32 > CARD_CPU_TOLERANCE).flatten().tolist()
    split = apart[0] // period * period if apart else len(u32)
    early, late = float(u[:split].max()) if split else 0.0, float(u[split:].max()) if split < len(u) else 0.0
    late_bound = CARD_F32_FACTOR * float(u32.max())
    summary["card_vs_cpu"] = {
        "ticks": card_episode.ticks, "ee_max_abs_err_m": float(ee.max()), "control_max_rel_err": float(u.max()),
        "control_max_rel_err_before_split": early, "split_tick": split, "control_max_rel_err_after_split": late,
        "cpu_float32_ee_max_abs_err_m": float(ee32.max()), "cpu_float32_control_max_rel_err": float(u32.max()),
        "card_wall_s": card_wall, "cpu_float64_eager_wall_s": cpu_wall,
    }
    print(f"phase 13 card against CPU: circle episode {card_episode.ticks} ticks at the reference widths, injected "
          f"noise, card float32 captured vs CPU float64 eager: EE trace within {float(ee.max()):.3e} m (tolerance "
          f"{CARD_CPU_TOLERANCE}); controls within {early:.3e} x max(|u|, 1) before tick {split} (tolerance "
          f"{CARD_CPU_TOLERANCE}) and {late:.3e} from it (tolerance {CARD_F32_FACTOR} x the CPU float32 run's own "
          f"{float(u32.max()):.3e}; its EE trace within {float(ee32.max()):.3e} m); {card}")
    if not (float(ee.max()) <= CARD_CPU_TOLERANCE and early <= CARD_CPU_TOLERANCE and late <= max(
            late_bound, CARD_CPU_TOLERANCE)):
        raise AssertionError("phase 13: the card's episode differs from the CPU's")

    # 4. (before 3: the CLI's figures are printed beside its metrics)
    # Assistance: assisted and unassisted, 15 s captured, seed 0.
    runs = {}
    for name, assisted in (("assisted", True), ("unassisted", False)):
        run_episode = circle_episode("cuda", EXPERIMENT_SECONDS, assisted=assisted)
        t0 = time.perf_counter()
        outputs = run_episode.run(seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (run_episode, episode.episode_metrics(outputs), wall)
    assisted_episode, assisted_metrics, assisted_wall = runs["assisted"]
    unassisted_metrics = runs["unassisted"][1]
    ratio = assisted_metrics["mean_force"] / unassisted_metrics["mean_force"]
    replay_ms = time_call(assisted_episode.graph.replay, 10)
    profile = profile_steps(lambda k: assisted_episode.graph.replay(), 1, [], "phase 13 one captured period", card)
    summary["assistance"] = {"assisted": assisted_metrics, "unassisted": unassisted_metrics, "ratio": ratio,
                             "assisted_wall_s": assisted_wall, "unassisted_wall_s": runs["unassisted"][2]}
    summary["period"] = {"replay_ms": replay_ms, **profile}
    print(f"phase 13 assistance, circle seed 0, {EXPERIMENT_SECONDS} s captured: assisted mean force "
          f"{assisted_metrics['mean_force']:.3f} N (EXPERIMENTS.md kalman_1 {EXPERIMENTS_CIRCLE['kalman_1_mean_force']} "
          f"N; RMSE {assisted_metrics['rmse']:.4f} m, EXPERIMENTS.md {EXPERIMENTS_CIRCLE['kalman_1_rmse']} m), "
          f"unassisted {unassisted_metrics['mean_force']:.3f} N (EXPERIMENTS.md "
          f"{EXPERIMENTS_CIRCLE['unassisted_mean_force']} N), ratio {ratio:.3f} (gate < {ASSISTANCE_GATE}); "
          f"assisted wall {assisted_wall:.2f} s; one period replayed in {replay_ms:.2f} ms, "
          f"{profile['device_ops_per_update']:.0f} device operations; {card}")
    if not ratio < ASSISTANCE_GATE:
        raise AssertionError("phase 13: the assisted force is not below the gate's share of the unassisted")
    del runs, assisted_episode

    # 3. The CLI (the reference experiment) and the lagrangian case, each in
    # a subprocess on the card while 5 runs here.
    cli = start_cli(os.path.join(scratch, "cli"), CLI_SECONDS, '{"engine": "episode"}')
    lagrangian_cli = start_cli(os.path.join(scratch, "lagrangian"), LAGRANGIAN_SECONDS, '{"engine": "episode"}',
                               "lagrangian")
    try:
        # 5. The host engine, paced.
        out = os.path.join(scratch, "host")
        os.makedirs(out)
        t0 = time.perf_counter()
        if not TestSuite.run("circle", out, {"realtime": True}, HOST_ENGINE_SECONDS, device="cuda"):
            raise AssertionError("phase 13: the host engine's circle run failed")
        host_wall = time.perf_counter() - t0
        (folder,) = [entry.path for entry in os.scandir(out)]
        with open(os.path.join(folder, "pacing.json")) as handle:
            pacing = json.load(handle)
        check_tree(folder, pacing["ticks"], -(-pacing["ticks"] // 10), "phase 13 host", host_engine=True)
        summary["host_engine"] = {"pacing": pacing, "wall_s": host_wall, "overlapped_with": BESIDE_CLI}
        print(f"phase 13 host engine, {HOST_ENGINE_SECONDS} s paced at 200 Hz: overrun rate "
              f"{pacing['overrun_rate']} ({pacing['overruns']}/{pacing['ticks']}), real-time factor "
              f"{pacing['realtime_factor']} (overlapped with {BESIDE_CLI}); {card}")

        # The actor's update eager and captured, and the Lagrangian backend's
        # plant quantities at batch 1 (the lagrangian case's plant step).
        actor_ms = {}
        for mode, capture in (("eager", False), ("captured", True)):
            a = actor.Actor(actor.Configuration(), 0.005, device="cuda", capture=capture)
            wrench = torch.tensor([20.0, -5.0, 0.0, 0.0, 0.0, 0.0], device="cuda")
            ticks_ms = []
            for i in range(30):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.add_end_effector_wrench(wrench, i * 0.005)
                a.act(i * 0.005)
                torch.cuda.synchronize()
                ticks_ms.append((time.perf_counter() - t0) * 1e3)
            # Ticks 10 and 20 update (tick 0 builds and, captured, captures).
            actor_ms[mode] = {"update_tick_ms": statistics.mean(ticks_ms[k] for k in (10, 20)),
                              "plain_tick_ms": statistics.median(ticks_ms[k] for k in range(1, 30) if k % 10)}
        model = frankaridgeback_model()
        g = torch.Generator(device="cuda").manual_seed(2)
        q, v = torch.rand((2, 12), generator=g, device="cuda") - 0.5

        def lagrangian_call():
            return lagrangian.mass_matrix(model, q), lagrangian.nonlinear_effects(model, q, v, (0.0, 0.0, 9.81))

        lagrangian_call()
        eager_call_ms = time_call(lagrangian_call, 5)
        captured_call_ms = time_graph(lagrangian_call, 20)
        summary["actor"] = {**actor_ms, "overlapped_with": BESIDE_CLI}
        summary["lagrangian_call_ms"] = {"eager": eager_call_ms, "captured": captured_call_ms,
                                         "overlapped_with": BESIDE_CLI}
        print(f"phase 13 actor (host engine): per update tick eager {actor_ms['eager']['update_tick_ms']:.1f} ms, "
              f"captured update {actor_ms['captured']['update_tick_ms']:.1f} ms; plain tick "
              f"{actor_ms['eager']['plain_tick_ms']:.1f} / {actor_ms['captured']['plain_tick_ms']:.1f} ms. Lagrangian "
              f"mass_matrix + nonlinear_effects at batch 1: {eager_call_ms:.2f} ms eager, {captured_call_ms:.3f} ms "
              f"captured (overlapped with {BESIDE_CLI}); {card}")
    except BaseException:  # stop the subprocesses before the error leaves
        for started in (cli, lagrangian_cli):
            stop(started[0])
        raise

    # 3's subprocesses, their trees.
    folder, episode_wall, process_wall = finish_cli(cli)
    ticks = int(round(CLI_SECONDS / 0.005))
    metrics = check_tree(folder, ticks, ticks // 10, "phase 13 CLI")
    summary["cli"] = {"seconds": CLI_SECONDS, "episode_wall_s": episode_wall, "process_wall_s": process_wall,
                      "realtime_factor": CLI_SECONDS / episode_wall, "metrics": metrics, "folder": folder,
                      "overlapped_with": BESIDE_HOST}
    print(f"phase 13 CLI: python -m assistedmanipulation_tpu_torch.harness --test circle --config "
          f"'{{\"engine\": \"episode\"}}': {ticks} ticks, {ticks // 10} updates, the CSV tree complete and "
          f"finite; episode {episode_wall:.2f} s (real-time factor {CLI_SECONDS / episode_wall:.3f}), process "
          f"{process_wall:.1f} s, beside the lagrangian case and the host engine; "
          f"{profile['device_ops_per_update']:.0f} device operations per period (profiler over one replay); "
          f"metrics of this {CLI_SECONDS} s run {json.dumps(metrics)} (EXPERIMENTS.md circle / kalman_1 over 15 "
          f"s: {EXPERIMENTS_CIRCLE['kalman_1_mean_force']} N, {EXPERIMENTS_CIRCLE['kalman_1_rmse']} m); {card}")
    folder, episode_wall, _ = finish_cli(lagrangian_cli)
    ticks = int(round(LAGRANGIAN_SECONDS / 0.005))
    check_tree(folder, ticks, ticks // 10, "phase 13 lagrangian")
    summary["lagrangian_episode"] = {"seconds": LAGRANGIAN_SECONDS, "episode_wall_s": episode_wall,
                                     "overlapped_with": BESIDE_HOST}
    print(f"phase 13 lagrangian case, episode engine, {LAGRANGIAN_SECONDS} s: the CSV tree complete and finite, "
          f"episode {episode_wall:.2f} s; {card}")
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


def record_replays() -> dict:
    """The reference-pipeline replayer's recordings of phase 14's replays,
    on the CPU in float64 (scripts/torch_parity_replay.py). It runs in a
    child process while phase 13 runs: the recordings depend on no planner
    and take the most host time of phase 14."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    import scripts.torch_parity_replay as replay

    return {"point mass": replay.record_point_mass(*POINT_REPLAY), "franka": replay.record_franka(*FRANKA_REPLAY)}


def csv_tree_bytes(folder: str) -> dict:
    """{relative path: bytes} of every CSV under ``folder`` but
    mppi/update.csv (host-measured update durations)."""
    import os

    out = {}
    for dirpath, _, files in os.walk(folder):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), folder)
            if name.endswith(".csv") and rel != os.path.join("mppi", "update.csv"):
                with open(os.path.join(dirpath, name), "rb") as handle:
                    out[rel] = handle.read()
    return out


def tooling_phase(card: str, scratch: str, cli_folder: str, recordings) -> dict:
    """Phase 14: the experiment's tooling on the card (no kernel: the host
    engine and the replays run the plant planner's vmap path).
    ``recordings`` is the future of ``record_replays``."""
    import math
    import os

    from assistedmanipulation_tpu_torch import analysis, config as cfg
    from assistedmanipulation_tpu_torch.harness import cases
    from assistedmanipulation_tpu_torch.harness.runner import TestSuite

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scripts.torch_parity_replay as replay

    summary = {"card": card}
    t_phase = time.perf_counter()

    # (a) Resume: an uninterrupted host-engine run; a run stepped past its
    # first snapshot, flushed and not closed, a CSV planted after the
    # snapshot; then the resume. The trees byte-equal but mppi/update.csv.
    t0 = time.perf_counter()
    patch = {"duration": RESUME_SECONDS, "engine": "host", "checkpoint_interval": RESUME_INTERVAL}
    out = os.path.join(scratch, "resume_full")
    os.makedirs(out)
    if not TestSuite.run("circle", out, patch, device="cuda"):
        raise AssertionError("phase 14: the uninterrupted circle run failed")
    (full,) = [entry.path for entry in os.scandir(out)]
    folder = os.path.join(scratch, "resume_run")
    os.makedirs(folder)
    interrupted = cases.CircleTest(folder, patch=patch, device="cuda")
    with open(os.path.join(folder, "configuration.json"), "w") as handle:
        json.dump(cfg.to_json(interrupted.configuration), handle, indent=2)
    snapshot_tick = int(round(RESUME_INTERVAL / interrupted.configuration.time_step))
    for _ in range(snapshot_tick):
        interrupted.step()
    interrupted.write_checkpoint(snapshot_tick)
    for _ in range(RESUME_LOST_TICKS):
        interrupted.step()
    interrupted.flush_loggers()
    planted = os.path.join(folder, "mppi", "planted_after_the_snapshot.csv")
    with open(planted, "w") as handle:
        handle.write("time\n0.1\n")
    del interrupted
    if not TestSuite.resume(folder, device="cuda"):
        raise AssertionError("phase 14: the resumed circle run failed")
    got, want = csv_tree_bytes(folder), csv_tree_bytes(full)
    if os.path.exists(planted):
        raise AssertionError("phase 14: the CSV planted after the snapshot survived the resume")
    if sorted(got) != sorted(want):
        raise AssertionError(f"phase 14: the resumed tree's files differ: {sorted(set(got) ^ set(want))}")
    differ = [rel for rel in want if got[rel] != want[rel]]
    if differ:
        raise AssertionError(f"phase 14: the resumed tree differs from the uninterrupted one in {differ}")
    summary["resume"] = {"seconds": RESUME_SECONDS, "files": len(want), "bytes": sum(map(len, want.values())),
                         "snapshot_tick": snapshot_tick, "wall_s": time.perf_counter() - t0}
    print(f"phase 14 resume: circle, host engine, {RESUME_SECONDS} s on the card (the update captured), stopped "
          f"{RESUME_LOST_TICKS} ticks past the snapshot at tick {snapshot_tick} and resumed: {len(want)} CSVs "
          f"byte-equal to the uninterrupted run's (mppi/update.csv aside), the CSV planted after the snapshot "
          f"deleted; {summary['resume']['wall_s']:.1f} s; {card}")

    # (b) The sweep: reach over two cost scales.
    t0 = time.perf_counter()
    out = os.path.join(scratch, "sweep")
    os.makedirs(out)
    sweep = {"test": "reach", "duration": SWEEP_SECONDS,
             "parameters": [{"pointer": "/actor/mppi/cost_scale", "values": list(SWEEP_VALUES)}]}
    if not TestSuite.run("parameter_sweep", out, sweep, device="cuda"):
        raise AssertionError("phase 14: the sweep failed")
    (sweep_folder,) = [entry.path for entry in os.scandir(out)]
    with open(os.path.join(sweep_folder, "sweep.csv")) as handle:
        rows = [line.split(",") for line in handle.read().splitlines()[1:] if line]
    if len(rows) != len(SWEEP_VALUES) or any(row[-2] != "1" for row in rows):
        raise AssertionError(f"phase 14: sweep.csv has rows {rows}")
    summary["sweep"] = {"rows": len(rows), "wall_s": time.perf_counter() - t0,
                        "combination_wall_s": [float(row[-1]) for row in rows]}
    print(f"phase 14 sweep: reach x /actor/mppi/cost_scale in {list(SWEEP_VALUES)}, {SWEEP_SECONDS} s each on the "
          f"card: sweep.csv {len(rows)} rows, both passed; {summary['sweep']['wall_s']:.1f} s; {card}")

    # (c) The analysis of (a)'s tree and of phase 13's CLI tree.
    singles = {label: analysis.analyse_single(tree, plot=False) for label, tree in
               (("resume", full), ("phase 13 CLI", cli_folder))}
    rows = analysis.analyse_multiple([full, cli_folder], plot=False)
    for row in list(singles.values()) + rows:
        bad = {key: value for key, value in row.items()
               if key != "folder" and not (value is not None and math.isfinite(value))}
        if bad:
            raise AssertionError(f"phase 14: analysis of {row['folder']} has non-finite metrics {bad}")
    summary["analysis"] = {label: {k: v for k, v in row.items() if k != "folder"} for label, row in singles.items()}
    for label, row in singles.items():
        print(f"phase 14 analysis of the {label} tree: mean force {row['mean_user_force_N']:.4f} N, RMSE "
              f"{row['tracking_rmse_m']:.5f} m, mean update {row['mean_solve_duration_s'] * 1e3:.2f} ms, final tank "
              f"energy {row['final_tank_energy']:.4f}; analyse_multiple over both: every metric finite")

    # (d) The replays: the planner on the card against the replayer's
    # recording, beside the same planner on the CPU.
    recorded = recordings.result()
    summary["replays"] = {}
    for plant, fn in (("point mass", replay.run), ("franka", replay.run_franka)):
        updates, rollouts = POINT_REPLAY if plant == "point mass" else FRANKA_REPLAY
        for dtype, (bound_all, bound_first) in REPLAY_BOUNDS[plant].items():
            result = {where: fn(updates, rollouts, dtype, place, recorded[plant])
                      for where, place in (("card", "cuda"), ("cpu", "cpu"))}
            card_series = result["card"]["per_update_max_error"]
            summary["replays"][f"{plant} {dtype}"] = {where: r["per_update_max_error"] for where, r in result.items()}
            print(f"phase 14 replay {plant} {dtype}, {updates} updates x {rollouts} rollouts: card "
                  f"{json.dumps(card_series)}; CPU {json.dumps(result['cpu']['per_update_max_error'])}; bound "
                  f"{bound_all} (first update {bound_first}); {card}")
            if plant == "franka" and not (result["card"]["nan_poisoned_rollouts"] > 0
                                          and result["card"]["saturated_rollouts"] > 0):
                raise AssertionError("phase 14: the Franka replay saw no poisoned or no saturated rollout")
            if not (max(card_series) < bound_all and card_series[0] < bound_first):
                raise AssertionError(f"phase 14: the {plant} replay at {dtype} on the card is out of its bound")
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


def experiment_scripts_phase(spec, card: str, fp32_instructions_per_s: float) -> dict:
    """Phase 16: the experiment-level scripts on the card, cut. (a) The
    matrix (scripts/torch_experiments.py): MATRIX_CELLS through
    ``run_cell``, each metric finite; the average, LOCF and order-2 Kalman
    episodes captured, bitwise their eager selves. (b) The realtime check
    (scripts/torch_realtime_check.py): the first REALTIME_LOCKSTEP captured
    updates bitwise the eager ones, then REALTIME_UPDATES updates timed
    against the 50 ms slot (not gated), and the device operations of one
    replay of the update graph and of the advance graph. (c) The scenario
    study (scripts/torch_scenario_value.py): one episode per count of
    STUDY_SCENARIOS, C kernel-2 launches per update counted, the metrics
    finite; kernel 2 at the study's shape against its plain version and
    timed. Returns the phase's report."""
    import math
    import os

    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scripts.torch_experiments as ex
    import scripts.torch_realtime_check as rt
    import scripts.torch_scenario_value as sv

    summary = {"card": card}
    t_phase = time.perf_counter()

    def finite(metrics: dict, label: str) -> None:
        bad = [key for key, value in metrics.items() if not math.isfinite(value)]
        if bad:
            raise AssertionError(f"{label}: {bad} not finite: {json.dumps(metrics)}")

    # (a) The matrix, cut, and the captured episode of each new strategy.
    summary["matrix"] = {}
    for trajectory, strategy in MATRIX_CELLS:
        metrics = ex.run_cell(trajectory, strategy, MATRIX_SECONDS, 0)
        finite(metrics, f"phase 16 matrix {trajectory}/{strategy}")
        summary["matrix"][f"{trajectory}/{strategy}"] = metrics
        print(f"phase 16 matrix cell {trajectory}/{strategy}, {MATRIX_SECONDS} s, seed 0, captured: mean force "
              f"{metrics['mean_force']:.3f} N, RMSE {metrics['rmse']:.4f} m, wall {metrics['wall_s']} s; {card}")
    for strategy in CAPTURE_CHECK_STRATEGIES:
        eager = ex.make_episode("circle", strategy, CAPTURE_CHECK_SECONDS, capture=False, collect_logs=True)
        captured = ex.make_episode("circle", strategy, CAPTURE_CHECK_SECONDS, collect_logs=True)
        want, got = eager.run(seed=1), captured.run(seed=1)
        tree_bitwise(got, want, f"phase 16 {strategy} episode")
        tree_bitwise(captured.final_carry, eager.final_carry, f"phase 16 {strategy} final carry")
        # The circle's matrix cell of this strategy: the captured run's metrics.
        metrics = ex.episode_metrics(got[0])
        finite(metrics, f"phase 16 matrix circle/{strategy}")
        summary["matrix"][f"circle/{strategy}"] = metrics
        print(f"phase 16 captured {strategy} episode: {captured.ticks} ticks (the first period eager, 1 replay, "
              f"5 eager ticks) bitwise equal to the eager one, every output, log and the final carry; its matrix "
              f"cell circle/{strategy}: mean force {metrics['mean_force']:.3f} N, RMSE {metrics['rmse']:.4f} m; "
              f"{card}")

    # (b) The realtime check: lockstep, then the timed run.
    loop = rt.RealtimeLoop()
    rate = loop.configuration.controller_rate

    def eager_period(state, i):
        t = loop.time(i)
        planner_state = loop.controller_update(state.planner_state, state.x, state.strategy_state, t)
        x, strategy_state, pid_state = loop.advance(state.x, planner_state, state.strategy_state, state.pid_state, t)
        return rt.LoopState(x, planner_state, strategy_state, pid_state, t)

    eager_states = [eager_period(loop.init(0), 0)]
    for i in range(1, REALTIME_LOCKSTEP + 1):
        eager_states.append(eager_period(eager_states[-1], i))
    captured = rt.CapturedLoop(loop, eager_period(loop.init(0), 0))
    for i in range(1, REALTIME_LOCKSTEP + 1):
        captured.update(i * rate)
        tree_bitwise(captured.state().planner_state, eager_states[i].planner_state,
                     f"phase 16 realtime update {i}")
        captured.advance()
        tree_bitwise(captured.state(), eager_states[i], f"phase 16 realtime period {i}")
    del captured
    print(f"phase 16 realtime loop: captured updates 1-{REALTIME_LOCKSTEP} and their periods bitwise equal to the "
          f"eager ones (planner state, plant, forecast and PID states); {card}")
    result = rt.run(loop, REALTIME_UPDATES)
    report = rt.report(loop, result, REALTIME_UPDATES * rate, ex.device_identity("cuda"))
    if report["updates"] != REALTIME_UPDATES - 1 or not report["final_state_finite"]:
        raise AssertionError(f"phase 16 realtime: {report['updates']} steady updates, final state finite "
                             f"{report['final_state_finite']}")
    graph = result["captured"]
    split = {name: profile_steps(lambda k, g=g: g.replay(), 1, [], f"phase 16 realtime {name} graph", card)
             for name, g in (("update", graph.update_graph), ("advance", graph.advance_graph))}
    report.pop("misses")
    summary["realtime"] = {**report, "capture_s": result["capture_s"], "graphs": split}
    print(f"phase 16 realtime check, {REALTIME_UPDATES} updates at the reference widths ({loop.planner.rollout_count} "
          f"rollouts x {loop.planner.steps} steps), captured: p50 {report['p50_ms']} ms, p99 {report['p99_ms']} ms, "
          f"max {report['max_ms']} ms, first (eager) {report['first_update_ms']} ms, {report['deadline_misses']} "
          f"misses of the 50 ms slot in {report['updates']}, ok {report['ok']} (not gated: the slot is known to be "
          f"unmet, ROADMAP queue 1); device operations per replay: update "
          f"{split['update']['device_ops_per_update']:.0f} ({split['update']['device_ms_per_update']:.2f} ms), "
          f"advance {split['advance']['device_ops_per_update']:.0f} "
          f"({split['advance']['device_ms_per_update']:.2f} ms); {card}")

    # (c) The scenario study, cut: C kernel-2 launches per update.
    summary["study"] = {}
    periods = int(round(STUDY_SECONDS / rate))
    for count in STUDY_SCENARIOS:
        loop = sv.ScenarioLoop(count, STUDY_SIGMA)
        cuda_rollout.reset_launch_counts()
        t0 = time.perf_counter()
        run = sv.episode(loop, 0, periods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches({"rollout": count * periods})
        update_graph = run.pop("captured").update_graph
        if update_graph.launches != {"rollout": count}:
            raise AssertionError(f"phase 16 study C={count}: the update graph holds kernel nodes "
                                 f"{update_graph.launches}")
        if not run.pop("final_state_finite"):
            raise AssertionError(f"phase 16 study C={count}: the final state is not finite")
        finite(run, f"phase 16 study C={count}")
        # One replay under the profiler: C instances of kernel 2 in it.
        profile = profile_steps(lambda k: update_graph.replay(), 1, ["rollout x1"],
                                f"phase 16 study C={count} update graph", card, per_step=count)
        summary["study"][f"C={count}"] = {**run, "wall_s": wall, "launches": launches["rollout"],
                                          "update_graph": profile}
        print(f"phase 16 scenario study, sigma {STUDY_SIGMA} N, C = {count}, seed 0, {STUDY_SECONDS} s captured: "
              f"mean force {run['mean_force']} N, RMSE {run['rmse']} m, {launches['rollout']} kernel-2 launches in "
              f"{periods} updates ({count} per update, {count} kernel-2 instances in one profiled replay of the "
              f"update graph, {profile['device_ops_per_update']:.0f} device operations, "
              f"{profile['device_ms_per_update']:.2f} ms), wall {wall:.2f} s; {card}")

    # Kernel 2 at the study's shape: C tables in one launch held to the
    # plain version and bitwise to C one-scenario launches (the launches
    # the study makes), each timed beside its plain version and bound.
    R, S = STUDY_ROLLOUTS, STUDY_STEPS
    inputs = rollout_kernel_inputs(R, S, seed=R, scenarios=SCENARIOS)
    kernel_out = cuda_rollout.rollout(spec, *inputs)
    torch.cuda.synchronize()
    plain_out, plain_ms = timed_call(lambda: cuda_rollout.rollout_reference(spec, *inputs))
    exact = tuple(x.double() if x.is_floating_point() else x for x in inputs)
    err = compare_scenarios(kernel_out, plain_out, lambda: cuda_rollout.rollout_reference(spec, *exact))
    check_scenarios_bitwise(spec, inputs, kernel_out[0])
    init, tables, controls = inputs
    single = (init, tables[0].contiguous(), controls)
    timing = {}
    for C, args in ((1, single), (SCENARIOS, inputs)):
        for _ in range(3):
            cuda_rollout.rollout(spec, *args)
        ms = time_call(lambda: cuda_rollout.rollout(spec, *args), 50)
        # The plain version at C tables: its checked call above.
        plain = plain_ms if C == SCENARIOS else timed_call(lambda: cuda_rollout.rollout_reference(spec, *args))[1]
        timing[C] = {"ms": ms, "plain_ms": plain, **report_bound(
            f"phase 16 rollout x{C} (scenario study)", R, S, ms, rollout_instructions(R, S, C),
            rollout_bytes(R, S, C), fp32_instructions_per_s, card)}
    summary["kernel2"] = {"max_abs_err": err["max_abs_err"], "compare": err, "timing": timing,
                          "launches": summary["study"][f"C={SCENARIOS}"]["launches"]}
    print(f"phase 16 rollout R={R} S={S} scenarios={SCENARIOS} (one block of 64 threads, 52 live): violations exact, "
          f"costs bitwise equal to {SCENARIOS} one-scenario launches; {json.dumps(err)}; one scenario "
          f"{timing[1]['ms']:.4f} ms per launch (plain {timing[1]['plain_ms']:.1f}), {SCENARIOS} in one launch "
          f"{timing[SCENARIOS]['ms']:.4f} ms; {card}")
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


def script_ports_phase(spec, card: str, fp32_instructions_per_s: float) -> dict:
    """Phase 17: the ports of the last four JAX scripts on the card, cut.
    (a) The pose-dither sweep (no kernel): the POSE_ROWS rows for
    PORTS_SECONDS, seed 0, each metric finite, the friction-eps row's EE
    trace not the default's (the override reached the captured plant).
    (b) The force-offset sweep (no kernel): the controller-off circle with
    the model's friction scaled by 1 and 0.5 and with the (500, 10)
    differential gains, each metric finite, the scaled run's EE trace not
    the unscaled one's. (c) The rectangle twin (float64, no kernel):
    TWIN_SECONDS assisted, seed 0, on the card against the CPU, the same
    host draws, EE traces within TWIN_TOLERANCE m. (d) The scaling bench's
    overhead mode on kernel 1: the serving shape over SCALING_SHARDS shards
    of the twin captured, in this process, exactly n kernel-1 launches per
    update counted over SCALING_UPDATES timed updates, solves/s, and kernel 1's
    time per launch at a shard's block beside its bound. (e) The pose
    diagnosis's draws gate (scripts/torch_pose_diagnosis.py): the planner's
    per-update draws on the card, a reseeded graph replay bitwise the eager
    draws, distinct seed words, successive updates uncorrelated within 5
    sigma. Returns the phase's report."""
    import math
    import os

    from assistedmanipulation_tpu_torch.kernels import cuda_rollout
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scripts.torch_force_offset_sweep as fo
    import scripts.torch_pose_diagnosis as diagnosis
    import scripts.torch_pose_dither_sweep as pd
    import scripts.torch_rectangle_twin as twin
    import scripts.torch_scaling_bench as sb

    summary = {"card": card}
    t_phase = time.perf_counter()

    def finite(metrics: dict, label: str) -> None:
        bad = [key for key, value in metrics.items() if not math.isfinite(value)]
        if bad:
            raise AssertionError(f"{label}: {bad} not finite: {json.dumps(metrics)}")

    # (a) The pose rows.
    t0 = time.perf_counter()
    rows, traces = dict(pd.sweeps("all")), {}
    summary["pose"] = {}
    for name in POSE_ROWS:
        metrics, outputs = pd.run_cell(rows[name], PORTS_SECONDS, 0)
        finite(metrics, f"phase 17 pose row {name}")
        summary["pose"][name] = metrics
        traces[name] = outputs.ee_position
    if torch.equal(traces["eps_0.0001"], traces["default"]):
        raise AssertionError("phase 17: the friction-eps row's EE trace is the default's: the override did not "
                             "reach the plant")
    summary["pose"]["wall_s"] = time.perf_counter() - t0
    print(f"phase 17 pose-dither rows {list(POSE_ROWS)}, {PORTS_SECONDS} s, seed 0, captured: "
          f"{json.dumps({name: summary['pose'][name] for name in POSE_ROWS})}; the eps row's EE trace differs from "
          f"the default's; wall {summary['pose']['wall_s']:.1f} s; {card}")

    # (b) The force-offset runs, controller off.
    t0 = time.perf_counter()
    summary["force_offset"], traces = {}, {}
    for label, options in (("friction x1", {"model": fo.scaled_friction_model(1.0)}),
                           ("friction x0.5", {"model": fo.scaled_friction_model(0.5)}),
                           ("gains 500/10", {"robot_configuration": fo.gains_configuration(500.0, 10.0)})):
        metrics, outputs = fo.run("circle", PORTS_SECONDS, **options)
        finite(metrics, f"phase 17 force offset {label}")
        summary["force_offset"][label] = metrics
        traces[label] = outputs.ee_position
    for label in ("friction x0.5", "gains 500/10"):
        if torch.equal(traces[label], traces["friction x1"]):
            raise AssertionError(f"phase 17: the {label} run's EE trace is the unscaled one's")
    summary["force_offset"]["wall_s"] = time.perf_counter() - t0
    print(f"phase 17 force offset, circle, controller off, {PORTS_SECONDS} s: "
          f"{json.dumps(summary['force_offset'])}; the scaled runs' EE traces differ from the unscaled one's; {card}")

    # (c) The twin on the card against the CPU.
    t0 = time.perf_counter()
    on_card = twin.run_episode(0, TWIN_SECONDS, True, device="cuda", trace=True)
    on_cpu = twin.run_episode(0, TWIN_SECONDS, True, device="cpu", trace=True)
    distance = float(abs(on_card["ee"] - on_cpu["ee"]).max())
    summary["twin"] = {"seconds": TWIN_SECONDS, "ee_max_abs_err_m": distance,
                       "mean_force": {"cuda": on_card["mean_force"], "cpu": on_cpu["mean_force"]},
                       "card_wall_s": on_card["wall_s"], "cpu_wall_s": on_cpu["wall_s"],
                       "wall_s": time.perf_counter() - t0}
    print(f"phase 17 rectangle twin, assisted, {TWIN_SECONDS} s, seed 0, float64: card against CPU EE traces "
          f"within {distance:.3e} m (tolerance {TWIN_TOLERANCE}), mean force {on_card['mean_force']:.6f} / "
          f"{on_cpu['mean_force']:.6f} N; wall {on_card['wall_s']} s on the card; {card}")
    if not distance <= TWIN_TOLERANCE:
        raise AssertionError("phase 17: the twin on the card leaves the CPU's")

    # (d) The scaling bench's overhead mode: kernel 1 n times per update.
    summary["scaling"] = {}
    device = torch.device("cuda")
    for n in SCALING_SHARDS:
        flagship = build_flagship(SERVING_ROLLOUTS - 2, STEPS, sampler_shards=n, capture=True)
        rate, per_update = sb.timed_rate(flagship, SCALING_UPDATES, device)
        launches = cuda_rollout.LAUNCHES["fused_sample_rollout"]
        if per_update != n:
            raise AssertionError(f"phase 17 scaling: {per_update} kernel-1 launches per update over {n} shards")
        R = SERVING_ROLLOUTS // n
        inputs = kernel_inputs(R, 2, True, seed=70 + n)
        for _ in range(3):
            cuda_rollout.fused_sample_rollout(spec, *inputs)
        ms = time_call(lambda: cuda_rollout.fused_sample_rollout(spec, *inputs), 50)
        summary["scaling"][n] = {"solves_per_s": rate, "launches": launches, "launches_per_update": per_update,
                                 "block_rollouts": R, "ms": ms, **report_bound(
                                     f"phase 17 fused_sample_rollout ({n} shards' block)", R, STEPS, ms,
                                     R * STEPS * cuda_rollout.STEP_FP32_INSTRUCTIONS, fused_bytes(R, STEPS),
                                     fp32_instructions_per_s, card)}
    base = summary["scaling"][SCALING_SHARDS[0]]["solves_per_s"]
    for entry in summary["scaling"].values():
        entry["sharding_efficiency_same_work"] = entry["solves_per_s"] / base
    for n, entry in summary["scaling"].items():
        print(f"phase 17 scaling overhead, {SERVING_ROLLOUTS} x {STEPS} over {n} shards of the twin, captured: "
              f"{entry['solves_per_s']:.2f} solves/s (efficiency {entry['sharding_efficiency_same_work']:.3f}), "
              f"{entry['launches_per_update']:g} kernel-1 launches per update, {entry['ms']:.4f} ms per launch at "
              f"R = {entry['block_rollouts']}; {card}")

    # (e) The draws gate of the pose diagnosis.
    draws = diagnosis.draws_part(device, DRAWS_UPDATES)
    if not draws["ok"]:
        raise AssertionError(f"phase 17: the planner's draws fail the gate: {json.dumps(draws)}")
    summary["draws"] = draws
    summary["phase_s"] = time.perf_counter() - t_phase
    return summary


def full_covariance(seed: int = FULL_COVARIANCE_SEED):
    """A positive semi-definite 12 x 12 covariance with correlations: the
    default per-dof deviations around a random correlation matrix (the
    gripper rows zero, as their default variances)."""
    import numpy as np

    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr

    A = np.random.default_rng(seed).normal(size=(12, 12))
    C = A @ A.T
    d = np.sqrt(np.diag(C))
    s = np.sqrt(fr.DEFAULT_COVARIANCE)
    return s[:, None] * (C / d[:, None] / d[None, :]) * s[None, :]


def covariance_gate(draws, covariance) -> float:
    """Each element of the sample covariance of ``draws`` ((S, 12, R): S x R
    samples) within 5 sigma of ``covariance`` (Var(x_i x_j) = C_ii C_jj +
    C_ij^2 for a zero-mean Gaussian). Returns the largest deviation in
    sigmas over the elements with a variance."""
    x = draws.permute(0, 2, 1).reshape(-1, draws.shape[1]).double()
    n = x.shape[0]
    sample = (x.T @ x / n).cpu()
    C = torch.as_tensor(covariance, dtype=torch.float64)
    sigma = torch.sqrt((torch.outer(torch.diag(C), torch.diag(C)) + C * C) / n)
    excess = (sample - C).abs() - 5 * sigma
    if bool((excess > 1e-9).any()):
        raise AssertionError(f"sample covariance of {n} draws beyond 5 sigma: {float(excess.max()):.3g}")
    held = sigma > 0
    return float(((sample - C).abs()[held] / sigma[held]).max())


class DeviceOperations:
    """Counts the ATen operations that run on the card while it is entered
    (views excepted): the device operations of a plain PyTorch path, without
    a profiler's trace of each."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outs = out if isinstance(out, (tuple, list)) else (out,)
                if not func.is_view and any(isinstance(t, torch.Tensor) and t.is_cuda for t in outs):
                    counter.count += 1
                return out

        self.count = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def surface_phase(spec, card: str) -> dict:
    """Phase 18: the last parts of the JAX package's public surface the
    port took on, at the serving width (9,998 + 2 rollouts x 50 steps).

    (a) Full covariance (``full_covariance``) on the two-pass path (the
    plant planner with ``make_cuda_rollout_fn``: kernel 2): the sampler's
    fresh draws on the card within 5 sigma of the covariance, and within
    CORRELATE_TOLERANCE of the CPU's mapping of the same standard normals
    (``ops.gaussian.correlate``); one update launches kernel 2 once, its
    noise bitwise the assembly of those draws, and its costs and rollout-0
    states held through ``compare`` to the CPU planner's fed the same draws
    (float64 for the outliers). The diagonal flagship (kernel 1): one update
    from planted costs, its noise bitwise the select chain over the
    standard normals times the per-dof deviations. (b) The threshold select
    (``elite_select="threshold"``) from planted ties and NaNs: the keep mask
    bitwise the lexsort's, each ``_sample_meta`` timed. (c) The lanes
    backend (``build_flagship(backend="lanes")``, plain PyTorch on the
    card): one update's device operations counted, one timed, no kernel
    launched; its costs and states held through ``compare`` against kernel 2
    on the same controls. (d) ``make_lane_filter_rollout`` on the card
    against kernel 2 at R = 1 (``make_cuda_filter_rollout_fn``) on the
    lanes flagship's published sequence, both timed. Returns the report."""
    import dataclasses

    import numpy as np

    from assistedmanipulation_tpu_torch import mppi
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.kernels import lane_rollout
    from assistedmanipulation_tpu_torch.kernels.philox import seed_bits, shard_seed, split_key
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        AssistedManipulation,
        Configuration as ObjectiveConfiguration,
    )
    from assistedmanipulation_tpu_torch.ops import constant, gaussian
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, default_mppi_configuration

    report = {}
    R = SERVING_ROLLOUTS
    shape = (STEPS, 12, R)
    time_k = torch.tensor(0.01, device="cuda")

    # (a) The full covariance on the two-pass path.
    covariance = full_covariance()
    configuration = dataclasses.replace(default_mppi_configuration(R - 2, STEPS), covariance=covariance)

    def full_planner(device, dtype="float32"):
        return mppi.Planner(
            dataclasses.replace(configuration, dtype=dtype), fr.make_plant(AssistedManipulation()), device=device,
            rollout_fn=cr.make_cuda_rollout_fn(frankaridgeback_model(), ObjectiveConfiguration(),
                                               fr.Configuration(), STEPS, 0.01, device=device),
        )

    card_planner = full_planner("cuda")
    flagship = build_flagship()  # its x0 and ctx
    x0, ctx = flagship.x0, flagship.make_ctx()
    state = card_planner.init(seed=11)
    seed = split_key(state.rng)[1]
    factor = constant(card_planner.sampler._factor, x0)
    if tuple(factor.shape) != (12, 12):
        raise AssertionError(f"the full-covariance sampler holds a {tuple(factor.shape)} factor")

    def seeded():
        return torch.Generator(device="cuda").manual_seed(seed_bits(shard_seed(seed, 0)))

    fresh = gaussian.sample_noise(seeded(), factor, shape, dim=1)  # what the sampler draws
    sigmas = covariance_gate(fresh, covariance)
    z = torch.randn(shape, generator=seeded(), device="cuda", dtype=torch.float32)
    on_cpu = gaussian.correlate(z.cpu(), torch.as_tensor(card_planner.sampler._factor, dtype=torch.float32), dim=1)
    correlate_err = float((fresh.cpu() - on_cpu).abs().max()) / float(np.sqrt(np.max(np.diag(covariance))))
    if correlate_err > CORRELATE_TOLERANCE:
        raise AssertionError(f"full covariance: the card's draws differ from the CPU's mapping of the same "
                             f"normals by {correlate_err:.3g} x the largest deviation")
    cr.reset_launch_counts()
    new_state, info = card_planner.update(state, x0, time_k, ctx)
    torch.cuda.synchronize()
    launches = check_launches({"rollout": 1})
    optimal_shifted, shift_by, do_shift, _, keep = card_planner._sample_meta(state, time_k)
    meta = torch.stack([shift_by.to(torch.int32), do_shift.to(torch.int32), torch.ones((), dtype=torch.int32,
                                                                                        device="cuda")])
    assembled = cr.assemble_noise(state.optimal_control, meta, state.noise, fresh, keep)
    if not torch.equal(assembled, new_state.noise):
        raise AssertionError("full covariance: the update's noise is not the assembly of the sampler's draws")

    def cpu_update(dtype):
        planner = full_planner("cpu", dtype)
        cast = getattr(torch, dtype)
        cpu_state = mppi.PlannerState(*(t.cpu().to(cast) if t.is_floating_point() else t.cpu() for t in state))
        out, out_info = planner.update(cpu_state, x0.cpu().to(cast), time_k.cpu().to(cast), _ctx_on(ctx, "cpu", cast),
                                       fresh=cr.noise_to_logical(fresh.cpu().to(cast)))
        return out.noise, out.costs, out_info.optimal_rollout_states

    card_out = (new_state.noise.cpu(), new_state.costs.cpu(), info.optimal_rollout_states.cpu())
    err = compare(card_out, cpu_update("float32"), lambda: cpu_update("float64"))
    report["full_covariance"] = {
        "draws": int(np.prod(shape)) // 12, "largest_sigmas": sigmas, "correlate_err_in_deviations": correlate_err,
        "launches_per_update": launches["rollout"], "against_cpu": err,
    }
    print(f"phase 18 full covariance: {int(np.prod(shape)) // 12} draws per dof within 5 sigma of the "
          f"covariance (largest {sigmas:.2f} sigma); the card's mapping of the normals within "
          f"{correlate_err:.3g} x the largest deviation of the CPU's; one update: kernel launches "
          f"{json.dumps(launches)}, noise bitwise the assembly of the draws, costs and states against the CPU "
          f"planner on the same draws {json.dumps(err)}")

    # The diagonal flagship: its draws are the normals times the deviations.
    planted = planted_costs(R)
    diag_state = flagship.init(seed=12)._replace(costs=planted)
    seed = split_key(diag_state.rng)[1]
    cr.reset_launch_counts()
    diag_new, _ = flagship.update(diag_state, x0, time_k, ctx)
    check_launches({"fused_sample_rollout": 1})
    scale = torch.as_tensor(np.sqrt(fr.DEFAULT_COVARIANCE), dtype=torch.float32, device="cuda")
    normals = torch.randn(shape, generator=seeded(), device="cuda", dtype=torch.float32)
    _, shift_by, do_shift, _, keep = flagship.planner._sample_meta(diag_state, time_k)
    meta = torch.stack([shift_by.to(torch.int32), do_shift.to(torch.int32), torch.ones((), dtype=torch.int32,
                                                                                        device="cuda")])
    want = cr.assemble_noise(diag_state.optimal_control, meta, diag_state.noise, normals * scale[None, :, None], keep)
    if not torch.equal(want, diag_new.noise):
        raise AssertionError("the diagonal flagship's noise is not the select chain over normals x deviations")
    print("phase 18 diagonal flagship: one kernel-1 launch, the noise bitwise the select chain over the standard "
          "normals times the per-dof deviations")

    # (b) The threshold select against the lexsort, at 10,000 rollouts.
    planners = {select: build_flagship(elite_select=select).planner for select in mppi.ELITE_SELECTS}
    masks, select_ms = {}, {}
    for select, planner in planners.items():
        for _ in range(3):
            masks[select] = planner._sample_meta(diag_state, time_k)[4]
        select_ms[select] = statistics.median(
            timed_call(lambda: planner._sample_meta(diag_state, time_k))[1] for _ in range(SELECT_TIMINGS))
    if not torch.equal(masks["threshold"], masks["lexsort"]):
        raise AssertionError("the threshold keep mask differs from the lexsort's")
    kept = int(masks["threshold"].sum())
    report["threshold"] = {"kept": kept, "sample_meta_ms": select_ms, "timings": SELECT_TIMINGS}
    print(f"phase 18 threshold select at R={R}: keep mask bitwise the lexsort's ({kept} kept, planted V and (V, S) "
          f"ties, NaNs); _sample_meta median over {SELECT_TIMINGS} (CUDA events): lexsort "
          f"{select_ms['lexsort']:.4f} ms, threshold {select_ms['threshold']:.4f} ms; {card}")

    # (c) The lanes backend at the serving width.
    lanes = build_flagship(backend="lanes")
    state = lanes.init(seed=13)
    cr.reset_launch_counts()
    with DeviceOperations() as operations:
        lanes.update(state, x0, time_k, ctx)
        torch.cuda.synchronize()
    (new_state, info), lanes_ms = timed_call(lambda: lanes.update(state, x0, time_k, ctx))
    check_launches({})
    optimal_shifted = lanes.planner._sample_meta(state, time_k)[0]
    controls = new_state.noise + optimal_shifted[:, :, None]
    inputs = (cr.initial_state(x0), cr.step_table(ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0, time_k, ctx),
              controls)
    kernel_costs, kernel_states = cr.rollout(spec, *inputs)
    err = compare((None, kernel_costs, kernel_states), (None, new_state.costs, info.optimal_rollout_states[:, :24]),
                  lambda: (None, *cr.rollout_reference(spec, *(x.double() for x in inputs))))
    report["lanes"] = {"update_ms": lanes_ms, "device_operations": operations.count, "kernel2_against_lanes": err}
    print(f"phase 18 lanes flagship R={R} S={STEPS}: one update {lanes_ms:.1f} ms (CUDA events), "
          f"{operations.count} device operations (ATen calls on the card, views excepted), no kernel launched; "
          f"kernel 2 on its controls against its costs and states {json.dumps(err)}; {card}")

    # (d) The lanes re-rollout against kernel 2 at R = 1.
    args = (frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), STEPS, 0.01)
    optimal = new_state.optimal_control
    (lane_cost, lane_states), lane_ms = timed_call(
        lambda: lane_rollout.make_lane_filter_rollout(*args)(optimal, x0, time_k, ctx))
    kernel_fn = cr.make_cuda_filter_rollout_fn(*args)
    kernel_fn(optimal, x0, time_k, ctx)
    (k_cost, k_states), k_ms = timed_call(lambda: kernel_fn(optimal, x0, time_k, ctx))  # the call, tables included
    def lane_filter_float64():
        cost, states = lane_rollout.make_lane_filter_rollout(*args)(
            optimal.double(), x0.double(), time_k.double(), _ctx_on(ctx, "cuda", torch.float64))
        return None, cost[None], states

    err = compare((None, k_cost[None], k_states), (None, lane_cost[None], lane_states), lane_filter_float64)
    report["lane_filter_rollout"] = {"ms": lane_ms, "kernel2_r1_call_ms": k_ms, "against_kernel2": err}
    print(f"phase 18 make_lane_filter_rollout on the card: {lane_ms:.1f} ms, make_cuda_filter_rollout_fn's call "
          f"(kernel 2 at R = 1 and its tables) {k_ms:.4f} ms; "
          f"kernel 2 against it {json.dumps(err)}; {card}")
    return report


def _ctx_on(ctx, device, dtype):
    """``ctx`` with its tensors on ``device`` in ``dtype``."""
    return ctx._replace(wrench_horizon=ctx.wrench_horizon.to(device=device, dtype=dtype),
                        start_time=ctx.start_time.to(device=device, dtype=dtype))


def planted_costs(R: int):
    """(R, 2) float32 costs on the card with ties at every level: V in {0,
    1, 2}, S from 5 values, a few NaNs in each channel."""
    import numpy as np

    rng = np.random.default_rng(14)
    costs = np.stack([rng.integers(0, 3, R).astype(np.float32),
                      rng.choice(np.float32([1.0, 2.5, 2.5, 4.0, 7.0]), R)], axis=1)
    costs[rng.choice(R, R // 50, replace=False), 0] = np.nan
    costs[rng.choice(R, R // 50, replace=False), 1] = np.nan
    return torch.as_tensor(costs, device="cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one", file=sys.stderr)
        return 2
    from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout, fp32_chain
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
        Configuration as ObjectiveConfiguration,
    )
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    start = time.perf_counter()
    phase_seconds, last_mark = {}, [start]

    def mark(phase: int) -> None:
        now = time.perf_counter()
        phase_seconds[str(phase)] = round(now - last_mark[0], 1)
        last_mark[0] = now
        print(f"phase {phase} done, {now - start:.1f} s since the start", flush=True)

    # --- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    seconds = build.build()
    ptxas = {name: ptxas_summary(build.ptxas_report(name)) for name in KERNELS}
    for C, key in ((1, "rollout"), (SCENARIOS, SCENARIO_KEY)):  # kernel 2 per instantiation
        ptxas[key] = ptxas_summary(build.ptxas_report("rollout"), f"pair_rollout_kernelILi{C}E")
    # The QP kernel's float instantiation with the narrow maps: the filter's.
    ptxas["admm_qp"] = ptxas_summary(build.ptxas_report("admm_qp"), "admm_qp_kernelIfLi12E")
    print(f"phase 1 build: {json.dumps(seconds)} nvcc seconds, wall {time.perf_counter() - t0:.1f} s")
    for name, summary in ptxas.items():
        print(f"ptxas {name}: {json.dumps(summary)}")
    for name in ("fused_sample_rollout", "inkernel_rng_sample_rollout"):
        print(f"ptxas report of {name}:\n" + build.ptxas_report(name).strip())
    for name, (export, limit) in cuda_rollout.SHARED_MEMORY_LIMITS.items():
        exported = cuda_rollout.exported_limit(build.load(name), name)
        if exported != limit:
            raise AssertionError(f"{name}: {export}() is {exported}, the wrapper's constant {limit}")
        print(f"{name}: {export}() = {exported}, as the wrapper expects")
    card = nvidia_smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    fp32_instructions_per_s = fp32_chain.nominal_rate()
    print(f"{props.name}: {props.multi_processor_count} SMs x 128 lanes x max SM clock = "
          f"{fp32_instructions_per_s / 1e12:.2f} T FP32 instructions/s (nominal)")

    mark(1)
    # --- phase 2: kernels against their plain versions ----------------------
    spec = cuda_rollout.RolloutSpec(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01
    )
    worst = {name: {"max_abs_err": 0.0, "smooth_max_rel_err": 0.0, "states_max_rel_err": 0.0}
             for name in ("fused_sample_rollout", "rollout", SCENARIO_KEY)}
    def record(name, err):
        for key in worst[name]:
            worst[name][key] = max(worst[name][key], err[key])

    def double(inputs):
        return tuple(x.double() if x.is_floating_point() else x for x in inputs)

    # The plain versions' times at the serving shape are their checked calls
    # at R = 10,000 x 50 (the first shift case for the fused kernel).
    plain_ms = {}
    for rollouts in FUSED_CHECK_ROLLOUTS:
        for case, (shift, do_shift) in enumerate(shift_cases(rollouts)):
            inputs = kernel_inputs(rollouts, shift, do_shift, seed=rollouts + case)
            kernel_out = cuda_rollout.fused_sample_rollout(spec, *inputs)
            torch.cuda.synchronize()
            plain_out, ms = timed_call(lambda: cuda_rollout.fused_sample_rollout_reference(spec, *inputs))
            if rollouts == SERVING_ROLLOUTS and case == 0:
                plain_ms["fused_sample_rollout"] = ms
            err = compare(kernel_out, plain_out,
                          lambda: cuda_rollout.fused_sample_rollout_reference(spec, *double(inputs)))
            print(f"phase 2 fused_sample_rollout R={rollouts} S={STEPS} shift={shift} do_shift={do_shift}: "
                  f"noise bitwise, violations exact; {json.dumps(err)}")
            record("fused_sample_rollout", err)
    for rollouts in ROLLOUT_CHECK_ROLLOUTS:
        inputs = rollout_kernel_inputs(rollouts, STEPS, seed=rollouts + 5)
        kernel_out = cuda_rollout.rollout(spec, *inputs)
        torch.cuda.synchronize()
        plain_out, plain_ms["rollout", rollouts] = timed_call(lambda: cuda_rollout.rollout_reference(spec, *inputs))
        err = compare((None, *kernel_out), (None, *plain_out),
                      lambda: (None, *cuda_rollout.rollout_reference(spec, *double(inputs))))
        if rollouts % 32:
            check_partial_pair_bitwise(spec, inputs, kernel_out)
        print(f"phase 2 rollout R={rollouts} S={STEPS}: violations exact"
              f"{'' if rollouts % 32 == 0 else ', bitwise a full last pair'}; {json.dumps(err)}")
        record("rollout", err)
    # Kernel 2 at C scenarios in one launch: each scenario held to the plain
    # version, and bitwise to a one-scenario launch on its table.
    for rollouts in ROLLOUT_CHECK_ROLLOUTS:
        inputs = rollout_kernel_inputs(rollouts, STEPS, seed=rollouts + 6, scenarios=SCENARIOS)
        kernel_out = cuda_rollout.rollout(spec, *inputs)
        torch.cuda.synchronize()
        plain_out, plain_ms[SCENARIO_KEY, rollouts] = timed_call(
            lambda: cuda_rollout.rollout_reference(spec, *inputs))
        err = compare_scenarios(kernel_out, plain_out, lambda: cuda_rollout.rollout_reference(spec, *double(inputs)))
        check_scenarios_bitwise(spec, inputs, kernel_out[0])
        if rollouts % 32:
            check_partial_pair_bitwise(spec, inputs, kernel_out)
        print(f"phase 2 rollout R={rollouts} S={STEPS} scenarios={SCENARIOS}: violations exact, costs bitwise "
              f"equal to {SCENARIOS} one-scenario launches; {json.dumps(err)}")
        record(SCENARIO_KEY, err)

    # Kernel and plain times at the serving shape, and at the long horizon;
    # kernel 2 at one scenario, and at C in one launch beside C launches.
    R = SERVING_ROLLOUTS
    timing = {}
    fused_inputs = {S: kernel_inputs(R, 2, True, seed=7, steps=S) for S in (STEPS, LONG_STEPS)}
    for S, inputs in fused_inputs.items():
        for _ in range(3):
            cuda_rollout.fused_sample_rollout(spec, *inputs)
        kernel_ms = time_call(lambda: cuda_rollout.fused_sample_rollout(spec, *inputs), 50 if S == STEPS else 10)
        timing["fused_sample_rollout", S] = {"ms": kernel_ms, **report_bound(
            "fused_sample_rollout", R, S, kernel_ms, R * S * cuda_rollout.STEP_FP32_INSTRUCTIONS,
            fused_bytes(R, S), fp32_instructions_per_s, card)}
    timing["fused_sample_rollout", STEPS]["plain_ms"] = plain_ms["fused_sample_rollout"]
    del fused_inputs
    for S in (STEPS, LONG_STEPS):
        for C, key in ((1, "rollout"), (SCENARIOS, SCENARIO_KEY)):
            inputs = rollout_kernel_inputs(R, S, seed=8, scenarios=C)
            for _ in range(3):
                cuda_rollout.rollout(spec, *inputs)
            repeats = 50 if S == STEPS else 10
            kernel_ms = time_call(lambda: cuda_rollout.rollout(spec, *inputs), repeats)
            timing[key, S] = {"ms": kernel_ms, **report_bound(
                f"rollout x{C}", R, S, kernel_ms, rollout_instructions(R, S, C), rollout_bytes(R, S, C),
                fp32_instructions_per_s, card)}
            if C > 1:
                init, tables, controls = inputs
                singles = [(init, table.contiguous(), controls) for table in tables]
                timing[key, S]["one_scenario_launches_ms"] = time_call(
                    lambda: [cuda_rollout.rollout(spec, *single) for single in singles], repeats)
                print(f"rollout at R={R} S={S}: {C} scenarios in one launch {kernel_ms:.4f} ms, in {C} launches "
                      f"{timing[key, S]['one_scenario_launches_ms']:.4f} ms; {card}")
            if S == STEPS:
                timing[key, S]["plain_ms"] = plain_ms[key, R]
            del inputs
    print(f"plain versions at R={R} S={STEPS}: fused_sample_rollout_reference "
          f"{timing['fused_sample_rollout', STEPS]['plain_ms']:.1f} ms, rollout_reference "
          f"{timing['rollout', STEPS]['plain_ms']:.1f} ms, at {SCENARIOS} scenarios "
          f"{timing[SCENARIO_KEY, STEPS]['plain_ms']:.1f} ms")

    mark(2)
    # --- phase 3: the main path -------------------------------------------
    # First on a small input, update by update against the same planner on
    # the CPU (plain rollout), both fed the same state and fresh draws.
    check_planner_against_cpu()
    cells = {}
    main_launches, cells["flagship-10k-50"] = drive_both(
        {}, {"fused_sample_rollout": 1}, "phase 3 flagship", card, ["fused_sample_rollout"]
    )

    mark(3)
    # --- phase 4: the scenario path -----------------------------------------
    check_planner_against_cpu(scenarios=SCENARIOS)
    scenario_launches, cells[f"scenario-10k-50x{SCENARIOS}"] = drive_both(
        {"scenarios": SCENARIOS}, {"rollout": 1},
        f"phase 4 scenario flagship ({SCENARIOS} scenarios, one launch per update)", card, [SCENARIO_KEY],
    )
    # The single-forecast two-pass path: one one-scenario launch per update.
    single_launches, _ = drive_flagship(
        build_flagship(fused_assembly=False), {"rollout": 1},
        "phase 4 two-pass flagship (1 scenario)", card, ["rollout x1"],
    )

    mark(4)
    # --- phase 5: the Kalman-driven serving loop ----------------------------
    cells["serving tick"] = kalman_serving_loop(build_flagship(scenarios=SCENARIOS), card)

    mark(5)
    # --- phase 6: the long horizon ----------------------------------------
    inputs = rollout_kernel_inputs(LONG_CHECK_ROLLOUTS, LONG_CHECK_STEPS, seed=11)
    kernel_out = cuda_rollout.rollout(spec, *inputs)
    plain_out = cuda_rollout.rollout_reference(spec, *inputs)
    torch.cuda.synchronize()
    err = compare((None, *kernel_out), (None, *plain_out),
                  lambda: (None, *cuda_rollout.rollout_reference(spec, *double(inputs))), drift=True)
    print(f"phase 6 rollout R={LONG_CHECK_ROLLOUTS} S={LONG_CHECK_STEPS}: {json.dumps(err)}")
    record("rollout", err)
    inputs = kernel_inputs(LONG_CHECK_ROLLOUTS, 2, True, seed=12, steps=LONG_CHECK_STEPS)
    kernel_out = cuda_rollout.fused_sample_rollout(spec, *inputs)
    plain_out = cuda_rollout.fused_sample_rollout_reference(spec, *inputs)
    torch.cuda.synchronize()
    err = compare(kernel_out, plain_out, lambda: cuda_rollout.fused_sample_rollout_reference(spec, *double(inputs)),
                  drift=True)
    print(f"phase 6 fused_sample_rollout R={LONG_CHECK_ROLLOUTS} S={LONG_CHECK_STEPS}: noise bitwise; "
          f"{json.dumps(err)}")
    record("fused_sample_rollout", err)

    mark(6)
    # --- phase 7: the in-kernel-RNG kernel ---------------------------------
    worst["inkernel_rng_sample_rollout"], inkernel_timing = inkernel_phase(spec, card, fp32_instructions_per_s)
    for S, entry in inkernel_timing.items():
        timing["inkernel_rng_sample_rollout", S] = entry

    mark(7)
    # --- phase 8: the in-kernel-RNG flagship ------------------------------
    check_inkernel_planner_against_cpu()
    inkernel_launches, cells["inkernel-10k-50"] = drive_both(
        {"inkernel_rng": True}, {"inkernel_rng_sample_rollout": 1},
        "phase 8 in-kernel-RNG flagship", card, ["inkernel_rng_sample_rollout"],
    )

    mark(8)
    # --- phase 9: resimulate mode -------------------------------------------
    resimulate_err, resimulate_launches, cells["resimulate-10k-50"], r1_timing = resimulate_phase(
        spec, card, fp32_instructions_per_s
    )

    mark(9)
    # --- phase 10: the safety flagship ----------------------------------------
    safety_err, safety_launches, cells["safety-10k-50"], qp = safety_phase(card, fp32_instructions_per_s)

    mark(10)
    # --- phase 11: the vmap flagship ------------------------------------------
    cells["vmap-10k-50"] = vmap_phase(card)
    print(json.dumps({"cells": cells, "card": card}))

    mark(11)
    # --- phase 12: the FP32 issue-peak probe --------------------------------
    R = SERVING_ROLLOUTS
    kernel_work = {
        "fused_sample_rollout": (R * STEPS * cuda_rollout.STEP_FP32_INSTRUCTIONS,
                                 timing["fused_sample_rollout", STEPS]["ms"]),
        "rollout": (rollout_instructions(R, STEPS), timing["rollout", STEPS]["ms"]),
        SCENARIO_KEY: (rollout_instructions(R, STEPS, SCENARIOS), timing[SCENARIO_KEY, STEPS]["ms"]),
    }
    kernel_work["inkernel_rng_sample_rollout"] = (
        inkernel_timing[STEPS]["instructions"], inkernel_timing[STEPS]["ms"])
    chain_entry = probe_phase(card, kernel_work)

    mark(12)
    # --- phases 13 and 14: the simulated experiment and its tooling ---------
    # Phase 14's replay recordings and phase 13's CPU runs are made on the
    # CPU in child processes while phase 13 runs on the card.
    with tempfile.TemporaryDirectory() as scratch, ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        recordings = pool.submit(record_replays)
        experiment = experiment_phase(card, scratch, pool)
        print(json.dumps({"experiment": experiment}))

        mark(13)
        tooling = tooling_phase(card, scratch, experiment["cli"]["folder"], recordings)
        print(json.dumps({"tooling": tooling}))

    mark(14)
    # --- phase 15: rollout sharding -----------------------------------------
    with tempfile.TemporaryDirectory() as scratch:
        sharded = sharding_phase(spec, card, fp32_instructions_per_s, scratch)
    for key in ("fused_sample_rollout", "inkernel_rng_sample_rollout", SCENARIO_KEY):
        worst[key]["max_abs_err"] = max(worst[key]["max_abs_err"], sharded[key]["max_abs_err"])
    cells["sharded-flagship-2x5k"] = sharded["sharded-flagship-2x5k"]
    cells["mesh-2-ranks"] = sharded["ranks"]
    print(json.dumps({"sharding": {key: value for key, value in sharded.items() if key != "ranks"}, "card": card}))

    mark(15)
    # --- phase 16: the experiment-level scripts -----------------------------
    scripts_phase = experiment_scripts_phase(spec, card, fp32_instructions_per_s)
    print(json.dumps({"experiment_scripts": scripts_phase}))

    mark(16)
    # --- phase 17: the ports of the last four JAX scripts -------------------
    ports = script_ports_phase(spec, card, fp32_instructions_per_s)
    print(json.dumps({"script_ports": ports}))

    mark(17)
    # --- phase 18: the last public surface ----------------------------------
    surface = surface_phase(spec, card)
    print(json.dumps({"surface": surface, "card": card}))

    mark(18)
    # --- phase 19: the kernels line -----------------------------------------
    ranks = sharded["ranks"]["cases"]

    def shard_entry(key, case):
        """Phase 15's numbers of one kernel: its time per launch on a shard's
        block beside the plain version and bound, its worst error there,
        the launches of the twin and of each rank."""
        entry = sharded[key]
        out = {"shard_ms": entry["ms"], "shard_plain_ms": entry["plain_ms"], "shard_bound_ms": entry["bound_ms"],
               "shard_max_abs_err": entry["max_abs_err"]}
        if case is not None:
            out["mesh_rank_launches"] = ranks[case]["rank_launches"]
            out["mesh_twin_launches"] = ranks[case]["twin_launches"]
        return out

    lines = []
    for key, name, launches, extra in (
        ("fused_sample_rollout", "fused_sample_rollout", main_launches, {
            # Phase 10: one launch per update on the safety path, before
            # the filtered re-rollout through the plant.
            "safety_launches": safety_launches["fused_sample_rollout"],
            "safety_rerollout_max_abs_err": safety_err["max_abs_err"],
            # Phase 15: SHARDS launches per update of the twin.
            "sharded_twin_launches": sharded["twin_launches"]["fused_sample_rollout"],
            **shard_entry("fused_sample_rollout", "fused"),
            # Phase 17: the scaling bench's overhead mode, n launches per
            # update over n shards; the time per launch at a shard's block.
            **{f"scaling_x{n}_{key}": entry[key] for n, entry in ports["scaling"].items()
               for key in ("launches", "ms", "bound_ms", "solves_per_s")},
        }),
        (SCENARIO_KEY, "rollout", scenario_launches, {
            "scenarios": SCENARIOS,
            "one_scenario_launches_ms": timing[SCENARIO_KEY, STEPS]["one_scenario_launches_ms"],
            f"one_scenario_launches_ms_s{LONG_STEPS}": timing[SCENARIO_KEY, LONG_STEPS]["one_scenario_launches_ms"],
            # Phase 15: a rank's slice of the ensemble, SCENARIOS / 2 scenarios.
            **shard_entry(SCENARIO_KEY, "scenario"),
        }),
        ("rollout", "rollout", single_launches, {
            "scenarios": 1,
            # Phase 9: one launch at R = 1 per resimulate update, its time
            # beside its plain version and bound, its worst error.
            "resimulate_launches": resimulate_launches["rollout"],
            "r1_ms": r1_timing["ms"],
            "r1_plain_ms": r1_timing["plain_ms"],
            "r1_bound_ms": r1_timing["bound_ms"],
            "r1_bound_by": r1_timing["bound_by"],
            "r1_max_abs_err": resimulate_err["max_abs_err"],
            # Phase 16: the scenario study's C one-scenario launches per
            # update at R = 52 x 30, their time beside the plain version
            # and bound, the worst error of the C-table launch there.
            "study_launches": scripts_phase["kernel2"]["launches"],
            "study_ms": scripts_phase["kernel2"]["timing"][1]["ms"],
            "study_plain_ms": scripts_phase["kernel2"]["timing"][1]["plain_ms"],
            "study_bound_ms": scripts_phase["kernel2"]["timing"][1]["bound_ms"],
            "study_bound_by": scripts_phase["kernel2"]["timing"][1]["bound_by"],
            f"study_x{SCENARIOS}_ms": scripts_phase["kernel2"]["timing"][SCENARIOS]["ms"],
            "study_max_abs_err": scripts_phase["kernel2"]["max_abs_err"],
            # Phase 18: one launch per full-covariance update; against the
            # CPU planner there, against the lanes backend's costs and its
            # re-rollout (R = 1).
            "full_covariance_launches": surface["full_covariance"]["launches_per_update"],
            "full_covariance_max_abs_err": surface["full_covariance"]["against_cpu"]["max_abs_err"],
            "lanes_max_abs_err": surface["lanes"]["kernel2_against_lanes"]["max_abs_err"],
            "lane_filter_max_abs_err": surface["lane_filter_rollout"]["against_kernel2"]["max_abs_err"],
        }),
        ("inkernel_rng_sample_rollout", "inkernel_rng_sample_rollout", inkernel_launches,
         shard_entry("inkernel_rng_sample_rollout", "inkernel")),
    ):
        source, replaces = KERNELS[name]
        serving, long = timing[key, STEPS], timing[key, LONG_STEPS]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "design": DESIGNS[name],
            "launches": launches[name],
            "max_abs_err": worst[key]["max_abs_err"],
            "ms": serving["ms"],
            "plain_ms": serving["plain_ms"],
            "bound_ms": serving["bound_ms"],
            "bound_us": serving["bound_ms"] * 1e3,
            "bound_by": serving["bound_by"],
            "library_ms": None,
            "library_ms_reason": LIBRARY_REASONS[name],
            f"ms_s{LONG_STEPS}": long["ms"],
            f"bound_ms_s{LONG_STEPS}": long["bound_ms"],
            **extra,
            **{error: value for error, value in worst[key].items() if error != "max_abs_err"},
            **ptxas[key],
        })
    source, replaces = KERNELS["admm_qp"]
    lines.append({
        "name": "admm_qp",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "design": DESIGNS["admm_qp"],
        # Phase 10: STEPS launches per safety update, one per filtered step.
        "launches": safety_launches["admm_qp"],
        **qp,
        "library_ms": None,
        "library_ms_reason": "no PyTorch call solves a QP",
        **ptxas["admm_qp"],
    })
    source, replaces = KERNELS["fp32_chain"]
    lines.append({
        "name": "fp32_chain",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "design": DESIGNS["fp32_chain"],
        **chain_entry,
        "library_ms": None,
        "library_ms_reason": "no PyTorch call computes a dependent FMA chain",
        **ptxas["fp32_chain"],
    })
    mark(19)
    print(json.dumps({"phase_seconds": phase_seconds, "total_s": round(time.perf_counter() - start, 1)}))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Map the pose-hold exploration dither to its knobs, on the port.

The port of scripts/pose_dither_sweep.py. The pose episode of the
experiment matrix (scripts/torch_experiments.py: the initial huddled EE
pose held, the order-1 Kalman forecast, assisted) is run once per knob
setting, one knob at a time from the reference defaults (base.hpp:69-101):

- covariance scale x{0.5, 0.25, 0.1, 0.05} (the sampling noise itself),
- gradient step {1, 0.5, 0.25} (how much of the weighted noise is applied),
- SG window {5, 15, 20} (how much of it smoothing removes),
- keep-best {10, 35, 50} (elite reuse concentration),

and, with ``POSE_SWEEP=eps``, the plant's Coulomb friction regularisation
``models/dynamics.FRICTION_EPS`` at {1e-3, 1e-4, 1e-5} (the stiction
hypothesis: a smaller eps creeps less under the controller's dither). The
value is set before the episode is built and restored afterwards; on the
card the captured period graph bakes it in at capture, so the episode is
built, captured and run inside the override. The episode's plant and its
planner's rollouts are the plain PyTorch plant: no rollout kernel runs
here, so the kernels' own ``FRICTION_EPS`` (a constexpr in
kernels/csrc/franka_step.cuh) is not involved.

Per cell (the median over seeds, like the matrix): the whole-episode mean
human force, the tail (t > duration / 2) mean force, and the tail EE dither
RMS about its own mean.

Usage:
    python3 scripts/torch_pose_dither_sweep.py [--device cuda|cpu] [--out DIR]

Environment: ``POSE_SWEEP`` (knobs, eps or all; default knobs),
``POSE_DURATION`` (s, default 15), ``POSE_SEEDS`` (default 0,1,2).
Writes ``torch_pose_dither.json`` (``torch_pose_stiction.json`` for
``POSE_SWEEP=eps``) under ``--out`` only (default
build/torch_pose_dither): the JAX script's keys plus ``device`` and
``power_limit``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import mppi, resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.models import dynamics as dyn  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.sim.episode import episode_metrics  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402


def sweeps(which: str) -> list:
    """(name, overrides) of every row of ``POSE_SWEEP=which``."""
    rows = []
    if which in ("knobs", "all"):
        rows += [("default", {})]
        rows += [(f"cov_x{scale}", {"covariance_scale": scale}) for scale in (0.5, 0.25, 0.1, 0.05)]
        rows += [(f"grad_{step}", {"gradient_step": step}) for step in (1.0, 0.5, 0.25)]
        rows += [(f"sg_{window}", {"smoothing_window": window}) for window in (5, 15, 20)]
        rows += [(f"keep_{keep}", {"keep_best": keep}) for keep in (10, 35, 50)]
    if which in ("eps", "all"):
        rows += [(f"eps_{eps:g}", {"friction_eps": eps}) for eps in (1e-3, 1e-4, 1e-5)]
    return rows


def cell_configuration(overrides: dict) -> mppi.Configuration:
    """The planner of one row: the matrix's, with the row's knob."""
    return dataclasses.replace(
        ex.mppi_configuration(),
        keep_best_rollouts=overrides.get("keep_best", 20),
        gradient_step=overrides.get("gradient_step", 2.0),
        covariance=np.asarray(fr.DEFAULT_COVARIANCE) * overrides.get("covariance_scale", 1.0),
        smoothing=mppi.Smoothing(window=overrides.get("smoothing_window", 10), order=1),
    )


def make_cell_episode(overrides: dict, duration: float, device="cuda", dtype=torch.float32) -> ex.Episode:
    """The assisted order-1 Kalman pose episode of one row. A
    ``friction_eps`` override must be in force while it is built and run
    (``friction_eps``)."""
    return ex.Episode(
        dataclasses.replace(cell_configuration(overrides), dtype=str(dtype).split(".")[-1]),
        ex.AssistedManipulation(),
        ex.make_trajectory("pose"),
        ex.EpisodeConfiguration(
            duration=duration,
            time_step=0.005,
            controller_rate=0.05,
            forecast_time_step=ex.FORECAST_DT,
            forecast_horizon=ex.FORECAST_HORIZON,
            assisted=True,
            controller_enabled=True,
        ),
        wrench_strategy=ex.make_strategy("kalman_1"),
        dtype=dtype,
        device=device,
    )


@contextlib.contextmanager
def friction_eps(value):
    """``models/dynamics.FRICTION_EPS`` set to ``value`` (None: left as it
    is) inside the block and restored after it."""
    saved = dyn.FRICTION_EPS
    if value is not None:
        dyn.FRICTION_EPS = value
    try:
        yield
    finally:
        dyn.FRICTION_EPS = saved


def cell_metrics(outputs) -> dict:
    """The row's metrics of one run: the whole-episode mean force, the tail
    mean force and the tail EE dither RMS (the second half)."""
    metrics = episode_metrics(outputs)
    force = np.linalg.norm(outputs.wrench[:, :3].detach().cpu().double().numpy(), axis=-1)
    ee = outputs.ee_position.detach().cpu().double().numpy()
    tail = slice(len(force) // 2, None)
    ee_tail = ee[tail]
    return {
        "mean_force": metrics["mean_force"],
        "tail_mean_force": float(force[tail].mean()),
        "tail_dither_rms_m": float(np.sqrt(np.mean(np.sum((ee_tail - ee_tail.mean(axis=0)) ** 2, -1)))),
    }


def run_cell(overrides: dict, duration: float, seed: int, device="cuda"):
    """One run of a row; returns (metrics, outputs)."""
    with friction_eps(overrides.get("friction_eps")):
        episode = make_cell_episode(overrides, duration, device)
        outputs = episode.run(seed=seed)
        if episode.device.type == "cuda":
            torch.cuda.synchronize(episode.device)
    return cell_metrics(outputs), outputs


def run_config(overrides: dict, duration: float, seeds, device="cuda") -> dict:
    cells = [run_cell(overrides, duration, seed, device)[0] for seed in seeds]
    forces = sorted(c["mean_force"] for c in cells)
    tails = sorted(c["tail_mean_force"] for c in cells)
    dithers = sorted(c["tail_dither_rms_m"] for c in cells)
    mid = len(cells) // 2
    return {
        **overrides,
        "mean_force": round(forces[mid], 3),
        "force_range": [round(forces[0], 3), round(forces[-1], 3)],
        "tail_mean_force": round(tails[mid], 3),
        "tail_dither_rms_m": round(dithers[mid], 5),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_pose_dither"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    duration = float(os.environ.get("POSE_DURATION", 15.0))
    seeds = [int(s) for s in os.environ.get("POSE_SEEDS", "0,1,2").split(",")]
    which = os.environ.get("POSE_SWEEP", "knobs")
    identity = ex.device_identity(device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)

    rows = []
    for name, overrides in sweeps(which):
        start = time.perf_counter()
        row = run_config(overrides, duration, seeds, device)
        row["name"] = name
        row["wall_s"] = round(time.perf_counter() - start, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)

    result = {
        "metric": "pose_stiction_eps_sweep" if which == "eps" else "pose_dither_knob_map",
        "duration": duration,
        "seeds": seeds,
        "protocol": "pose holds the initial huddled EE pose; kalman_1 assisted; median of seeds; tail = second "
        "half of the episode",
        "reference_pose_assisted_range": [0.04, 0.22],
        "engine_pose_assisted_baseline": "1.4-2.5 N (EXPERIMENTS.md)",
        "rows": rows,
        **identity,
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_pose_stiction.json" if which == "eps" else "torch_pose_dither.json")
    with open(path, "w") as handle:
        json.dump(result, handle, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

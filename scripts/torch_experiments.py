"""Run the reference's headline experiment matrix on the port.

The port of scripts/experiments.py: the experiment grid hard-coded in the
reference analysis script (src/analysis.py:439-460), trajectory {pose,
circle, figure_eight, rectangle} x strategy {unassisted, average, locf,
kalman_1, kalman_2}, reporting mean user force (N) and reference-tracking
RMSE (m) per cell, the median over seeds. Each cell is one
``sim.episode.Episode`` of the port at float32 on ``--device``: on the
card the first controller period runs eagerly and every further whole
period is one replay of a captured CUDA graph.

Usage:
    python scripts/torch_experiments.py [--device cuda|cpu] [--out DIR]
    EXP_DURATION=2 EXP_SEEDS=0 python scripts/torch_experiments.py    # quick pass
    EXP_TRAJECTORIES=circle python scripts/torch_experiments.py       # one row
    EXP_RENDER_ONLY=1 python scripts/torch_experiments.py             # re-render

Environment: ``EXP_DURATION`` (s, default 15), ``EXP_SEEDS`` (default
0,1,2), ``EXP_TRAJECTORIES`` and ``EXP_STRATEGIES`` (comma lists, default
the whole matrix), ``EXP_RENDER_ONLY=1`` (no episode: merge every
``torch_experiments*.json`` under ``--out``, newest last, and render),
``EXP_ANIMATE=1`` (also re-render the scene animations: one harness
episode per trajectory of the run and the slerp case, each drawn by
``analysis.animate`` into ``--out``/artifacts/<name>_scene.gif; it needs
matplotlib, and raises ImportError before any episode without it). A
run of the whole matrix writes ``torch_experiments.json``; a run of some
trajectories ``torch_experiments.<names>.json``, so the matrix can run as
one invocation per trajectory and render as one table.

Outputs, under ``--out`` only (default build/torch_experiments): the JSON
payload (the JAX script's keys plus ``device`` and ``power_limit``) and
TORCH_EXPERIMENTS.md: the force, RMSE and assistance-ratio tables, each
cell beside the JAX package's committed median (experiments.json, read as
data) and the reference's number, and the cells whose median departs from
the JAX seed range widened by 15% of the JAX median on each side.

Left in the JAX script: ``_protocol_notes`` and ``_artifact_sections``
(narratives of the TPU rounds and their evidence files).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import mppi, resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.forecast import forecast as fc  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation  # noqa: E402
from assistedmanipulation_tpu_torch.sim import trajectories  # noqa: E402
from assistedmanipulation_tpu_torch.sim.episode import Episode, EpisodeConfiguration, episode_metrics  # noqa: E402

# Reference experiment results (src/analysis.py:439-460) for side-by-side
# comparison: {trajectory: {strategy: (mean_force_N, rmse_m)}}.
REFERENCE = {
    "pose": {
        "unassisted": (0.00, 0.00109),
        "average": (0.22, 0.00091),
        "locf": (0.09, 0.00071),
        "kalman_1": (0.04, 0.00067),
        "kalman_2": (0.07, 0.00069),
    },
    "circle": {
        "unassisted": (24.81, 0.0906),
        "average": (11.94, 0.0452),
        "locf": (12.29, 0.0437),
        "kalman_1": (12.59, 0.0431),
        "kalman_2": (12.73, 0.0441),
    },
    "figure_eight": {
        "unassisted": (46.32, 0.2072),
        "average": (21.94, 0.0797),
        "locf": (19.18, 0.0702),
        "kalman_1": (16.52, 0.0604),
        "kalman_2": (17.90, 0.0653),
    },
    "rectangle": {
        "unassisted": (34.17, 0.1348),
        "average": (15.50, 0.0574),
        "locf": (15.90, 0.0540),
        "kalman_1": (15.75, 0.0552),
        "kalman_2": (16.70, 0.0569),
    },
}

FORECAST_DT = 0.01
FORECAST_HORIZON = 0.3
TRAJECTORIES = "pose,circle,figure_eight,rectangle"
STRATEGIES = "unassisted,average,locf,kalman_1,kalman_2"
# A cell departs from the JAX package's when its median lies outside the
# JAX seed range widened by this share of the JAX median on each side.
DEPART_WIDENING = 0.15
# The assistance structure: each assisted median below this share of the
# trajectory's unassisted median (the JAX matrix's worst ratio is 0.63).
ASSISTANCE_SHARE = 0.7


def device_identity(device) -> dict:
    """The device a run measured on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index or 0
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit}


def initial_ee_position():
    """FK of the initial (huddled) state at float32: the pose experiment's
    hold target. Holding the initial pose is the only configuration
    consistent with the reference's published pose numbers (0.00 N /
    0.0011 m, analysis.py:451-458); "maintaining pose with external
    wrench" is pose.hpp's stated intent (pose.hpp:6-8)."""
    x = torch.as_tensor(fr.make_state("huddled"), dtype=torch.float32)
    aux = fr.derive_aux(frankaridgeback_model(), x)
    return tuple(float(v) for v in aux.ee_position)


def make_trajectory(name: str):
    if name == "pose":
        return trajectories.PointTrajectory(trajectories.PointConfiguration(point=initial_ee_position()))
    if name == "circle":
        return trajectories.CircularTrajectory(trajectories.CircularConfiguration())
    if name == "figure_eight":
        return trajectories.FigureEightTrajectory(trajectories.FigureEightConfiguration())
    if name == "rectangle":
        return trajectories.RectangularTrajectory(trajectories.RectangularConfiguration())
    if name == "lissajous":
        return trajectories.LissajousTrajectory(trajectories.LissajousConfiguration())
    raise ValueError(name)


def make_strategy(name: str):
    """Wrench forecast strategy per experiment column; None = unassisted."""
    if name == "unassisted":
        return None
    if name == "average":
        return fc.AverageForecast(fc.AverageConfiguration(window=FORECAST_HORIZON))
    if name == "locf":
        return fc.LOCFForecast(fc.LOCFConfiguration(horizon=FORECAST_HORIZON))
    if name.startswith("kalman_"):
        order = int(name.split("_")[1])
        return fc.KalmanForecast(
            fc.KalmanForecastConfiguration(
                observed_states=6, order=order, time_step=FORECAST_DT, horizon=FORECAST_HORIZON
            )
        )
    raise ValueError(name)


def mppi_configuration() -> mppi.Configuration:
    """The master defaults (base.hpp:61-196, mirrored in sim/actor.py)."""
    return mppi.Configuration(
        rollouts=50,
        keep_best_rollouts=20,
        time_step=0.01,
        horizon=0.3,
        gradient_step=2.0,
        cost_scale=10.0,
        cost_discount_factor=1.0,
        covariance=fr.DEFAULT_COVARIANCE,
        control_bound=True,
        control_min=fr.DEFAULT_CONTROL_MIN,
        control_max=fr.DEFAULT_CONTROL_MAX,
        control_default=np.zeros(12),
        smoothing=mppi.Smoothing(window=10, order=1),
    )


def make_episode(trajectory_name: str, strategy_name: str, duration: float, device="cuda", capture=None,
                 collect_logs: bool = False) -> Episode:
    """One cell's episode at float32 on ``device`` (captured on a card
    unless ``capture`` is False)."""
    strategy = make_strategy(strategy_name)
    return Episode(
        mppi_configuration(),
        AssistedManipulation(),
        make_trajectory(trajectory_name),
        EpisodeConfiguration(
            duration=duration,
            time_step=0.005,
            controller_rate=0.05,
            forecast_time_step=FORECAST_DT,
            forecast_horizon=FORECAST_HORIZON,
            # "Unassisted" = no wrench forecast reaches the planner; the
            # controller still runs, optimizing the posture terms: the
            # reference has no controller-off switch (actor.cpp:166-203)
            # and its unassisted rows were produced this way.
            assisted=strategy is not None,
            controller_enabled=True,
        ),
        wrench_strategy=strategy,
        dtype=torch.float32,
        collect_logs=collect_logs,
        device=device,
        capture=capture,
    )


def run_cell(trajectory_name: str, strategy_name: str, duration: float, seed: int, device="cuda"):
    episode = make_episode(trajectory_name, strategy_name, duration, device)
    start = time.perf_counter()
    outputs = episode.run(seed=seed)
    if episode.device.type == "cuda":
        torch.cuda.synchronize(episode.device)
    elapsed = time.perf_counter() - start
    metrics = episode_metrics(outputs)
    metrics["wall_s"] = round(elapsed, 2)
    return metrics


def run_cell_seeds(trajectory_name: str, strategy_name: str, duration: float, seeds, device="cuda"):
    """Median-of-seeds cell protocol: MPPI is a stochastic controller and
    a dragged episode is chaotic, so the matrix reports the per-cell
    MEDIAN over the seeds with the min-max spread alongside."""
    runs = [run_cell(trajectory_name, strategy_name, duration, seed, device=device) for seed in seeds]
    forces = sorted(r["mean_force"] for r in runs)
    rmses = sorted(r["rmse"] for r in runs)
    mid = len(runs) // 2
    return {
        "mean_force": forces[mid],
        "rmse": rmses[mid],
        "force_range": [round(forces[0], 2), round(forces[-1], 2)],
        "rmse_range": [round(rmses[0], 4), round(rmses[-1], 4)],
        "seeds": list(seeds),
        "max_force": max(r["max_force"] for r in runs),
        "final_energy": runs[mid]["final_energy"],
        "wall_s": round(sum(r["wall_s"] for r in runs), 2),
    }


def payload_name(trajectory_names) -> str:
    if trajectory_names == TRAJECTORIES.split(","):
        return "torch_experiments.json"
    return f"torch_experiments.{'+'.join(trajectory_names)}.json"


def merge_payloads(out: str) -> dict:
    """Every ``torch_experiments*.json`` under ``out`` as one payload, the
    newest file's cells last; their durations and seeds must agree."""
    paths = sorted(glob.glob(os.path.join(out, "torch_experiments*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no torch_experiments*.json under {out}")
    merged = None
    devices, limits = [], []
    for path in paths:
        with open(path) as handle:
            payload = json.load(handle)
        if merged is None:
            merged = {key: value for key, value in payload.items() if key != "results"}
            merged["results"] = {}
        elif (payload["duration"], payload["seeds"]) != (merged["duration"], merged["seeds"]):
            raise ValueError(f"{path}: duration and seeds differ from {paths[0]}")
        for trajectory_name, cells in payload["results"].items():
            merged["results"].setdefault(trajectory_name, {}).update(cells)
        for value, seen in ((payload["device"], devices), (payload["power_limit"], limits)):
            if value not in seen:
                seen.append(value)
    merged["device"] = "; ".join(devices)
    merged["power_limit"] = "; ".join(str(limit) for limit in limits)
    return merged


def jax_results() -> dict:
    """The JAX package's committed matrix (experiments.json), read as data."""
    path = os.path.join(ROOT, "experiments.json")
    if not os.path.exists(path):
        return {}
    with open(path) as handle:
        return json.load(handle)["results"]


def departures(results: dict, jax: dict) -> list:
    """Cells whose force or RMSE median lies outside the JAX cell's seed
    range widened by DEPART_WIDENING x the JAX median on each side:
    (trajectory, strategy, metric, port median, (low, high))."""
    found = []
    for trajectory_name, cells in results.items():
        for strategy_name, cell in cells.items():
            want = jax.get(trajectory_name, {}).get(strategy_name)
            if want is None:
                continue
            for metric, spread in (("mean_force", "force_range"), ("rmse", "rmse_range")):
                low, high = want[spread]
                pad = DEPART_WIDENING * want[metric]
                band = (low - pad, high + pad)
                if not band[0] <= cell[metric] <= band[1]:
                    found.append((trajectory_name, strategy_name, metric, cell[metric], band))
    return found


def render(payload: dict) -> list:
    """TORCH_EXPERIMENTS.md's lines."""
    duration, seeds, results = payload["duration"], payload["seeds"], payload["results"]
    trajectory_names = list(results)
    strategy_names = list(dict.fromkeys(name for cells in results.values() for name in cells))
    jax = jax_results()

    def jax_cell(trajectory_name, strategy_name):
        return jax.get(trajectory_name, {}).get(strategy_name)

    lines = [
        "# TORCH_EXPERIMENTS — the assisted-manipulation matrix on the PyTorch port",
        "",
        f"Device: {payload['device']}, power limit {payload['power_limit']}. Episode duration {duration} s, sim "
        "dt 0.005 s, MPPI 50+2 rollouts / 0.3 s horizon / 20 Hz (the reference defaults), float32. Each cell is "
        f"one `sim.episode.Episode` per seed; cells report the MEDIAN over seeds {seeds} with the min-max range. "
        "Beside each: the JAX package's committed median (experiments.json) and the reference's number "
        "(src/analysis.py:439-460). The port draws with Philox, the JAX package with threefry: the same seed "
        "is another run of a chaotic process.",
    ]
    for title, metric, spread, digits, ref_index in (
        ("Mean user force (N) — lower = more assistance", "mean_force", "force_range", 2, 0),
        ("Tracking RMSE (m) — human-intended trajectory error", "rmse", "rmse_range", 4, 1),
    ):
        lines += ["", f"## {title}", "", "| Trajectory | " + " | ".join(strategy_names) + " |",
                  "|---|" + "---|" * len(strategy_names)]
        for trajectory_name in trajectory_names:
            row = [trajectory_name]
            for strategy_name in strategy_names:
                cell = results[trajectory_name].get(strategy_name)
                if cell is None:
                    row.append("not run")
                    continue
                low, high = cell[spread]
                text = f"{cell[metric]:.{digits}f} [{low:.{digits}f}-{high:.{digits}f}]"
                notes = []
                want = jax_cell(trajectory_name, strategy_name)
                if want is not None:
                    notes.append(f"JAX {want[metric]:.{digits}f}")
                ref = REFERENCE.get(trajectory_name, {}).get(strategy_name)
                if ref is not None:
                    notes.append(f"ref {ref[ref_index]:.{digits}f}")
                row.append(text + (f" ({', '.join(notes)})" if notes else ""))
            lines.append("| " + " | ".join(row) + " |")
    assisted_names = [name for name in strategy_names if name != "unassisted"]
    if "unassisted" in strategy_names:
        lines += ["", "## Assistance ratio — assisted / unassisted mean force (reference ≈ 0.5, "
                  "analysis.py:451-458)", "", "| Trajectory | " + " | ".join(assisted_names) + " |",
                  "|---|" + "---|" * len(assisted_names)]
        above = []
        for trajectory_name in trajectory_names:
            cells = results[trajectory_name]
            if "unassisted" not in cells:
                continue
            base = cells["unassisted"]["mean_force"]
            row = [trajectory_name]
            for strategy_name in assisted_names:
                if strategy_name not in cells:
                    row.append("not run")
                    continue
                ratio = cells[strategy_name]["mean_force"] / base if base > 1e-9 else float("nan")
                notes = []
                want, want_base = jax_cell(trajectory_name, strategy_name), jax_cell(trajectory_name, "unassisted")
                if want is not None and want_base is not None and want_base["mean_force"] > 1e-9:
                    notes.append(f"JAX {want['mean_force'] / want_base['mean_force']:.2f}")
                ref = REFERENCE.get(trajectory_name, {})
                if strategy_name in ref and ref.get("unassisted", (0.0,))[0] > 1e-9:
                    notes.append(f"ref {ref[strategy_name][0] / ref['unassisted'][0]:.2f}")
                row.append(f"{ratio:.2f}" + (f" ({', '.join(notes)})" if notes else ""))
                if not ratio < ASSISTANCE_SHARE:
                    above.append(f"{trajectory_name}/{strategy_name} {ratio:.2f}")
            lines.append("| " + " | ".join(row) + " |")
        lines += ["", f"Assisted medians not below {ASSISTANCE_SHARE} x the unassisted: "
                  + (", ".join(above) if above else "none") + "."]
    found = departures(results, jax)
    lines += ["", f"## Cells departing from the JAX package (outside its seed range widened by "
              f"{DEPART_WIDENING:.0%} of its median)", ""]
    lines += [f"- {t}/{s} {metric}: {value:.4f} outside [{band[0]:.4f}, {band[1]:.4f}]"
              for t, s, metric, value, band in found] or ["None."]
    lines.append("")
    return lines


def require_matplotlib() -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError as error:
        raise ImportError("EXP_ANIMATE draws with matplotlib, which is not installed") from error


def regenerate_animations(out: str, trajectory_names, duration: float, device="cuda") -> list:
    """The scene animations beside the matrix (EXP_ANIMATE=1; the JAX
    script's ``regenerate_animations``): one harness episode per trajectory
    and the slerp case (torque PID live, with the JAX script's demo gains),
    each drawn by ``analysis.animate`` into ``out``/artifacts/<name>_scene.gif.
    The episodes run in a temporary folder. Returns the GIFs written."""
    import tempfile

    from assistedmanipulation_tpu_torch import analysis
    from assistedmanipulation_tpu_torch.harness.runner import TestSuite

    require_matplotlib()
    os.makedirs(os.path.join(out, "artifacts"), exist_ok=True)
    written = []
    for name in list(trajectory_names) + ["slerp"]:
        patch = {"duration": duration, "engine": "episode"}
        if name == "slerp":
            # The JAX script's human-plausible torque gains: the reference's
            # orientation preset (kp 500, +-10,000 N m) saturates the arm.
            patch["torque_enabled"] = True
            patch["torque_pid"] = {
                "kp": [30, 30, 30], "kd": [3, 3, 3], "ki": [0, 0, 0],
                "minimum": [-30, -30, -30], "maximum": [30, 30, 30],
            }
        with tempfile.TemporaryDirectory() as tmp:
            if not TestSuite.run(name, tmp, patch=patch, device=device):
                print(f"animate: {name} run failed; skipping", flush=True)
                continue
            (run_folder,) = [entry.path for entry in os.scandir(tmp)]
            gif = os.path.join(out, "artifacts", f"{name}_scene.gif")
            analysis.animate(run_folder, gif)
            written.append(gif)
            print(f"animate: wrote {gif}", flush=True)
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_experiments"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    animate = os.environ.get("EXP_ANIMATE") == "1"
    if animate:
        require_matplotlib()
    if os.environ.get("EXP_RENDER_ONLY") == "1":
        payload = merge_payloads(args.out)
    else:
        device = resolve_device(args.device)
        duration = float(os.environ.get("EXP_DURATION", 15.0))
        seeds = [int(s) for s in os.environ.get("EXP_SEEDS", "0,1,2").split(",")]
        trajectory_names = os.environ.get("EXP_TRAJECTORIES", TRAJECTORIES).split(",")
        strategy_names = os.environ.get("EXP_STRATEGIES", STRATEGIES).split(",")
        identity = device_identity(device)
        print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)

        results = {}
        for trajectory_name in trajectory_names:
            results[trajectory_name] = {}
            for strategy_name in strategy_names:
                metrics = run_cell_seeds(trajectory_name, strategy_name, duration, seeds, device=device)
                results[trajectory_name][strategy_name] = metrics
                print(
                    f"{trajectory_name:13s} {strategy_name:10s} "
                    f"force {metrics['mean_force']:7.2f} N  {metrics['force_range']}  "
                    f"rmse {metrics['rmse']:7.4f} m  ({metrics['wall_s']}s wall)",
                    flush=True,
                )
        payload = {
            "duration": duration,
            "seeds": seeds,
            "pose_point": "initial huddled EE pose",
            "results": results,
            **identity,
        }
        path = os.path.join(args.out, payload_name(trajectory_names))
        with open(path, "w") as handle:
            json.dump(payload, handle, indent=2)
        print(f"wrote {path}", flush=True)
    if animate:
        regenerate_animations(args.out, list(payload["results"]), payload["duration"],
                              resolve_device(args.device))
    path = os.path.join(args.out, "TORCH_EXPERIMENTS.md")
    with open(path, "w") as handle:
        handle.write("\n".join(render(payload)))
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

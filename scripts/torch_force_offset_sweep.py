"""Plant-parameter sweep behind the unassisted force offset, on the port.

The port of scripts/force_offset_sweep.py: the evidence grid that
localised the unassisted cells' force offset against the reference, run
with the port's ``sim.episode.Episode`` (unassisted, no wrench strategy,
float32, on ``--device``; captured on the card where the controller runs,
a plain eager tick loop where it does not):

1. ``friction``: the model's Coulomb friction scaled by {1, 0.5, 0.25, 0}
   (``dataclasses.replace`` on the port's ``RobotModel``), controller off,
   circle and rectangle;
2. ``gains``: base/arm differential gains {(1000, 10), (500, 10),
   (250, 10), (1000, 5)} through ``fr.Configuration`` (the reference's are
   1000 / 10, raisim_dynamics.hpp:57-76), controller off, circle and
   rectangle;
3. ``controller``: off and on (the reference-faithful unassisted mode: the
   planner runs with no forecast), circle, rectangle and figure-eight;
4. ``seeds``: seeds 0-2 of the controller-on unassisted episodes.

The model and the gains reach the device through ``ops.constant``, which
keys its cache on the values, so a scaled friction is the one the plant
uses. No rollout kernel runs here: the planner is the plain PyTorch plant.

Usage:
    [SWEEP_DURATION=15] python3 scripts/torch_force_offset_sweep.py [--device cuda|cpu] [--out DIR]

Writes ``torch_force_offset_sweep.json`` under ``--out`` only (default
build/torch_force_offset_sweep): the JAX script's keys plus ``device`` and
``power_limit``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402

REFERENCE = {"circle": 24.81, "rectangle": 34.17, "figure_eight": 46.32}
STUDIES = ("friction", "gains", "controller", "seeds")
FRICTION_SCALES = (1.0, 0.5, 0.25, 0.0)
GAINS = ((1000.0, 10.0), (500.0, 10.0), (250.0, 10.0), (1000.0, 5.0))


def scaled_friction_model(scale: float):
    base = frankaridgeback_model()
    return dataclasses.replace(base, friction=base.friction * scale)


def gains_configuration(base_kd: float, arm_kd: float) -> fr.Configuration:
    """The plant's PD with the base and arm differential gains given (the
    proportional gain and the gripper's as the JAX script sets them)."""
    kp = np.array([0.0] * 10 + [100.0, 100.0])
    kd = np.array([base_kd] * 3 + [arm_kd] * 7 + [50.0, 50.0])
    return fr.Configuration(proportional_gain=kp, differential_gain=kd)


def make_episode(trajectory: str, duration: float, model=None, robot_configuration=None, controller: bool = False,
                 device="cuda", dtype=torch.float32) -> ex.Episode:
    """An unassisted episode of the matrix's planner with no wrench
    strategy; ``controller`` False runs the plant alone."""
    return ex.Episode(
        dataclasses.replace(ex.mppi_configuration(), dtype=str(dtype).split(".")[-1]),
        ex.AssistedManipulation(),
        ex.make_trajectory(trajectory),
        ex.EpisodeConfiguration(
            duration=duration,
            time_step=0.005,
            controller_rate=0.05,
            forecast_time_step=ex.FORECAST_DT,
            forecast_horizon=ex.FORECAST_HORIZON,
            assisted=False,
            controller_enabled=controller,
        ),
        wrench_strategy=None,
        robot_configuration=robot_configuration,
        model=model,
        dtype=dtype,
        device=device,
    )


def run(trajectory: str, duration: float, seed: int = 0, device="cuda", **options):
    """One episode (``make_episode``'s options); returns (rounded metrics,
    outputs)."""
    episode = make_episode(trajectory, duration, device=device, **options)
    outputs = episode.run(seed=seed)
    if episode.device.type == "cuda":
        torch.cuda.synchronize(episode.device)
    metrics = ex.episode_metrics(outputs)
    return {"mean_force": round(metrics["mean_force"], 2), "rmse": round(metrics["rmse"], 4)}, outputs


def study(name: str, duration: float, device="cuda") -> list:
    """The rows of one study, each printed as it lands."""
    rows = []
    if name == "friction":
        for scale in FRICTION_SCALES:
            model = scaled_friction_model(scale)
            row = {"friction_scale": scale}
            for trajectory in ("circle", "rectangle"):
                row[trajectory] = run(trajectory, duration, model=model, device=device)[0]
            rows.append(row)
    elif name == "gains":
        for base_kd, arm_kd in GAINS:
            configuration = gains_configuration(base_kd, arm_kd)
            row = {"base_kd": base_kd, "arm_kd": arm_kd}
            for trajectory in ("circle", "rectangle"):
                row[trajectory] = run(trajectory, duration, robot_configuration=configuration, device=device)[0]
            rows.append(row)
    elif name == "controller":
        for controller in (False, True):
            row = {"controller_enabled": controller}
            for trajectory in ("circle", "rectangle", "figure_eight"):
                row[trajectory] = run(trajectory, duration, controller=controller, device=device)[0]
            rows.append(row)
    else:  # seeds
        for trajectory in ("circle", "rectangle", "figure_eight"):
            runs = {seed: run(trajectory, duration, seed, controller=True, device=device)[0] for seed in (0, 1, 2)}
            rows.append({"trajectory": trajectory, "runs": runs})
    for row in rows:
        print(name, json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_force_offset_sweep"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    duration = float(os.environ.get("SWEEP_DURATION", 15.0))
    identity = ex.device_identity(device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)

    report = {"duration": duration, "reference": REFERENCE}
    for name in STUDIES:
        report[name] = study(name, duration, device)
    report.update(identity)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_force_offset_sweep.json")
    with open(path, "w") as handle:
        json.dump(report, handle, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

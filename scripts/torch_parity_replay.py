"""Measure the BASELINE "control-seq max error" metric on the port's planner.

The protocol of scripts/parity_replay.py, carried to the PyTorch port. The
port's float64 reference-pipeline replayer (assistedmanipulation_tpu_torch/
parity.py: mt19937 serial column noise, elite sort and shift, min-max
softmax, the MovingExtendedWindow Savitzky-Golay evolution) runs N
consecutive updates; the port's planner (``mppi.Planner`` over the plant,
on ``device``) is fed the replayer's recorded noise each update
(``noise_override``), and the metric is the largest absolute difference
between the two published control sequences.

The replayer's step and cost functions are the port's own plant on one
state, on the CPU in float64 (``float64_plant_fns``). The plant evolves
closed-loop between updates (sim dt 0.005 s, control period 0.05 s, the
reference's BaseTest rates, base.hpp:65,148) under the replayer's published
control, so neither the replayer nor the states it visits depend on the
planner under test: one recording (``record``) serves every dtype and
device.

- ``run``: the point mass (BASELINE config 1, models/point_mass.py). The
  replayer draws from the full covariance below; the port samples from
  diagonal covariances only, and with every sampled row injected the
  planner's own covariance is unused, so it gets the diagonal.
- ``run_franka``: the Franka-Ridgeback plant and the 7-term objective from
  the out-of-bounds ``joint_limit`` preset, so barrier saturation
  (cost.hpp:43-99), the elite sort over saturated totals (mppi.cpp:219-231)
  and NaN poisoning (mppi.cpp:331-334) are live in every update.

Usage:
    python scripts/torch_parity_replay.py [--device cuda|cpu] [--updates 12]
        [--rollouts 30] [--franka-updates 8] [--franka-rollouts 32] [--out FILE]

Prints one JSON object (float64 and float32 on each plant), or writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from assistedmanipulation_tpu_torch import mppi  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models import point_mass  # noqa: E402
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (  # noqa: E402
    AssistedManipulation,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parity import ReferenceTrajectoryReplayer, ReplayerConfig  # noqa: E402

TARGET = np.array([1.0, 1.0])
COVARIANCE = np.array([[0.5, 0.1], [0.1, 0.4]])
TIME_STEP = 0.01
HORIZON = 0.3
CONTROL_PERIOD = 0.05
SIM_TIME_STEP = 0.005
# The Franka replay's deterministic NaN rule: a step's cost is NaN where
# the elbow torque command u[5] exceeds this (~2 sigma of the 7.5-variance
# arm noise), standing in for the reference's dynamics blowups; applied on
# both sides.
NAN_THRESHOLD = 5.5


class Recording(NamedTuple):
    """One replay: per update the state and time it ran at, the sampled
    noise it drew (rollouts, steps, dof) and its published control
    (steps, dof); the rollouts it poisoned and saturated."""

    states: list
    times: list
    noise: list
    published: list
    rollout_count: int
    steps: int
    nan_poisoned_rollouts: int
    saturated_rollouts: int


def float64_plant_fns(plant: mppi.Plant, ctx=None, poison: bool = False):
    """The replayer's ``step_fn(x, u, dt)`` and ``cost_fn(x, u, t)``: the
    port's ``plant`` on one state, on the CPU in float64. The cost is the
    reference's scalar total (saturations x BARRIER_SCALE + smooth,
    cost.hpp:43-99), NaN where ``poison`` and u[5] > NAN_THRESHOLD.

    The replayer steps each state right after costing it under the same
    control, so the state's derived quantities are kept from the cost call
    (the port's plants derive from the state alone, not the time). Both
    run in inference mode: nothing here is differentiated."""
    last = {}

    def derive(x):
        key = x.tobytes()
        if last.get("key") != key:
            last["key"], last["x"] = key, torch.from_numpy(np.array(x, np.float64))
            last["aux"] = plant.derive(last["x"], torch.zeros((), dtype=torch.float64), ctx)
        return last["x"], last["aux"]

    @torch.inference_mode()
    def step_fn(x, u, dt):
        state, aux = derive(x)
        t = torch.zeros((), dtype=torch.float64)
        return plant.integrate(state, torch.from_numpy(np.asarray(u, np.float64)), aux, t, dt, ctx).numpy()

    @torch.inference_mode()
    def cost_fn(x, u, t):
        if poison and u[5] > NAN_THRESHOLD:
            return float("nan")
        state, aux = derive(x)
        channels = mppi.as_cost_channels(
            plant.cost(state, torch.from_numpy(np.asarray(u, np.float64)), aux,
                       torch.tensor(t, dtype=torch.float64), ctx),
            (),
        )
        return float(channels[0] * mppi.BARRIER_SCALE + channels[1])

    return step_fn, cost_fn


def record(replayer: ReferenceTrajectoryReplayer, step_fn, x0, updates: int) -> Recording:
    """Run ``updates`` replayer updates closed-loop from ``x0``: between
    updates the plant steps at SIM_TIME_STEP under the replayer's published
    control (actor.cpp:166-203 rate division)."""
    x = np.asarray(x0, np.float64)
    states, times, noise, published = [], [], [], []
    nan_rollouts = saturated = 0
    for k in range(updates):
        t = k * CONTROL_PERIOD
        states.append(x.copy())
        times.append(t)
        noise.append(replayer.update(x, t))
        published.append(replayer.optimal_control.T.copy())
        nan_rollouts += int(np.isnan(replayer.costs).sum())
        saturated += int((replayer.costs >= mppi.BARRIER_SCALE).sum())
        for j in range(int(round(CONTROL_PERIOD / SIM_TIME_STEP))):
            x = step_fn(x, replayer.get(t + j * SIM_TIME_STEP), SIM_TIME_STEP)
    return Recording(states, times, noise, published, replayer.rollout_count, replayer.steps,
                     nan_rollouts, saturated)


def replay(planner: mppi.Planner, recording: Recording, ctx=None) -> list:
    """Feed ``planner`` the recording's noise, update by update: the largest
    |planner - replayer| over each published control sequence."""
    state = planner.init(seed=0)
    errors = []
    for x, t, noise, published in zip(recording.states, recording.times, recording.noise, recording.published):
        state, _ = planner.update(state, x, t, ctx, noise_override=noise)
        optimal = state.optimal_control.detach().to("cpu", torch.float64).numpy()
        errors.append(float(np.abs(optimal - published).max()))
    return errors


def _replayer_configuration(rollouts: int, covariance, control_min, control_max) -> ReplayerConfig:
    return ReplayerConfig(
        rollouts=rollouts, keep_best_rollouts=rollouts // 3, time_step=TIME_STEP, horizon=HORIZON,
        gradient_step=2.0, cost_scale=10.0, cost_discount_factor=1.0, covariance=covariance,
        control_min=control_min, control_max=control_max, smoothing_window=10, smoothing_order=1,
    )


def _planner_configuration(rollouts: int, covariance, control_min, control_max, dtype: str) -> mppi.Configuration:
    return mppi.Configuration(
        rollouts=rollouts, keep_best_rollouts=rollouts // 3, time_step=TIME_STEP, horizon=HORIZON,
        gradient_step=2.0, cost_scale=10.0, covariance=covariance, control_min=control_min,
        control_max=control_max, smoothing=mppi.Smoothing(window=10, order=1), dtype=dtype,
    )


def _result(recording: Recording, errors: list, dtype: str, device) -> dict:
    return {
        "dtype": dtype,
        "device": str(device),
        "updates": len(errors),
        "rollouts": recording.rollout_count,
        "steps": recording.steps,
        "control_seq_max_error": max(errors),
        "per_update_max_error": errors,
    }


def record_point_mass(updates: int, rollouts: int) -> Recording:
    plant = point_mass.make_point_mass_plant(point_mass.PointMassConfig(target=tuple(TARGET)))
    step_fn, cost_fn = float64_plant_fns(plant)
    replayer = ReferenceTrajectoryReplayer(
        _replayer_configuration(rollouts, COVARIANCE, -np.ones(2), np.ones(2)), step_fn, cost_fn, seed=7
    )
    return record(replayer, step_fn, np.zeros(4), updates)


def run(updates: int = 12, rollouts: int = 30, dtype: str = "float64", device="cuda",
        recording: Recording = None) -> dict:
    """The point-mass replay (BASELINE config 1) with the planner at
    ``dtype`` on ``device``; ``recording`` reuses a ``record_point_mass``."""
    recording = recording or record_point_mass(updates, rollouts)
    plant = point_mass.make_point_mass_plant(point_mass.PointMassConfig(target=tuple(TARGET)))
    planner = mppi.Planner(
        _planner_configuration(rollouts, np.diag(COVARIANCE), -np.ones(2), np.ones(2), dtype), plant, device=device
    )
    return _result(recording, replay(planner, recording), dtype, planner.device)


def _franka_context(dtype=torch.float64, device="cpu") -> ForecastContext:
    """A constant 20 N x-pull forecast, so the trajectory term engages; one
    long horizon covers every update's rollout window on both sides."""
    wrench = np.zeros((201, 6))
    wrench[:, 0] = 20.0
    return ForecastContext(
        torch.tensor(wrench, dtype=dtype, device=device), torch.zeros((), dtype=dtype, device=device), 0.01, 2.0
    )


def record_franka(updates: int, rollouts: int) -> Recording:
    step_fn, cost_fn = float64_plant_fns(fr.make_plant(AssistedManipulation()), _franka_context(), poison=True)
    replayer = ReferenceTrajectoryReplayer(
        _replayer_configuration(rollouts, np.diag(fr.DEFAULT_COVARIANCE), fr.DEFAULT_CONTROL_MIN,
                                fr.DEFAULT_CONTROL_MAX),
        step_fn, cost_fn, seed=7,
    )
    return record(replayer, step_fn, fr.make_state("joint_limit", energy=10.0), updates)


def run_franka(updates: int = 8, rollouts: int = 32, dtype: str = "float64", device="cuda",
               recording: Recording = None) -> dict:
    """The Franka replay with live barrier saturation and NaN poisoning,
    the planner at ``dtype`` on ``device``; ``recording`` reuses a
    ``record_franka``."""
    recording = recording or record_franka(updates, rollouts)
    objective = AssistedManipulation()

    def poisoned_cost(x, u, aux, t, ctx=None):
        channels = objective(x, u, aux, t, ctx)
        return torch.where(u[..., 5:6] > NAN_THRESHOLD, float("nan"), channels)

    planner = mppi.Planner(
        _planner_configuration(rollouts, fr.DEFAULT_COVARIANCE, fr.DEFAULT_CONTROL_MIN, fr.DEFAULT_CONTROL_MAX,
                               dtype),
        fr.make_plant(objective)._replace(cost=poisoned_cost), device=device,
    )
    ctx = _franka_context(planner.dtype, planner.device)
    return {
        **_result(recording, replay(planner, recording, ctx), dtype, planner.device),
        "nan_poisoned_rollouts": recording.nan_poisoned_rollouts,
        "saturated_rollouts": recording.saturated_rollouts,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--updates", type=int, default=12)
    parser.add_argument("--rollouts", type=int, default=30)
    parser.add_argument("--franka-updates", type=int, default=8)
    parser.add_argument("--franka-rollouts", type=int, default=32)
    parser.add_argument("--out", help="write the JSON here instead of printing it")
    args = parser.parse_args(argv)

    point = record_point_mass(args.updates, args.rollouts)
    franka = record_franka(args.franka_updates, args.franka_rollouts)
    results = {
        "metric": "control-seq max error vs reference pipeline replay (BASELINE.json), recorded-noise protocol, "
                  "the port's planner",
        **{dtype: run(args.updates, args.rollouts, dtype, args.device, point) for dtype in ("float64", "float32")},
        "franka": {
            dtype: run_franka(args.franka_updates, args.franka_rollouts, dtype, args.device, franka)
            for dtype in ("float64", "float32")
        },
    }
    text = json.dumps(results, indent=1)
    if args.out:
        with open(args.out, "w") as handle:
            handle.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

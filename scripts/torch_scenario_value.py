"""Does the forecast-scenario ensemble help? The port's study.

The port of scripts/scenario_value.py. The reference's Kalman wrench filter
carries a full posterior covariance it never uses for planning
(forecast.cpp:277-330 computes it, then the planner reads only the mean
horizon). forecast/scenarios.py samples a scenario ensemble from that
posterior and scores every MPPI rollout against the ensemble mean (BASELINE
config 5). This study measures whether that helps: the circle scenario
with NOISY wrench observations (Gaussian noise of standard deviation SIGMA
newtons added to every observation the Kalman filter sees), planned with C
in {1, 4} scenarios, comparing mean human force and tracking RMSE over
seeds 0-2.

Protocol: one closed-loop episode per (sigma, C, seed): the human PID pulls
the EE around the circle, observations feed the order-1 Kalman forecast
with an honest noise model, the planner updates at 20 Hz with the sampled
ensemble as its context, the plant steps at 200 Hz between updates. The
planner scores its batch with ``make_scenario_rollout_fn(make_cuda_rollout_fn
(...))``: on the card one launch of the two-pass rollout kernel
(kernels/csrc/rollout.cu) per scenario per update, on the CPU its plain
version; both arms run it, so the only difference is the ensemble. On the
card the update and the period's 10 ticks are each one CUDA graph
(scripts/torch_realtime_check.CapturedLoop), the first period eager. Each
period draws its scenario and observation noise from generators seeded
from the host key of ``seed + 7777``.

Writes torch_scenario_value.json into ``--out`` (default
build/torch_scenario_value): the JAX file's keys plus ``device`` and
``power_limit``.

Usage: [SV_DURATION=15] python scripts/torch_scenario_value.py [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.forecast import forecast as fc  # noqa: E402
from assistedmanipulation_tpu_torch.forecast.scenarios import (  # noqa: E402
    make_scenario_rollout_fn,
    sample_scenarios,
)
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import make_cuda_rollout_fn  # noqa: E402
from assistedmanipulation_tpu_torch.kernels.philox import key_from_seed, seed_bits, split_key  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (  # noqa: E402
    Configuration as ObjectiveConfiguration,
)
from assistedmanipulation_tpu_torch.ops import constant  # noqa: E402
from assistedmanipulation_tpu_torch.sim.actor import Configuration  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402
from scripts.torch_realtime_check import SIM_DT, CapturedLoop, LoopState, RealtimeLoop  # noqa: E402

SIGMAS = (0.0, 5.0, 10.0)
SCENARIOS = (1, 4)
SEEDS = (0, 1, 2)


def make_strategy(sigma: float) -> fc.KalmanForecast:
    """Order-1 Kalman forecast with an HONEST noise model: the filter is
    told the actual observation noise (R = sigma^2 I, floored at the
    reference's 1e-8) and a unit transition variance for model mismatch,
    so its posterior, and therefore the sampled scenario ensemble, carries
    real uncertainty. With the reference's pinned 1e-8 covariances the
    posterior is degenerate (~1e-4 N spread) and the ensemble trivially
    equals the mean."""
    return fc.KalmanForecast(
        fc.KalmanForecastConfiguration(
            observed_states=6, order=1, time_step=0.01, horizon=0.3,
            observation_variance=max(sigma**2, 1e-8),
            transition_variance=(1.0 if sigma > 0 else None),
        )
    )


class ScenarioLoop(RealtimeLoop):
    """The study's closed loop for one arm (``scenarios``, ``sigma``) on
    ``device``: the realtime check's loop with the honest Kalman forecast,
    the scenario ensemble in the update and noisy observations in the
    ticks. ``mppi_configuration`` defaults to the master defaults
    (torch_experiments.mppi_configuration)."""

    def __init__(self, scenarios: int, sigma: float, mppi_configuration=None, device="cuda"):
        configuration = Configuration(mppi=mppi_configuration or ex.mppi_configuration())
        robot, planner_cfg = configuration.dynamics, configuration.mppi
        rollout_fn = make_cuda_rollout_fn(
            frankaridgeback_model(), ObjectiveConfiguration(), robot, planner_cfg.step_count,
            planner_cfg.time_step, device=device,
        )
        super().__init__(configuration, device, strategy=make_strategy(sigma),
                         rollout_fn=make_scenario_rollout_fn(rollout_fn))
        self.scenarios, self.sigma = scenarios, sigma
        self.scenario_generator = torch.Generator(device=self.device)
        self.observation_generator = torch.Generator(device=self.device)

    def forecast_ctx(self, x, strategy_state, t, draws=None):
        """The dynamics forecast's context, its wrench horizon replaced by
        ``scenarios`` horizons sampled from the Kalman posterior (scenario
        0 the mean) when there is more than one; ``draws``: the standard
        normals to use instead of the scenario generator's."""
        ctx = super().forecast_ctx(x, strategy_state, t)
        if self.scenarios > 1:
            horizons = sample_scenarios(self.strategy, strategy_state, self.scenario_generator, self.scenarios,
                                        draws=draws)
            ctx = ctx._replace(wrench_horizon=horizons.to(self.dtype))
        return ctx

    def controller_update(self, planner_state, x, strategy_state, t, draws=None, noise_override=None):
        ctx = self.forecast_ctx(x, strategy_state, t, draws)
        new_state, _ = self.planner.update(planner_state, x, t, ctx, noise_override=noise_override)
        return new_state

    def advance(self, x, planner_state, strategy_state, pid_state, t0, observation_noise=None):
        """One 50 ms control period of 200 Hz simulation (sim/episode.py
        tick semantics): PID wrench toward the circle, NOISY observation
        into the Kalman filter, interpolated control, plant step. Returns
        (x, strategy state, PID state, per-tick force magnitude, per-tick
        squared tracking error). ``observation_noise`` (ticks, 6): N(0, 1)
        draws scaled by sigma by default, from the observation generator."""
        if observation_noise is None:
            observation_noise = self.sigma * torch.randn(
                (self.per_period, 6), generator=self.observation_generator, dtype=self.dtype, device=self.device)
        kp, kd = constant(self._kp, x), constant(self._kd, x)
        torque = constant(np.zeros(3), x)
        forces, errors = [], []
        for k in range(self.per_period):
            t = t0 + self._offsets[k]
            aux = fr.derive_aux(self.model, x)
            reference = self.trajectory.position(t).to(self.dtype)
            pid_state = self.pid.set_reference(pid_state, reference)
            pid_state = self.pid.update(pid_state, aux.ee_position, t)
            wrench = torch.cat([pid_state.control, torque])
            strategy_state = self.strategy.update(strategy_state, wrench + observation_noise[k], t)
            u = self.planner.get(planner_state, t)
            x = fr.integrate_with_wrench(self.model, kp, kd, x, u, aux, wrench, SIM_DT)
            error = aux.ee_position - reference
            forces.append(torch.linalg.norm(pid_state.control))
            errors.append(torch.sum(error * error))
        return x, strategy_state, pid_state, torch.stack(forces), torch.stack(errors)

    def seed_period(self, key):
        """Split the period's key words off ``key`` and seed the scenario
        and observation generators from them; returns the next key."""
        key, scenario_seed = split_key(key)
        key, observation_seed = split_key(key)
        self.scenario_generator.manual_seed(seed_bits(scenario_seed))
        self.observation_generator.manual_seed(seed_bits(observation_seed))
        return key


def episode(loop: ScenarioLoop, seed: int, periods: int) -> dict:
    """One closed-loop episode; on the card the first period eager, the
    rest replays of ``loop``'s captured update and ticks. Returns the mean
    force, the RMSE and the update-rollout launches (kernel 2)."""
    cuda = loop.device.type == "cuda"
    rate = loop.configuration.controller_rate
    state = loop.init(seed)
    key = key_from_seed(seed + 7777)
    captured = None
    forces, errors = [], []
    for i in range(periods):
        key = loop.seed_period(key)
        if captured is None:
            t = loop.time(i)
            planner_state = loop.controller_update(state.planner_state, state.x, state.strategy_state, t)
            x, strategy_state, pid_state, f, e = loop.advance(
                state.x, planner_state, state.strategy_state, state.pid_state, t)
            state = LoopState(x, planner_state, strategy_state, pid_state, t)
            if cuda and i + 1 < periods:
                scenario_generators = (loop.scenario_generator,) if loop.scenarios > 1 else ()
                captured = CapturedLoop(loop, state, scenario_generators, (loop.observation_generator,))
        else:
            captured.update(i * rate)
            f, e = (value.clone() for value in captured.advance())
        forces.append(f)
        errors.append(e)
    state = captured.state() if captured is not None else state
    forces = torch.cat(forces).double().cpu().numpy()
    errors = torch.cat(errors).double().cpu().numpy()
    return {
        "mean_force": round(float(forces.mean()), 2),
        "rmse": round(float(np.sqrt(errors.mean())), 4),
        "final_state_finite": bool(torch.isfinite(state.x).all()),
        "captured": captured,
    }


def run_grid(sigmas, counts, seeds, duration: float, device="cuda") -> list:
    """The study's cells: per (sigma, C) the runs of each seed and their
    medians (the middle of the sorted values)."""
    periods = int(duration / 0.05)
    cells = []
    for sigma in sigmas:
        for count in counts:
            loop = ScenarioLoop(count, sigma, device=device)
            runs = {}
            for seed in seeds:
                start = time.perf_counter()
                run = episode(loop, seed, periods)
                if not run.pop("final_state_finite"):
                    raise FloatingPointError(f"sigma {sigma}, C {count}, seed {seed}: the final state is not finite")
                run.pop("captured")
                run["wall_s"] = round(time.perf_counter() - start, 1)
                runs[seed] = run
            forces = sorted(r["mean_force"] for r in runs.values())
            rmses = sorted(r["rmse"] for r in runs.values())
            cell = {
                "obs_noise_sigma": sigma,
                "scenarios": count,
                "median_force": forces[len(forces) // 2],
                "median_rmse": rmses[len(rmses) // 2],
                "runs": runs,
            }
            cells.append(cell)
            print(cell, flush=True)
    return cells


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_scenario_value"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    duration = float(os.environ.get("SV_DURATION", 15.0))
    identity = ex.device_identity(resolve_device(args.device))
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)
    report = {"duration": duration, "trajectory": "circle",
              "cells": run_grid(SIGMAS, SCENARIOS, SEEDS, duration, args.device), **identity}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_scenario_value.json")
    with open(path, "w") as handle:
        json.dump(report, handle, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

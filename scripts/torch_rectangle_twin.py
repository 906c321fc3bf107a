"""The assisted rectangle with the float64 reference-pipeline replayer as
its controller, on the port.

The port of scripts/rectangle_twin.py. The replayer
(``parity.ReferenceTrajectoryReplayer``: serial mt19937 column draws on the
host, the elite sort, float64 scalar-cost accumulation, the
MovingExtendedWindow SG filter; the reference's own pipeline semantics) is
the closed-loop controller of the rectangle episode:

- plant: the host plant step with the human's wrench (the next state of
  ``fr.make_plant_step``, the plant the episode engine integrates, without
  the accelerations it logs). As in the JAX script, the human's next PID
  tick sees the EE position the step returns, which is the pre-step
  state's;
- human: the HUMAN_POINT_CONTROL PID toward the rectangle
  (external_wrench.cpp:185-231);
- forecast: the order-1 Kalman forecast of the wrench, its nodes at the
  rollout times in a ``ForecastContext`` per update (the kalman_1 matrix
  cell's configuration); unassisted runs give the planner a zero wrench;
- the replayer's rollout and filter re-rollout: one batched float64 pass of
  the port's plant per update (``Twin``) in place of its serial loops (the
  JAX script's two jitted scans). Per rollout the step order and the
  float64 accumulation are the serial ones: the reference's rollout loop
  has no cross-rollout arithmetic (mppi.cpp:309-342). On the card each pass
  is one CUDA graph, captured at the first update and replayed after.

No rollout kernel runs: the kernels are float32 and the twin is float64.
The draws are the host's, so the twin is deterministic: on the CPU it
follows the JAX twin to float64 rounding.

Usage:
    python3 scripts/torch_rectangle_twin.py [--device cuda|cpu] [--duration 15]
        [--seeds 0,1,2] [--out DIR]

Writes ``torch_rectangle_twin.json`` under ``--out`` only (default
build/torch_rectangle_twin): the JAX script's keys (the assisted and
unassisted medians beside the matrix's) plus ``device`` and
``power_limit``.
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

from assistedmanipulation_tpu_torch import graphs, resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.forecast import forecast as fc  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402
from assistedmanipulation_tpu_torch.mppi import BARRIER_SCALE  # noqa: E402
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (  # noqa: E402
    AssistedManipulation,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parity import ReferenceTrajectoryReplayer, ReplayerConfig  # noqa: E402
from assistedmanipulation_tpu_torch.sim import pid as pid_module  # noqa: E402
from assistedmanipulation_tpu_torch.sim import trajectories  # noqa: E402

import scripts.torch_experiments as ex  # noqa: E402

STEPS, DT, HORIZON = 30, 0.01, 0.3
NODES = STEPS + 1  # forecast nodes of a 0.3 s horizon at dt 0.01
SIM_DT, CONTROL_PERIOD = 0.005, 0.05
DTYPE = torch.float64


class Twin:
    """The replayer's batched rollout and filter re-rollout on ``device``
    at float64: ``rollout(noise (R, D, S), optimal (D, S), x0, t0, wrench
    (NODES, 6), start) -> (R,) cost totals`` and ``filter(optimal, x0, t0,
    wrench, start) -> total``. With ``capture`` (the default on the card)
    each is one CUDA graph on static inputs, captured at its first call."""

    def __init__(self, rollouts: int, dof: int, device, capture=None):
        self.device = device
        self.plant = fr.make_plant(AssistedManipulation())
        self.capture = device.type == "cuda" if capture is None else capture
        self._steps = torch.arange(STEPS, dtype=DTYPE, device=device)
        self._inputs = {
            "noise": torch.zeros((rollouts, dof, STEPS), dtype=DTYPE, device=device),
            "optimal": torch.zeros((dof, STEPS), dtype=DTYPE, device=device),
            "x0": torch.zeros(fr.DoF.STATE, dtype=DTYPE, device=device),
            "t0": torch.zeros((), dtype=DTYPE, device=device),
            "wrench": torch.zeros((NODES, 6), dtype=DTYPE, device=device),
            "start": torch.zeros((), dtype=DTYPE, device=device),
        }
        self._graphs = {}

    def _totals(self, controls: torch.Tensor) -> torch.Tensor:
        """Cost totals of ``controls`` (S, ..., D) from x0: per step derive,
        the composed scalar cost added in float64 (NaN propagates), then
        integrate."""
        i = self._inputs
        ctx = ForecastContext(wrench_horizon=i["wrench"], start_time=i["start"], time_step=DT, horizon=HORIZON)
        x = i["x0"].expand(*controls.shape[1:-1], -1)
        total = torch.zeros(controls.shape[1:-1], dtype=DTYPE, device=self.device)
        for s in range(STEPS):
            t = i["t0"] + self._steps[s] * DT
            u = controls[s]
            aux = self.plant.derive(x, t, ctx)
            cost = self.plant.cost(x, u, aux, t, ctx)
            total = total + (cost[..., 0] * BARRIER_SCALE + cost[..., 1])
            x = self.plant.integrate(x, u, aux, t, DT, ctx)
        return total

    def _rollout(self) -> torch.Tensor:
        i = self._inputs
        return self._totals((i["optimal"][None] + i["noise"]).permute(2, 0, 1))

    def _filter(self) -> torch.Tensor:
        return self._totals(self._inputs["optimal"].T)

    def _run(self, name: str, fn, values: dict) -> np.ndarray:
        for key, value in values.items():
            self._inputs[key].copy_(torch.as_tensor(np.asarray(value, np.float64)))
        if not self.capture:
            return fn().cpu().numpy()
        if name not in self._graphs:
            fn()  # the first call of anything is eager (workspaces, constants)
            self._graphs[name] = graphs.CapturedGraph(fn, (), ())
        return self._graphs[name].replay().cpu().numpy()

    def rollout(self, noise, optimal, x0, t0, wrench, start) -> np.ndarray:
        return self._run("rollout", self._rollout, dict(noise=noise, optimal=optimal, x0=x0, t0=t0, wrench=wrench,
                                                        start=start))

    def filter(self, optimal, x0, t0, wrench, start) -> float:
        return float(self._run("filter", self._filter, dict(optimal=optimal, x0=x0, t0=t0, wrench=wrench,
                                                            start=start)))


def replayer_configuration() -> ReplayerConfig:
    """The matrix's planner (scripts/torch_experiments.mppi_configuration)
    in the replayer's terms."""
    return ReplayerConfig(
        rollouts=50,
        keep_best_rollouts=20,
        time_step=DT,
        horizon=HORIZON,
        gradient_step=2.0,
        cost_scale=10.0,
        cost_discount_factor=1.0,
        covariance=np.diag(np.asarray(fr.DEFAULT_COVARIANCE)),
        control_min=np.asarray(fr.DEFAULT_CONTROL_MIN, np.float64),
        control_max=np.asarray(fr.DEFAULT_CONTROL_MAX, np.float64),
        smoothing_window=10,
        smoothing_order=1,
    )


class BatchedReplayer(ReferenceTrajectoryReplayer):
    """The serial replayer with its rollout and filter loops replaced by one
    float64 batch per update on ``twin``, scored against ``current``'s
    forecast (``wrench`` (NODES, 6), ``start``). The serial mt19937 draws
    and the serial likelihood and gradient sums stay the parent's."""

    def __init__(self, twin: Twin, current: dict, seed: int):
        def unused(*args):
            raise AssertionError("the batched passes replace the serial step and cost")

        super().__init__(replayer_configuration(), unused, unused, seed=seed)
        self.twin, self.current = twin, current

    def _rollout(self):
        self.costs[:] = self.twin.rollout(self.noise, self.optimal_control_shifted, self.rollout_state,
                                          self.rollout_time, self.current["wrench"], self.current["start"])

    def _filter(self):
        self.optimal_cost = self.twin.filter(self.optimal_control_shifted, self.rollout_state, self.rollout_time,
                                             self.current["wrench"], self.current["start"])


def run_episode(seed: int, duration: float, assisted: bool = True, device="cuda", capture=None, trace: bool = False):
    """One closed-loop rectangle episode. Returns its summary (seed, mean
    and max force, wall); with ``trace`` also the per-tick EE positions and
    force magnitudes (``ee``, ``forces``)."""
    device = resolve_device(device)
    strategy = fc.KalmanForecast(
        fc.KalmanForecastConfiguration(observed_states=6, order=1, time_step=DT, horizon=HORIZON)
    )
    current = {"wrench": np.zeros((NODES, 6)), "start": 0.0}
    twin = Twin(replayer_configuration().rollouts + 2, fr.DoF.CONTROL, device, capture)
    replayer = BatchedReplayer(twin, current, seed)
    model = frankaridgeback_model()
    _, kp, kd = fr.Configuration().resolve()
    kp, kd = (torch.as_tensor(np.asarray(gain), dtype=DTYPE, device=device) for gain in (kp, kd))

    def plant_step(x, u, wrench, dt):
        """``fr.make_plant_step``'s next state and pre-step EE position,
        without the logged accelerations and power it also computes."""
        aux = fr.derive_aux(model, x)
        return fr.integrate_with_wrench(model, kp, kd, x, u, aux, wrench, dt), aux.ee_position

    trajectory = trajectories.RectangularTrajectory(trajectories.RectangularConfiguration())
    pid = pid_module.PID(pid_module.HUMAN_POINT_CONTROL)
    pid_state = pid.init(DTYPE, device)
    strategy_state = strategy.init(DTYPE, device)
    node_offsets = torch.arange(STEPS, dtype=DTYPE, device=device) * DT

    def tensor(value):
        return torch.as_tensor(value, dtype=DTYPE, device=device)

    x = np.asarray(fr.Configuration().resolve()[0], np.float64)
    ee_position = fr.derive_aux(model, tensor(x)).ee_position
    ticks = int(round(duration / SIM_DT))
    countdown = 0
    forces, ee_trace = [], []
    wall = time.perf_counter()
    for k in range(ticks):
        t = k * SIM_DT
        time_k = tensor(float(t))
        pid_state = pid.set_reference(pid_state, trajectory.position(time_k).to(DTYPE))
        pid_state = pid.update(pid_state, ee_position, time_k)
        wrench = torch.cat([pid_state.control, torch.zeros(3, dtype=DTYPE, device=device)])
        force = pid_state.control.cpu().numpy()
        forces.append(float(np.linalg.norm(force)))
        strategy_state = strategy.update(strategy_state, wrench, time_k)

        countdown -= 1
        if countdown <= 0:
            countdown = int(round(CONTROL_PERIOD / SIM_DT))
            if assisted:
                nodes = torch.stack([strategy.forecast(strategy_state, time_k + dt) for dt in node_offsets])
                current["wrench"] = torch.cat([nodes, nodes[-1:]]).cpu().numpy()
            else:
                # Unassisted: no forecast reaches the planner; the
                # assistance term is inactive on a zero wrench
                # (assisted_manipulation.cpp:237-240).
                current["wrench"] = np.zeros((NODES, 6))
            current["start"] = float(t)
            replayer.update(x, t)

        control = replayer.get(t)
        x_next, ee_position = plant_step(tensor(x), tensor(control), wrench, SIM_DT)
        x = x_next.cpu().numpy()
        if trace:
            ee_trace.append(ee_position.cpu().numpy())
        if k % 200 == 0:
            print(f"seed {seed} t={t:5.2f}s mean|F| so far {np.mean(forces):6.2f} N "
                  f"({time.perf_counter() - wall:.0f}s)", flush=True)
        if not np.isfinite(x).all():
            raise RuntimeError(f"NaN state at t={t}")

    forces = np.asarray(forces)
    out = {
        "seed": seed,
        "mean_force": float(forces.mean()),
        "max_force": float(forces.max()),
        "wall_s": round(time.perf_counter() - wall, 1),
    }
    if trace:
        out.update(ee=np.asarray(ee_trace), forces=forces)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--duration", type=float, default=15.0)
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_rectangle_twin"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    identity = ex.device_identity(device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)

    seeds = [int(s) for s in args.seeds.split(",")]
    cells = [run_episode(s, args.duration, True, device) for s in seeds]
    unassisted = [run_episode(s, args.duration, False, device) for s in seeds]
    result = {
        "metric": "rectangle_twin_mean_force",
        "controller": "float64 reference-pipeline replayer (parity.py), closed loop on the rectangle",
        "duration": args.duration,
        "cells": cells,
        "median_mean_force": float(np.median([c["mean_force"] for c in cells])),
        "unassisted_cells": unassisted,
        "unassisted_median_mean_force": float(np.median([c["mean_force"] for c in unassisted])),
        "engine_assisted_rectangle_range": [19.3, 21.7],
        "reference_assisted_rectangle_range": [15.5, 16.7],
        "unassisted_rectangle": {"engine": 34.74, "reference": 34.17},
        **identity,
    }
    print(json.dumps(result), flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "torch_rectangle_twin.json")
    with open(path, "w") as handle:
        json.dump(result, handle, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

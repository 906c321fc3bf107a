"""Realtime budget check on the port: does one controller update fit its
50 ms slot?

The port of scripts/realtime_check.py. The reference's host loop runs the
simulator at 200 Hz with the controller updating every 50 ms
(base.cpp:150-163 + the 20 Hz controller rate, base.hpp:150); the implied
realtime contract is that one MPPI update fits inside its 50 ms slot. This
script runs the circle scenario closed-loop at the reference problem size
(the port's ``sim.actor.Configuration()``: 50 + 2 rollouts, a 30-step
horizon, the order-1 Kalman wrench forecast) and measures the wall-clock
latency of every controller update: the dynamics forecast and the planner
update, synchronised, the work the 50 ms slot must absorb.

The inter-update simulation (10 ticks at 200 Hz: human PID wrench, forecast
observation, control query, plant step) is not part of the contract. On
the card the update and the 10 ticks are each one CUDA graph
(``graphs.CapturedGraph``) on one set of static buffers: the first period
runs eagerly (its update is ``first_update_ms``, as the JAX script's first
update holds its compile), then both are captured and each further period
replays them.

Deadline accounting: every update over the 50 ms slot is a DEADLINE MISS
(the reference's raisim::TimedLoop would drop the tick, base.cpp:157). The
latency splits into host dispatch (loading the time, splitting the key,
the replay call) and block (the synchronise); Python GC collections
overlapping the update are flagged, and each miss is attributed to a host
GC, a host dispatch stall or the device.

Writes realtime.json into ``--out`` (default build/torch_realtime_check):
the JAX script's keys plus ``device`` and ``power_limit``. ``ok`` requires
p99 < 50 ms AND miss rate <= 1% AND max < 200 ms AND a finite final state;
the exit code is 1 when it is false.

Usage: python scripts/torch_realtime_check.py [--duration 60] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from assistedmanipulation_tpu_torch import graphs, mppi, resolve_device  # noqa: E402
from assistedmanipulation_tpu_torch.forecast import forecast as fc  # noqa: E402
from assistedmanipulation_tpu_torch.forecast.dynamics_forecast import (  # noqa: E402
    Configuration as DynamicsForecastConfiguration,
    DynamicsForecast,
)
from assistedmanipulation_tpu_torch.kernels.philox import split_key  # noqa: E402
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr  # noqa: E402
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model  # noqa: E402
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation  # noqa: E402
from assistedmanipulation_tpu_torch.ops import constant  # noqa: E402
from assistedmanipulation_tpu_torch.sim import pid as pid_module  # noqa: E402
from assistedmanipulation_tpu_torch.sim import trajectories  # noqa: E402
from assistedmanipulation_tpu_torch.sim.actor import Configuration  # noqa: E402

from scripts.torch_experiments import device_identity  # noqa: E402

BUDGET_S = 0.050
MAX_BUDGET_S = 0.200  # catastrophic-stall gate (4x slot)
MISS_RATE_LIMIT = 0.01
SIM_DT = 0.005


class LoopState(NamedTuple):
    """What the closed loop carries from period to period; ``t`` is the
    period's start (its update's time)."""

    x: torch.Tensor
    planner_state: mppi.PlannerState
    strategy_state: object
    pid_state: pid_module.PIDState
    t: torch.Tensor


class RealtimeLoop:
    """The closed loop of the check: ``controller_update`` and ``advance``
    are the JAX script's two local functions (realtime_check.py:113-150)
    on ``device`` (the card unless the caller asks for the CPU), at the
    planner's dtype. ``strategy`` replaces the configuration's wrench
    forecast, ``rollout_fn`` the plant rollout of the planner's batch
    (scripts/torch_scenario_value.py passes both)."""

    def __init__(self, configuration: Optional[Configuration] = None, device="cuda", strategy=None,
                 rollout_fn=None):
        configuration = configuration or Configuration()
        self.configuration = configuration
        self.device = resolve_device(device)
        self.model = frankaridgeback_model()
        robot = configuration.dynamics
        self._initial, self._kp, self._kd = robot.resolve()
        objective = AssistedManipulation(configuration.objective.assisted_manipulation)
        plant = fr.make_plant(objective, robot, self.model)
        self.planner = mppi.Planner(configuration.mppi, plant, device=self.device, rollout_fn=rollout_fn)
        self.dtype = self.planner.dtype
        fcfg = configuration.forecast.configuration
        self.strategy = strategy or fc.create(configuration.forecast.end_effector_wrench_forecast)
        self.forecaster = DynamicsForecast(
            DynamicsForecastConfiguration(time_step=fcfg.time_step, horizon=fcfg.horizon), robot, self.model
        )
        self.trajectory = trajectories.CircularTrajectory(trajectories.CircularConfiguration())
        self.pid = pid_module.PID(pid_module.HUMAN_POINT_CONTROL)
        self.per_period = int(round(configuration.controller_rate / SIM_DT))
        # The ticks' offsets from the period's start, k * dt in the dtype.
        self._offsets = torch.arange(self.per_period, dtype=self.dtype, device=self.device) * SIM_DT

    def init(self, seed: int = 0) -> LoopState:
        return LoopState(
            x=torch.as_tensor(np.asarray(self._initial), dtype=self.dtype).to(self.device),
            planner_state=self.planner.init(seed=seed),
            strategy_state=self.strategy.init(self.dtype, self.device),
            pid_state=self.pid.init(self.dtype, self.device),
            t=torch.zeros((), dtype=self.dtype, device=self.device),
        )

    def time(self, update: int) -> torch.Tensor:
        """The time of update ``update``, as the JAX script makes it."""
        return torch.tensor(update * self.configuration.controller_rate, dtype=self.dtype, device=self.device)

    def forecast_ctx(self, x, strategy_state, t):
        """The wrench horizon forecast from the current state
        (actor.cpp:172-192): the planner's forecast context."""
        _, ctx = self.forecaster.forecast(x, t, lambda tq: self.strategy.forecast(strategy_state, tq))
        return ctx

    def controller_update(self, planner_state, x, strategy_state, t, noise_override=None):
        """The measured 50 ms-slot work: forecast the wrench horizon, then
        one MPPI update. ``noise_override``: the planner's parity hook."""
        ctx = self.forecast_ctx(x, strategy_state, t)
        new_state, _ = self.planner.update(planner_state, x, t, ctx, noise_override=noise_override)
        return new_state

    def advance(self, x, planner_state, strategy_state, pid_state, t0):
        """One control period of 200 Hz simulation (sim/episode.py tick
        semantics, minus the controller update): human PID wrench toward
        the circle reference, forecast observation, interpolated control
        query, plant step with the applied wrench."""
        kp, kd = constant(self._kp, x), constant(self._kd, x)
        torque = constant(np.zeros(3), x)
        for k in range(self.per_period):
            t = t0 + self._offsets[k]
            aux = fr.derive_aux(self.model, x)
            reference = self.trajectory.position(t).to(self.dtype)
            pid_state = self.pid.set_reference(pid_state, reference)
            pid_state = self.pid.update(pid_state, aux.ee_position, t)
            wrench = torch.cat([pid_state.control, torque])
            strategy_state = self.strategy.update(strategy_state, wrench, t)
            u = self.planner.get(planner_state, t)
            x, _, _ = fr.integrate_with_wrench_extras(self.model, kp, kd, x, u, aux, wrench, SIM_DT)
        return x, strategy_state, pid_state


class CapturedLoop:
    """A RealtimeLoop's update and advance as two CUDA graphs on one set of
    static buffers (``LoopState``), captured from ``state``; run the loop
    eagerly once before (the capture must not be the first call of
    anything). ``update(t)`` loads the time, splits the planner's key on
    the host, reseeds the sampler and replays the update graph;
    ``advance()`` replays the 10 ticks and returns what ``advance``
    returns past the carry, rewritten in place by the next replay.
    ``update_generators`` and ``advance_generators``: the generators each
    draws from besides the sampler's, registered with its graph (the
    caller seeds them before a replay). Captured and eager are bitwise
    equal."""

    def __init__(self, loop: RealtimeLoop, state: LoopState, update_generators=(), advance_generators=()):
        graphs.require_cuda(loop.device, "CapturedLoop")
        self.loop = loop
        self.static = static = graphs.static_copy(state)
        self.rng = state.planner_state.rng
        generators, host_inputs = loop.planner.sampler.graph_rng()

        def update_body():
            ctx = loop.forecast_ctx(static.x, static.strategy_state, static.t)
            new_state, _ = loop.planner.device_update(static.planner_state, static.x, static.t, ctx,
                                                      graphs.GRAPH_SEED)
            graphs.write_back(static.planner_state, new_state)

        def advance_body():
            x, strategy_state, pid_state, *outputs = loop.advance(
                static.x, static.planner_state, static.strategy_state, static.pid_state, static.t
            )
            graphs.write_back(static.x, x)
            graphs.write_back(static.strategy_state, strategy_state)
            graphs.write_back(static.pid_state, pid_state)
            return outputs

        self.update_graph = graphs.CapturedGraph(update_body, (*update_generators, *generators), host_inputs)
        self.advance_graph = graphs.CapturedGraph(advance_body, advance_generators)

    def update(self, t: float) -> None:
        self.static.t.fill_(t)
        self.rng, seed = split_key(self.rng)
        self.loop.planner.sampler.seed_replay(seed)
        self.update_graph.replay()

    def advance(self) -> list:
        return self.advance_graph.replay()

    def state(self) -> LoopState:
        """The loop's state now (the static buffers, the key on the host)."""
        static = self.static
        return static._replace(planner_state=static.planner_state._replace(rng=self.rng))


def run(loop: RealtimeLoop, updates: int, seed: int = 0) -> dict:
    """``updates`` closed-loop periods, each update timed: returns the
    latencies, their dispatch and block parts, their starts, the GC
    collections seen, the final state and (on the card) the captured loop."""
    cuda = loop.device.type == "cuda"
    rate = loop.configuration.controller_rate

    def synchronize():
        if cuda:
            torch.cuda.synchronize(loop.device)

    # GC observation: flag updates a collection overlapped (host-stall
    # attribution; gen-2 collections run milliseconds).
    gc_spans = []
    gc_start = [None]

    def gc_callback(phase, info):
        now = time.perf_counter()
        if phase == "start":
            gc_start[0] = now
        elif gc_start[0] is not None:
            gc_spans.append((gc_start[0], now, info.get("generation")))
            gc_start[0] = None

    state = loop.init(seed)
    captured, capture_s = None, None
    latencies, dispatch_times, block_times, starts = [], [], [], []
    gc.callbacks.append(gc_callback)
    wall0 = time.perf_counter()
    try:
        for i in range(updates):
            start = time.perf_counter()
            if captured is None:
                t = loop.time(i)
                planner_state = loop.controller_update(state.planner_state, state.x, state.strategy_state, t)
            else:
                captured.update(i * rate)
            dispatched = time.perf_counter()
            synchronize()
            end = time.perf_counter()
            starts.append(start)
            latencies.append(end - start)
            dispatch_times.append(dispatched - start)
            block_times.append(end - dispatched)
            if captured is None:
                x, strategy_state, pid_state = loop.advance(
                    state.x, planner_state, state.strategy_state, state.pid_state, t)
                state = LoopState(x, planner_state, strategy_state, pid_state, t)
                if cuda and i + 1 < updates:
                    t0 = time.perf_counter()
                    captured = CapturedLoop(loop, state)
                    capture_s = time.perf_counter() - t0
            else:
                captured.advance()
        synchronize()
    finally:
        gc.callbacks.remove(gc_callback)
    if captured is not None:
        state = captured.state()
    return {
        "latencies": latencies, "dispatch": dispatch_times, "block": block_times, "starts": starts,
        "wall0": wall0, "gc_spans": gc_spans, "state": state, "captured": captured, "capture_s": capture_s,
    }


def report(loop: RealtimeLoop, result: dict, duration: float, identity: dict) -> dict:
    """The JAX script's realtime.json from a run (first update skipped)."""
    latencies = result["latencies"]
    steady = np.asarray(latencies[1:])
    edges = [0.0, 0.005, 0.010, 0.020, 0.030, 0.040, 0.050, 0.100, np.inf]
    histogram, _ = np.histogram(steady, bins=edges)

    # Deadline misses with per-miss attribution.
    misses = []
    for i in range(1, len(latencies)):
        if latencies[i] < BUDGET_S:
            continue
        s, e = result["starts"][i], result["starts"][i] + latencies[i]
        gc_during = [gen for (g0, g1, gen) in result["gc_spans"] if g0 < e and g1 > s]
        dispatch_ms = result["dispatch"][i] * 1e3
        block_ms = result["block"][i] * 1e3
        if gc_during and dispatch_ms > block_ms:
            cause = f"host GC (gen {max(gc_during)}) during dispatch"
        elif dispatch_ms > block_ms:
            cause = "host dispatch stall (Python/load/replay call)"
        else:
            cause = "device-side (the replay's device work)"
        misses.append({
            "update": i,
            "wall_offset_s": round(result["starts"][i] - result["wall0"], 2),
            "latency_ms": round(latencies[i] * 1e3, 2),
            "dispatch_ms": round(dispatch_ms, 2),
            "block_ms": round(block_ms, 2),
            "gc_generations_overlapping": gc_during,
            "attribution": cause,
        })

    x = result["state"].x
    out = {
        "platform": loop.device.type,
        **identity,
        "updates": int(steady.size),
        "duration_s": duration,
        "rollouts": loop.planner.rollout_count,
        "steps": loop.planner.steps,
        "controller_period_s": loop.configuration.controller_rate,
        "budget_s": BUDGET_S,
        "p50_ms": round(float(np.percentile(steady, 50)) * 1e3, 3),
        "p90_ms": round(float(np.percentile(steady, 90)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(steady, 99)) * 1e3, 3),
        "max_ms": round(float(steady.max()) * 1e3, 3),
        "first_update_ms": round(latencies[0] * 1e3, 1),
        "histogram_edges_s": edges[:-1] + ["inf"],
        "histogram_counts": histogram.tolist(),
        "deadline_misses": len(misses),
        "miss_rate": round(len(misses) / max(1, steady.size), 5),
        "misses": misses,
        "gc_collections_observed": len(result["gc_spans"]),
        "final_state_finite": bool(torch.isfinite(x).all()),
    }
    out["ok"] = (
        out["p99_ms"] < BUDGET_S * 1e3
        and out["miss_rate"] <= MISS_RATE_LIMIT
        and out["max_ms"] < MAX_BUDGET_S * 1e3
        and out["final_state_finite"]
    )
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "torch_realtime_check"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    loop = RealtimeLoop(device=args.device)
    identity = device_identity(loop.device)
    print(f"device: {identity['device']}, power limit {identity['power_limit']}", flush=True)
    updates = int(args.duration / loop.configuration.controller_rate)
    result = run(loop, updates)
    out = report(loop, result, args.duration, identity)
    if result["capture_s"] is not None:
        out["capture_s"] = round(result["capture_s"], 3)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "realtime.json")
    with open(path, "w") as handle:
        json.dump(out, handle, indent=1)
    print(json.dumps(out, indent=1), flush=True)
    print(f"wrote {path}; ok={out['ok']}", flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

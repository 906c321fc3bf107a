"""scripts/torch_realtime_check.py against the JAX package, at float64 on
the CPU.

Two periods of the script's ``controller_update`` and ``advance`` (at 10
rollouts, keep-best 4, a 0.1 s horizon) against a test-side restatement of
the JAX script's two local functions (scripts/realtime_check.py:113-150),
built from JAX package modules. Both start from the JAX loop's initial
state (carried across with ``interop``) and get the same sampled noise:
the JAX update through its planner's ``noise_override``, the port's
through its own. Then a short ``main`` on the CPU writes realtime.json
with the JAX file's keys.

Tolerance: |port - jax| <= 1e-8 * max(|jax|, 1) for the plant state, the
planner's published sequence and the forecast and PID states.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu.forecast import forecast as jax_fc
from assistedmanipulation_tpu.forecast.dynamics_forecast import (
    Configuration as JaxDynamicsForecastConfiguration,
    DynamicsForecast as JaxDynamicsForecast,
)
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import AssistedManipulation as JaxObjective
from assistedmanipulation_tpu.sim import pid as jax_pid
from assistedmanipulation_tpu.sim import trajectories as jax_trajectories
from assistedmanipulation_tpu.sim.actor import Configuration as JaxConfiguration
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.sim.actor import Configuration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.torch_realtime_check as rt  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8
ROLLOUTS, KEEP, HORIZON = 10, 4, 0.1
PERIODS = 2
SIM_DT = 0.005


def close(port, want, what):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    err = np.abs(port - want)
    assert (err <= TOL * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


def small(configuration):
    return dataclasses.replace(
        configuration, mppi=dataclasses.replace(
            configuration.mppi, rollouts=ROLLOUTS, keep_best_rollouts=KEEP, horizon=HORIZON, dtype="float64"))


class JaxLoop:
    """The JAX script's set-up and its two local functions, at ``configuration``."""

    def __init__(self, configuration):
        self.dtype = dtype = jnp.float64
        model = jax_model()
        robot = configuration.dynamics
        self.initial, kp_np, kd_np = robot.resolve()
        objective = JaxObjective(configuration.objective.assisted_manipulation)
        self.planner = jax_mppi.Planner(configuration.mppi, jax_fr.make_plant(objective, robot, model))
        fcfg = configuration.forecast.configuration
        self.strategy = jax_fc.create(configuration.forecast.end_effector_wrench_forecast)
        self.forecaster = JaxDynamicsForecast(
            JaxDynamicsForecastConfiguration(time_step=fcfg.time_step, horizon=fcfg.horizon), robot, model)
        trajectory = jax_trajectories.CircularTrajectory(jax_trajectories.CircularConfiguration())
        self.pid = pid = jax_pid.PID(jax_pid.HUMAN_POINT_CONTROL)
        kp, kd = jnp.asarray(kp_np, dtype), jnp.asarray(kd_np, dtype)
        per_period = int(round(configuration.controller_rate / SIM_DT))
        planner, strategy = self.planner, self.strategy

        def advance(x, planner_state, strategy_state, pid_state, t0):
            def tick(carry, k):
                x, strategy_state, pid_state = carry
                t = t0 + k.astype(dtype) * SIM_DT
                aux = jax_fr.derive_aux(model, x)
                reference = trajectory.position(t).astype(dtype)
                pid_state = pid.set_reference(pid_state, reference)
                pid_state = pid.update(pid_state, aux.ee_position, t)
                wrench = jnp.concatenate([pid_state.control, jnp.zeros(3, dtype=dtype)])
                strategy_state = strategy.update(strategy_state, wrench, t)
                u = planner._get_impl(planner_state, t)
                x_next, _, _ = jax_fr.integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, dt=SIM_DT)
                return (x_next, strategy_state, pid_state), None

            (x, strategy_state, pid_state), _ = jax.lax.scan(
                tick, (x, strategy_state, pid_state), jnp.arange(per_period, dtype=jnp.int32))
            return x, strategy_state, pid_state

        def controller_update(planner_state, x, strategy_state, t, noise):
            _, ctx = self.forecaster.forecast(x, t, lambda tq: strategy.forecast(strategy_state, tq))
            new_state, _ = planner._update_impl(planner_state, x, t, ctx, noise_override=noise)
            return new_state

        self.advance = jax.jit(advance)
        self.controller_update = jax.jit(controller_update)


def test_loop_matches_jax():
    jax_loop = JaxLoop(small(JaxConfiguration()))
    loop = rt.RealtimeLoop(small(Configuration()), device="cpu")
    assert loop.per_period == 10 and loop.planner.steps == jax_loop.planner.steps == 10
    x = jnp.asarray(jax_loop.initial, jnp.float64)
    planner_state = jax_loop.planner.init(seed=0)
    strategy_state = jax_loop.strategy.init(jnp.float64)
    pid_state = jax_loop.pid.init(dtype=jnp.float64)
    host = jax.tree.map(np.asarray, (planner_state, strategy_state, pid_state))
    port = rt.LoopState(
        x=torch.tensor(np.asarray(x)),
        planner_state=interop.planner_state_from_numpy(host[0], loop.planner.rollout_count, "cpu", torch.float64),
        strategy_state=interop.forecast_state_from_numpy(host[1], "cpu", torch.float64),
        pid_state=interop.pid_state_from_numpy(host[2], "cpu", torch.float64),
        t=torch.zeros((), dtype=torch.float64),
    )
    scale = np.sqrt(np.asarray(Configuration().mppi.covariance))
    noise = np.random.default_rng(5).standard_normal((PERIODS, ROLLOUTS, loop.planner.steps, 12)) * scale
    for i in range(PERIODS):
        t = jnp.asarray(i * 0.05, jnp.float64)
        planner_state = jax_loop.controller_update(planner_state, x, strategy_state, t, jnp.asarray(noise[i]))
        x, strategy_state, pid_state = jax_loop.advance(x, planner_state, strategy_state, pid_state, t)

        port_t = loop.time(i)
        port_planner = loop.controller_update(port.planner_state, port.x, port.strategy_state, port_t,
                                              noise_override=noise[i])
        port_x, port_strategy, port_pid = loop.advance(port.x, port_planner, port.strategy_state, port.pid_state,
                                                       port_t)
        port = rt.LoopState(port_x, port_planner, port_strategy, port_pid, port_t)

        close(port_planner.optimal_control, planner_state.optimal_control, f"period {i}: optimal_control")
        close(port_planner.costs, planner_state.costs, f"period {i}: costs")
        close(port_x, x, f"period {i}: x")
        want = interop.forecast_state_to_numpy(
            interop.forecast_state_from_numpy(jax.tree.map(np.asarray, strategy_state), "cpu"))
        got = interop.forecast_state_to_numpy(port_strategy)
        for name in ("measurement", "prediction", "last_update"):
            close(got[name], want[name], f"period {i}: forecast {name}")
        close(got["filter"]["state"], want["filter"]["state"], f"period {i}: filter state")
        for field in port_pid._fields:
            close(getattr(port_pid, field).double(), np.asarray(getattr(pid_state, field), np.float64),
                  f"period {i}: pid {field}")


def test_main_writes_the_jax_keys(tmp_path):
    assert rt.main(["--duration", "0.15", "--device", "cpu", "--out", str(tmp_path)]) in (0, 1)
    report = json.load(open(tmp_path / "realtime.json"))
    jax_keys = set(json.load(open(os.path.join(ROOT, "realtime.json"))))
    assert set(report) == jax_keys | {"device", "power_limit"}
    # int(0.15 / 0.05) = 2 updates, as in the JAX script; the first is not steady.
    assert report["updates"] == 1 and report["rollouts"] == 52 and report["steps"] == 30
    assert report["device"] == "cpu" and report["platform"] == "cpu"
    assert report["final_state_finite"]
    assert sum(report["histogram_counts"]) == 1


def test_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.main(["--duration", "0.1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        rt.CapturedLoop(rt.RealtimeLoop(device="cpu"), None)

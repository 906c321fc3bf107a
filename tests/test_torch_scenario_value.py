"""scripts/torch_scenario_value.py against the JAX package, at float64 on
the CPU.

Two periods of the study's closed loop at sigma = 5 N and C = 4 scenarios
(10 rollouts, keep-best 4, a 0.1 s horizon) against a test-side
restatement of the JAX script's set-up and local functions
(scripts/scenario_value.py:66-170): the planner scores its batch with
``make_scenario_rollout_fn(make_lanes_rollout_fn(...))`` there and with
``make_scenario_rollout_fn(make_cuda_rollout_fn(...))`` (its plain version
on the CPU) here. Both start from the JAX loop's initial state and get the
same sampled noise, scenario draws (the standard normals of the JAX key,
as tests/test_torch_scenarios.py feeds them) and observation noise. Then
a one-cell ``main`` on the CPU writes the JAX file's keys.

Tolerance: |port - jax| <= 1e-8 * max(|jax|, 1) for the plant state, the
planner's costs and published sequence, the Kalman state and the per-tick
force and squared error.
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
from assistedmanipulation_tpu.forecast.scenarios import (
    make_scenario_rollout_fn as jax_make_scenario_rollout_fn,
    sample_scenarios as jax_sample_scenarios,
)
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_rollout_fn
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    AssistedManipulation as JaxObjective,
    Configuration as JaxObjectiveConfiguration,
)
from assistedmanipulation_tpu.sim import pid as jax_pid
from assistedmanipulation_tpu.sim import trajectories as jax_trajectories
from assistedmanipulation_tpu_torch import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.experiments as jax_ex  # noqa: E402
import scripts.torch_experiments as ex  # noqa: E402
import scripts.torch_scenario_value as sv  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8
SIGMA, SCENARIOS = 5.0, 4
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
    return dataclasses.replace(configuration, rollouts=ROLLOUTS, keep_best_rollouts=KEEP, horizon=HORIZON,
                               dtype="float64")


class JaxLoop:
    """The JAX script's set-up and its local functions for one arm."""

    def __init__(self, configuration):
        dtype = jnp.float64
        model = jax_model()
        robot = jax_fr.Configuration()
        self.initial, kp_np, kd_np = robot.resolve()
        kp, kd = jnp.asarray(kp_np, dtype), jnp.asarray(kd_np, dtype)
        lanes_fn = make_lanes_rollout_fn(model, JaxObjectiveConfiguration(), robot, configuration.step_count,
                                         configuration.time_step)
        self.planner = planner = jax_mppi.Planner(
            configuration, jax_fr.make_plant(JaxObjective(), robot, model),
            rollout_fn=jax_make_scenario_rollout_fn(lanes_fn))
        self.strategy = strategy = jax_fc.KalmanForecast(jax_fc.KalmanForecastConfiguration(
            observed_states=6, order=1, time_step=0.01, horizon=0.3,
            observation_variance=max(SIGMA**2, 1e-8), transition_variance=1.0))
        forecaster = JaxDynamicsForecast(JaxDynamicsForecastConfiguration(time_step=0.01, horizon=0.3), robot, model)
        trajectory = jax_trajectories.CircularTrajectory(jax_trajectories.CircularConfiguration())
        self.pid = pid = jax_pid.PID(jax_pid.HUMAN_POINT_CONTROL)

        def advance(x, planner_state, strategy_state, pid_state, t0, obs_noise):
            def tick(carry, inputs):
                x, strategy_state, pid_state = carry
                k, noise_k = inputs
                t = t0 + k.astype(dtype) * SIM_DT
                aux = jax_fr.derive_aux(model, x)
                reference = trajectory.position(t).astype(dtype)
                pid_state = pid.set_reference(pid_state, reference)
                pid_state = pid.update(pid_state, aux.ee_position, t)
                wrench = jnp.concatenate([pid_state.control, jnp.zeros(3, dtype=dtype)])
                strategy_state = strategy.update(strategy_state, wrench + noise_k, t)
                u = planner._get_impl(planner_state, t)
                x_next = jax_fr.integrate_with_wrench(model, kp, kd, x, u, aux, wrench, dt=SIM_DT)
                err = aux.ee_position - reference
                return (x_next, strategy_state, pid_state), (jnp.linalg.norm(pid_state.control), jnp.sum(err * err))

            (x, strategy_state, pid_state), (forces, sqerr) = jax.lax.scan(
                tick, (x, strategy_state, pid_state), (jnp.arange(10, dtype=jnp.int32), obs_noise))
            return x, strategy_state, pid_state, forces, sqerr

        def controller_update(planner_state, x, strategy_state, t, key, noise):
            _, ctx = forecaster.forecast(x, t, lambda tq: strategy.forecast(strategy_state, tq))
            horizons = jax_sample_scenarios(strategy, strategy_state, key, SCENARIOS)
            ctx = ctx._replace(wrench_horizon=horizons.astype(dtype))
            new_state, _ = planner._update_impl(planner_state, x, t, ctx, noise_override=noise)
            return new_state

        self.advance = jax.jit(advance)
        self.controller_update = jax.jit(controller_update)


def test_loop_matches_jax():
    jax_loop = JaxLoop(small(jax_ex.mppi_configuration()))
    loop = sv.ScenarioLoop(SCENARIOS, SIGMA, small(ex.mppi_configuration()), device="cpu")
    assert loop.per_period == 10 and loop.planner.steps == 10
    x = jnp.asarray(jax_loop.initial, jnp.float64)
    planner_state = jax_loop.planner.init(seed=0)
    strategy_state = jax_loop.strategy.init(jnp.float64)
    pid_state = jax_loop.pid.init(dtype=jnp.float64)
    host = jax.tree.map(np.asarray, (planner_state, strategy_state, pid_state))
    port = sv.LoopState(
        x=torch.tensor(np.asarray(x)),
        planner_state=interop.planner_state_from_numpy(host[0], loop.planner.rollout_count, "cpu", torch.float64),
        strategy_state=interop.forecast_state_from_numpy(host[1], "cpu", torch.float64),
        pid_state=interop.pid_state_from_numpy(host[2], "cpu", torch.float64),
        t=torch.zeros((), dtype=torch.float64),
    )
    rng = np.random.default_rng(11)
    scale = np.sqrt(np.asarray(ex.mppi_configuration().covariance))
    noise = rng.standard_normal((PERIODS, ROLLOUTS, loop.planner.steps, 12)) * scale
    obs_noise = SIGMA * rng.standard_normal((PERIODS, loop.per_period, 6))
    keys = jax.random.split(jax.random.PRNGKey(7), PERIODS)
    spread = 0.0
    for i in range(PERIODS):
        t = jnp.asarray(i * 0.05, jnp.float64)
        planner_state = jax_loop.controller_update(planner_state, x, strategy_state, t, keys[i],
                                                   jnp.asarray(noise[i]))
        x, strategy_state, pid_state, forces, sqerr = jax_loop.advance(
            x, planner_state, strategy_state, pid_state, t, jnp.asarray(obs_noise[i]))

        draws = np.array(jax.random.normal(keys[i], (SCENARIOS - 1, loop.strategy.configuration.states),
                                           jnp.float64))
        port_t = loop.time(i)
        ctx = loop.forecast_ctx(port.x, port.strategy_state, port_t, draws)
        spread = max(spread, float((ctx.wrench_horizon[1:] - ctx.wrench_horizon[0]).abs().max()))
        port_planner = loop.controller_update(port.planner_state, port.x, port.strategy_state, port_t, draws=draws,
                                              noise_override=noise[i])
        port_x, port_strategy, port_pid, port_forces, port_sqerr = loop.advance(
            port.x, port_planner, port.strategy_state, port.pid_state, port_t, torch.tensor(obs_noise[i]))
        port = sv.LoopState(port_x, port_planner, port_strategy, port_pid, port_t)

        close(port_planner.costs, planner_state.costs, f"period {i}: costs")
        close(port_planner.optimal_control, planner_state.optimal_control, f"period {i}: optimal_control")
        close(port_x, x, f"period {i}: x")
        close(port_strategy.filter.state, strategy_state.filter.state, f"period {i}: filter state")
        close(port_strategy.filter.covariance, strategy_state.filter.covariance, f"period {i}: covariance")
        close(port_forces, forces, f"period {i}: forces")
        close(port_sqerr, sqerr, f"period {i}: squared error")
    assert spread > 0.1  # the ensemble differs from the mean


def test_main_writes_the_jax_keys(tmp_path, monkeypatch):
    # One cell of the grid, one period.
    monkeypatch.setenv("SV_DURATION", "0.05")
    for name, value in (("SIGMAS", (SIGMA,)), ("SCENARIOS", (SCENARIOS,)), ("SEEDS", (0,))):
        monkeypatch.setattr(sv, name, value)
    assert sv.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    report = json.load(open(tmp_path / "torch_scenario_value.json"))
    want = json.load(open(os.path.join(ROOT, "scenario_value.json")))
    assert set(report) == set(want) | {"device", "power_limit"}
    (cell,) = report["cells"]
    assert set(cell) == set(want["cells"][0])
    assert set(cell["runs"]["0"]) == set(want["cells"][0]["runs"]["0"])
    assert (cell["obs_noise_sigma"], cell["scenarios"]) == (SIGMA, SCENARIOS)
    assert np.isfinite([cell["median_force"], cell["median_rmse"]]).all()


def test_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sv.main(["--out", str(tmp_path)])

"""The port's experiment episode against the JAX package's, at float64 on
the CPU.

The circle experiment at rollouts 10, keep-best 4, a 0.1 s horizon, for
0.2 s (40 ticks, 4 controller updates), with collect_logs. The port draws
with Philox and JAX with threefry, so both sides are fed the same sampled
noise: the JAX episode through a test-side wrapper of its planner's
``_update_impl`` that passes ``noise_override=stack[state.update_count]``
(traced at the first run; nothing in the JAX package changes), the port's
through ``Episode.run(noise_override=stack)``, which hands each update its
rows through ``planner.update(..., noise_override=...)``. The port starts
from the JAX carry (``interop.episode_carry_from_numpy``).

The cases: assisted (the harness's configuration), unassisted with the
controller off (no update: the plant and the human model alone), the QP
safety filter in the optimal re-rollout, and the columns and rows of the
experiment matrix (scripts/experiments.py): unassisted with the controller
on (no forecast reaches the planner), the average, LOCF and order-2 Kalman
forecasts (the constructors of scripts/experiments.py:121-140, passed as
``wrench_strategy`` on both sides), and the pose row (a point held at the
initial huddled end effector, the order-1 Kalman forecast). The port starts
from the JAX carry, whose forecast state is the strategy's own. Each JAX
episode runs once, in a module-scoped fixture.

Tolerance: |port - jax| <= 1e-8 * max(|jax|, 1) for every output and log.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import AssistedManipulation as JaxObjective
from assistedmanipulation_tpu.safety import Configuration as JaxSafetyConfiguration
from assistedmanipulation_tpu.safety import make_safety_filter as jax_make_safety_filter
from assistedmanipulation_tpu.sim import episode as jax_episode
from assistedmanipulation_tpu.sim import trajectories as jax_trajectories
from assistedmanipulation_tpu.sim.actor import Configuration as JaxActorConfiguration
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.forecast import forecast
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation
from assistedmanipulation_tpu_torch.safety import Configuration as SafetyConfiguration
from assistedmanipulation_tpu_torch.safety import make_safety_filter
from assistedmanipulation_tpu_torch.sim import episode
from assistedmanipulation_tpu_torch.sim import trajectories
from assistedmanipulation_tpu_torch.sim.actor import Configuration as ActorConfiguration
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-8
DURATION = 0.2
ROLLOUTS, KEEP, HORIZON = 10, 4, 0.1
FORECAST_DT, FORECAST_HORIZON = 0.01, 0.3
CASES = {
    "assisted": dict(episode={}),
    "plant_only": dict(episode=dict(assisted=False, controller_enabled=False)),
    "safety": dict(episode={}, safety=True),
    "unassisted_on": dict(episode=dict(assisted=False, controller_enabled=True)),
    "average": dict(episode={}, strategy="average"),
    "locf": dict(episode={}, strategy="locf"),
    "kalman_2": dict(episode={}, strategy="kalman_2"),
    "pose_hold": dict(episode={}, trajectory="pose"),
}


def make_strategy(package, name):
    """The wrench forecast of an experiment column (scripts/experiments.py
    :121-140) from ``package``'s forecast module; None = the Episode's
    default order-1 Kalman."""
    if name is None:
        return None
    if name == "average":
        return package.AverageForecast(package.AverageConfiguration(window=FORECAST_HORIZON))
    if name == "locf":
        return package.LOCFForecast(package.LOCFConfiguration(horizon=FORECAST_HORIZON))
    order = int(name.split("_")[1])
    return package.KalmanForecast(package.KalmanForecastConfiguration(
        observed_states=6, order=order, time_step=FORECAST_DT, horizon=FORECAST_HORIZON))


def initial_ee_position():
    """The huddled state's end effector (the pose row's hold point)."""
    aux = jax_fr.derive_aux(jax_model(), jnp.asarray(jax_fr.make_state("huddled"), jnp.float64))
    return tuple(float(v) for v in np.asarray(aux.ee_position))


def make_trajectory(package, name):
    if name == "pose":
        return package.PointTrajectory(package.PointConfiguration(point=initial_ee_position()))
    return package.CircularTrajectory(package.CircularConfiguration())


def close(port, want, what=""):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(port, want, err_msg=what)
        return
    want = want.astype(np.float64)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(port), nan, err_msg=what)
    err = np.abs(port[~nan] - want[~nan])
    assert (err <= TOL * np.maximum(np.abs(want[~nan]), 1.0)).all(), (what, float(err.max()))


def mppi_configurations():
    jax_cfg = dataclasses.replace(
        JaxActorConfiguration().mppi, rollouts=ROLLOUTS, keep_best_rollouts=KEEP, horizon=HORIZON, dtype="float64"
    )
    port_cfg = dataclasses.replace(
        ActorConfiguration().mppi, rollouts=ROLLOUTS, keep_best_rollouts=KEEP, horizon=HORIZON, dtype="float64"
    )
    return jax_cfg, port_cfg


def noise_stack(updates, steps):
    scale = np.sqrt(np.asarray(ActorConfiguration().mppi.covariance))
    rng = np.random.default_rng(9)
    return rng.standard_normal((updates, ROLLOUTS, steps, 12)) * scale


def run_jax(case):
    spec = CASES[case]
    jax_cfg, _ = mppi_configurations()
    collect = spec["episode"].get("assisted", True)
    ep = jax_episode.Episode(
        jax_cfg, JaxObjective(), make_trajectory(jax_trajectories, spec.get("trajectory")),
        jax_episode.EpisodeConfiguration(duration=DURATION, **spec["episode"]), dtype=jnp.float64,
        wrench_strategy=make_strategy(jax_forecast, spec.get("strategy")), collect_logs=collect,
        filter_fn=jax_make_safety_filter(JaxSafetyConfiguration(iterations=20)) if spec.get("safety") else None,
    )
    stack = noise_stack(ep.ticks // ep.countdown_max, ep.planner.steps)
    update = ep.planner._update_impl

    def injected(state, x0, time, ctx=None, noise_override=None):
        return update(state, x0, time, ctx, noise_override=jnp.asarray(stack)[state.update_count])

    ep.planner._update_impl = injected
    carry = ep.init_carry(0)
    out = jax.device_get(ep._run(carry))
    return jax.device_get(carry), stack, out


@pytest.fixture(scope="module")
def jax_runs():
    return {case: run_jax(case) for case in CASES}


def run_port(case, jax_carry, stack):
    spec = CASES[case]
    _, port_cfg = mppi_configurations()
    collect = spec["episode"].get("assisted", True)
    ep = episode.Episode(
        port_cfg, AssistedManipulation(), make_trajectory(trajectories, spec.get("trajectory")),
        episode.EpisodeConfiguration(duration=DURATION, **spec["episode"]), dtype=torch.float64,
        wrench_strategy=make_strategy(forecast, spec.get("strategy")), collect_logs=collect, device="cpu",
        filter_fn=make_safety_filter(SafetyConfiguration(iterations=20)) if spec.get("safety") else None,
    )
    carry = interop.episode_carry_from_numpy(jax_carry, ep.planner.rollout_count, device="cpu", dtype=torch.float64)
    return ep, ep.run(carry=carry, noise_override=stack)


def check_logs(port_logs, jax_logs):
    fired = np.asarray(jax_logs.update_fired)
    close(port_logs.update_fired, fired, "update_fired")
    for name in ("x", "ee_linear_acceleration", "ee_angular_acceleration", "joint_power", "torque_reference"):
        close(getattr(port_logs, name), getattr(jax_logs, name), name)
    for name in ("pid", "torque_pid"):
        for field in port_logs.pid._fields:
            close(getattr(getattr(port_logs, name), field), getattr(getattr(jax_logs, name), field), f"{name}.{field}")
    # The port logs the updates only; JAX zero-fills the other ticks.
    close(port_logs.optimal_control, np.asarray(jax_logs.optimal_control)[fired], "optimal_control")
    for field in port_logs.update_info._fields:
        close(getattr(port_logs.update_info, field), np.asarray(getattr(jax_logs.update_info, field))[fired],
              f"update_info.{field}")
    for field in port_logs.forecast._fields:
        close(getattr(port_logs.forecast, field), np.asarray(getattr(jax_logs.forecast, field))[fired],
              f"forecast.{field}")


@pytest.mark.parametrize("case", list(CASES))
def test_episode_matches_jax(jax_runs, case):
    jax_carry, stack, jax_out = jax_runs[case]
    ep, port_out = run_port(case, jax_carry, stack)
    if ep.collect_logs:
        (port_outputs, port_logs), (jax_outputs, jax_logs) = port_out, jax_out
        check_logs(port_logs, jax_logs)
    else:
        port_outputs, jax_outputs = port_out, jax_out
    for field in port_outputs._fields:
        close(getattr(port_outputs, field), getattr(jax_outputs, field), field)
    metrics = episode.episode_metrics(port_outputs)
    assert np.isfinite(list(metrics.values())).all()
    # The final carry's countdown continues the JAX schedule.
    assert ep.final_carry.countdown == (ep.countdown_max - 1 - (ep.ticks - 1) % ep.countdown_max
                                        if ep.episode.controller_enabled else 0)


def test_episode_capture_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_cfg = mppi_configurations()
    with pytest.raises(RuntimeError, match="CUDA"):
        episode.Episode(
            port_cfg, AssistedManipulation(), trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
            episode.EpisodeConfiguration(duration=DURATION), device="cpu", capture=True,
        )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        episode.Episode(
            port_cfg, AssistedManipulation(), trajectories.CircularTrajectory(trajectories.CircularConfiguration()),
        )

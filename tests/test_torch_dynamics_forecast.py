"""The port's dynamics forecast (forecast/dynamics_forecast.py) against the
JAX package's, at float64 on the CPU.

Both start from the same plant state (the huddled preset with seeded
velocities) and the same Kalman forecast state: the JAX strategy is fed a
seeded wrench sequence and its state handed to the port through
``interop.forecast_state_from_numpy``. Every ForecastRollout field and the
ForecastContext within |port - jax| <= 1e-9 * max(|jax|, 1). The port's
time may be a number or a 0-d tensor (the captured episode passes one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu.forecast import dynamics_forecast as jax_dynamics_forecast
from assistedmanipulation_tpu.forecast import forecast as jax_fc
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.forecast import dynamics_forecast
from assistedmanipulation_tpu_torch.forecast import forecast as fc
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-9
TIME = 0.35


def close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= TOL * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


def kalman_configuration(package):
    return package.KalmanForecastConfiguration(observed_states=6, order=1, time_step=0.01, horizon=0.3)


def initial_state():
    x = fr.make_state("huddled", energy=1000.0)
    x[fr.VELOCITY] = np.random.default_rng(4).uniform(-0.3, 0.3, 12)
    return x


@pytest.fixture(scope="module")
def jax_forecast():
    strategy = jax_fc.KalmanForecast(kalman_configuration(jax_fc))
    state = strategy.init(jnp.float64)
    rng = np.random.default_rng(8)
    for i in range(8):
        wrench = np.array([20.0, -5.0, 3.0, 0.0, 0.0, 0.5]) + rng.normal(0.0, 2.0, 6)
        state = strategy.update(state, wrench, TIME - 0.005 * (7 - i))
    forecaster = jax_dynamics_forecast.DynamicsForecast(jax_dynamics_forecast.Configuration())
    x = jnp.asarray(initial_state())
    rollout, ctx = forecaster.forecast(x, TIME, lambda t: strategy.forecast(state, t))
    return jax.device_get(state), jax.device_get(rollout), jax.device_get(ctx)


@pytest.mark.parametrize("time_kind", ["tensor", "number"])
def test_dynamics_forecast_matches_jax(jax_forecast, time_kind):
    jax_state, jax_rollout, jax_ctx = jax_forecast
    strategy = fc.KalmanForecast(kalman_configuration(fc))
    state = interop.forecast_state_from_numpy(jax_state, device="cpu")
    forecaster = dynamics_forecast.DynamicsForecast(dynamics_forecast.Configuration())
    time = torch.tensor(TIME, dtype=torch.float64) if time_kind == "tensor" else TIME
    rollout, ctx = forecaster.forecast(torch.tensor(initial_state()), time, lambda t: strategy.forecast(state, t))
    assert rollout._fields == jax_rollout._fields
    for name in rollout._fields:
        close(getattr(rollout, name), getattr(jax_rollout, name), name)
    close(ctx.wrench_horizon, jax_ctx.wrench_horizon, "ctx.wrench_horizon")
    close(ctx.start_time, jax_ctx.start_time, "ctx.start_time")
    assert (ctx.time_step, ctx.horizon) == (jax_ctx.time_step, jax_ctx.horizon)
    assert rollout.wrench.shape == (forecaster.configuration.steps, 6)
    # Zero control: the tank is untouched, the external power zero.
    assert torch.all(rollout.external_power == 0) and torch.all(rollout.energy == 1000.0)

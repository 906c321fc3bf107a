"""The forecast's horizon rolls as one product each: ``KalmanForecast.update``
(its cached prediction) and ``sample_scenarios`` (the posterior draws rolled
through the predictor) against the JAX package's step-by-step rolls, over a
50-step horizon, and against the port's own step-by-step roll.

Tolerances: float64, 1e-12 relative to each quantity's scale (as
tests/test_torch_forecast.py; measured 2e-15). float32 against the JAX
float64 result on the same measurements and draws: 5e-6 relative to the
scale. Worst measured over the 50-step horizon: 2.9e-7 (order 1) and 1.3e-6
(order 2) for the prediction, 3.2e-7 and 1.4e-6 for the scenarios; the
JAX package's own float32 prediction is 6.9e-7 and 1.3e-6 from its float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu.forecast.scenarios import sample_scenarios as jax_sample_scenarios
from assistedmanipulation_tpu_torch.forecast import forecast
from assistedmanipulation_tpu_torch.forecast.kalman import kalman_predict
from assistedmanipulation_tpu_torch.forecast.scenarios import sample_scenarios
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 50
DTYPES = {"float64": (torch.float64, 1e-12), "float32": (torch.float32, 5e-6)}


def _config(order, steps=STEPS):
    return dict(order=order, time_step=0.01, horizon=steps * 0.01, observation_variance=0.25,
                transition_variance=0.01)


def _run(order, dtype, count=12):
    """The same wrench stream (a ramp with noise) through the JAX Kalman
    forecast at float64 and the port's at ``dtype``."""
    jax_strategy = jax_forecast.KalmanForecast(jax_forecast.KalmanForecastConfiguration(**_config(order)))
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**_config(order)))
    jax_state = jax_strategy.init(dtype=jnp.float64)
    state = strategy.init(dtype=dtype, device="cpu")
    rng = np.random.default_rng(order)
    for k in range(count):
        wrench = 20.0 + np.arange(6) + 0.5 * k + rng.normal(size=6)
        jax_state = jax_strategy.update(jax_state, wrench, 0.01 * k)
        state = strategy.update(state, wrench, 0.01 * k)
    return jax_strategy, jax_state, strategy, state


def _close(got, want, tol, name):
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", [1, 2])
def test_kalman_prediction_roll_matches_jax(order, dtype):
    tdtype, tol = DTYPES[dtype]
    _, jax_state, strategy, state = _run(order, tdtype)
    assert state.prediction.shape == (STEPS + 1, 6)
    _close(state.prediction, jax_state.prediction, tol, "prediction")
    # The product is the predictor rolled step by step (kalman_predict).
    predicted, rows = state.filter, [state.filter.state[:6]]
    for _ in range(STEPS):
        predicted = kalman_predict(strategy.spec, predicted, update_covariance=False)
        rows.append(predicted.state[:6])
    _close(state.prediction, torch.stack(rows), tol, "step-by-step roll")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", [1, 2])
def test_scenario_roll_matches_jax(order, dtype):
    tdtype, tol = DTYPES[dtype]
    jax_strategy, jax_state, strategy, state = _run(order, tdtype)
    key, count = jax.random.PRNGKey(order), 4
    want = jax_sample_scenarios(jax_strategy, jax_state, key, count)
    draws = np.array(jax.random.normal(key, (count - 1, strategy.configuration.states), jnp.float64))
    got = sample_scenarios(strategy, state, None, count, draws=draws)
    assert got.shape == (count, STEPS + 1, 6) and got.dtype == tdtype
    _close(got, want, tol, "scenarios")
    assert float((got[1:] - got[:1]).abs().max()) > 0.01  # a real spread


def test_rolls_take_a_fixed_number_of_products():
    """One product per roll, whatever the horizon: a 10-step and a 50-step
    forecast run the same operations."""

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    counts = []
    for steps in (10, STEPS):
        strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**_config(1, steps)))
        state = strategy.init(dtype=torch.float64, device="cpu")
        wrench, draws = torch.arange(6.0, dtype=torch.float64), torch.zeros((3, 12), dtype=torch.float64)
        state = strategy.update(state, wrench, 0.0)  # the horizon map, made once
        sample_scenarios(strategy, state, None, 4, draws=draws)
        with Ops() as ops:
            state = strategy.update(state, wrench, 0.01)
            sample_scenarios(strategy, state, None, 4, draws=draws)
        counts.append(len(ops.names))
    assert counts[0] == counts[1], counts

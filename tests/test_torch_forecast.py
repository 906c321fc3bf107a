"""The port's forecast strategies (assistedmanipulation_tpu_torch/forecast/)
against the JAX package's, fed the same measurement stream.

Tolerances: at float64 everything within 1e-12 relative to the quantity's
scale (the two packages' LAPACK solves and matmuls sum in other orders).
At float32 the finite-difference derivatives (a 1/dt = 100x amplifier of
the measurements' rounding) and the matmul order give differences of a few
float32 ulps of each quantity: within 1e-5 of its scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu.forecast import kalman as jax_kalman
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.forecast import forecast, kalman
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

DTYPES = {"float64": (jnp.float64, torch.float64, 1e-12), "float32": (jnp.float32, torch.float32, 1e-5)}


def _close(got, want, tol, name=""):
    """|got - want| <= tol * scale, the scale being the quantity's largest
    magnitude (at least its float32 ulp-free floor of 1e-30)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _stream(count=24, seed=0):
    """A wrench stream at 100 Hz with a jittered clock: a slow ramp plus
    noise on all six channels, and one repeated and one out-of-order time."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(0.01 + 0.002 * rng.standard_normal(count))
    times[7] = times[6]
    times[12] = times[11] - 0.005
    wrench = 5.0 + 0.5 * np.arange(count)[:, None] + rng.standard_normal((count, 6))
    return times, wrench


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("noise_model", [False, True])
def test_kalman_forecast_matches_jax(dtype, noise_model):
    jdtype, tdtype, tol = DTYPES[dtype]
    options = dict(order=2, time_step=0.01, horizon=0.1)
    if noise_model:
        options.update(observation_variance=0.25, transition_variance=0.01)
    jax_strategy = jax_forecast.KalmanForecast(jax_forecast.KalmanForecastConfiguration(**options))
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**options))
    jax_state = jax_strategy.init(dtype=jdtype)
    state = strategy.init(dtype=tdtype, device="cpu")
    times, wrench = _stream()
    for k, (time, measurement) in enumerate(zip(times, wrench)):
        if k % 5 == 4:  # a prediction-only tick between measurements
            jax_state = jax_strategy.observe_time(jax_state, time - 0.004)
            state = strategy.observe_time(state, time - 0.004)
        jax_state = jax_strategy.update(jax_state, measurement, time)
        state = strategy.update(state, measurement, time)
        want = interop.forecast_state_to_numpy(interop.forecast_state_from_numpy(
            jax.tree.map(np.asarray, jax_state), device="cpu"
        ))
        got = interop.forecast_state_to_numpy(state)
        for name in ("state", "next_state", "covariance"):
            _close(got["filter"][name], want["filter"][name], tol, f"update {k}: {name}")
        for name in ("measurement", "prediction", "last_update"):
            _close(got[name], want[name], tol, f"update {k}: {name}")
        for ahead in (0.0, 0.013, 0.05, 0.2):
            _close(
                strategy.forecast(state, time + ahead),
                jax_strategy.forecast(jax_state, jnp.asarray(time + ahead, jdtype)),
                tol, f"update {k}: forecast +{ahead}",
            )


@pytest.mark.parametrize("dtype", DTYPES)
def test_locf_and_average_forecasts_match_jax(dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    pairs = [
        (jax_forecast.LOCFForecast(jax_forecast.LOCFConfiguration(horizon=0.05)),
         forecast.LOCFForecast(forecast.LOCFConfiguration(horizon=0.05))),
        (jax_forecast.AverageForecast(jax_forecast.AverageConfiguration(window=0.05, max_measurements=8)),
         forecast.AverageForecast(forecast.AverageConfiguration(window=0.05, max_measurements=8))),
    ]
    times, wrench = _stream(count=20, seed=1)
    for jax_strategy, strategy in pairs:
        jax_state, state = jax_strategy.init(dtype=jdtype), strategy.init(dtype=tdtype, device="cpu")
        _close(strategy.forecast(state, 0.0), jax_strategy.forecast(jax_state, jnp.asarray(0.0, jdtype)), 0)
        for k, (time, measurement) in enumerate(zip(times, wrench)):
            jax_state = jax_strategy.update(jax_state, measurement, time)
            state = strategy.update(state, measurement, time)
            if k % 4 == 3:
                jax_state = jax_strategy.observe_time(jax_state, time + 0.02)
                state = strategy.observe_time(state, time + 0.02)
            # The state carried across (interop) and back equals the
            # port's own, field by field; the ring cursor stays int32.
            carried = interop.forecast_state_from_numpy(jax.tree.map(np.asarray, jax_state), device="cpu")
            assert type(carried) is type(state)
            want, got = interop.forecast_state_to_numpy(carried), interop.forecast_state_to_numpy(state)
            assert set(want) == set(got) == set(state._fields)
            for name in state._fields:
                assert got[name].dtype == want[name].dtype == np.asarray(getattr(jax_state, name)).dtype, name
                _close(np.where(np.isinf(got[name]), 0, got[name]), np.where(np.isinf(want[name]), 0, want[name]),
                       tol, f"{type(strategy).__name__} update {k}: {name}")
                np.testing.assert_array_equal(np.isinf(got[name]), np.isinf(want[name]))
            for ahead in (0.0, 0.03, 0.08):
                _close(
                    strategy.forecast(state, time + ahead),
                    jax_strategy.forecast(jax_state, jnp.asarray(time + ahead, jdtype)),
                    tol, f"{type(strategy).__name__} update {k} +{ahead}",
                )


def test_create_and_transition_matrix_match_jax():
    for kind in ("locf", "average", "kalman"):
        assert type(forecast.create(forecast.Configuration(type=kind))).__name__ == type(
            jax_forecast.create(jax_forecast.Configuration(type=kind))
        ).__name__
    with pytest.raises(ValueError, match="unknown forecast type"):
        forecast.create(forecast.Configuration(type="oracle"))
    np.testing.assert_array_equal(
        kalman.euler_state_transition_matrix(0.02, 6, 3),
        jax_kalman.euler_state_transition_matrix(0.02, 6, 3),
    )


def test_kalman_refuses_tf32_matmuls():
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration())
    state = strategy.init(dtype=torch.float32, device="cpu")
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            strategy.update(state, np.ones(6), 0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert torch.isfinite(strategy.update(state, np.ones(6), 0.0).prediction).all()


def test_forecast_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("locf", "average", "kalman"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            forecast.create(forecast.Configuration(type=kind)).init()

"""The port's float32 time lookups against the JAX package's at whole-step
boundaries.

Each lookup turns a time span into a step index by truncating ``(t - t0) /
dt``. Under jit, XLA compiles the JAX package's float32 quotient into the
product with float32(1 / dt), which rounds below a whole step where a
division rounds onto it ((0.59 - 0.10) / 0.01: 48.999996 against 49.0). The
port takes the same product (``ops.per_step``), so the lookups truncate to
the same step:

- ``Planner.get`` at 50 steps, ``last_update_time`` 0.10 and ``time`` 0.59
  (the last step): the JAX package interpolates to u[49], a division would
  fall past the end to the default control; and over a grid of pairs;
- the objective's wrench lookup (``ForecastContext.wrench``) and the Kalman
  forecast's query (``KalmanForecast.forecast``) at the pairs where the two
  quotients differ. There the two sides interpolate between other steps
  (frac ~1 against 0), so the values differ by ~5e-7 of the step-to-step
  change: the horizons below change by ~100 per step, which float32 resolves.

Everything is float32 on the CPU, the JAX side jitted as its pipeline runs
it. Values are held bitwise: both sides compute the same float32 products
in the same order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu.models import point_mass as jax_point_mass
from assistedmanipulation_tpu.objectives.assisted_manipulation import ForecastContext as JaxForecastContext
from assistedmanipulation_tpu_torch import mppi
from assistedmanipulation_tpu_torch.forecast import forecast
from assistedmanipulation_tpu_torch.models import point_mass
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

DT = 0.01
STEPS = 50
# (time, t0) pairs whose float32 quotients differ between a division and the
# product with the reciprocal (the first three: 5, 10 and 20 steps).
PAIRS = [(0.06, 0.01), (0.105, 0.005), (0.21, 0.01), (0.59, 0.10)]


def _configuration(module):
    return module.Configuration(
        rollouts=6, keep_best_rollouts=2, time_step=DT, horizon=STEPS * DT,
        covariance=np.eye(2) * 0.5, control_min=-np.ones(2) * 1e3, control_max=np.ones(2) * 1e3,
        control_default=np.zeros(2), smoothing=None, dtype="float32",
    )


def _f32(value):
    return np.asarray(value, np.float32)


def test_planner_get_matches_jax_at_the_last_step():
    jax_planner = jax_mppi.Planner(
        _configuration(jax_mppi), jax_point_mass.make_point_mass_plant(jax_point_mass.PointMassConfig())
    )
    planner = mppi.Planner(
        _configuration(mppi), point_mass.make_point_mass_plant(point_mass.PointMassConfig()), device="cpu"
    )
    assert planner.steps == STEPS
    optimal = _f32(np.random.default_rng(0).uniform(1.0, 100.0, (STEPS, 2)))
    jax_state = jax_planner.init(seed=0)._replace(optimal_control=jnp.asarray(optimal))
    state = planner.init(seed=0)._replace(optimal_control=torch.tensor(optimal))

    def both(time, last_update):
        got = planner.get(state._replace(last_update_time=torch.tensor(_f32(last_update))), _f32(time))
        want = jax_planner.get(jax_state._replace(last_update_time=jnp.asarray(_f32(last_update))), _f32(time))
        return got.numpy(), np.asarray(want)

    # (steps - 1) * dt after the last update: the last step.
    got, want = both(0.59, 0.10)
    np.testing.assert_allclose(want, optimal[STEPS - 1], rtol=1e-5)  # ~u[49], not the default
    np.testing.assert_array_equal(got, want)
    departed = 0
    for last in np.arange(0, 100) * _f32(0.01):
        for steps_ahead in (STEPS - 2, STEPS - 1, STEPS):
            time = _f32(last) + _f32(steps_ahead * DT)
            got, want = both(time, last)
            np.testing.assert_array_equal(got, want, err_msg=f"get at {time!r} after {last!r}")
            departed += float(np.float32(time - _f32(last)) / np.float32(DT)) != float(
                np.float32(time - _f32(last)) * (np.float32(1.0) / np.float32(DT))
            )
    assert departed > 0  # the grid holds pairs where the two quotients differ


def test_wrench_lookup_matches_jax_at_step_boundaries():
    rng = np.random.default_rng(1)
    horizon = _f32(np.cumsum(rng.uniform(50.0, 150.0, (STEPS + 1, 6)), axis=0))
    for time, t0 in PAIRS:
        ctx = ForecastContext(torch.tensor(horizon), torch.tensor(_f32(t0)), DT, STEPS * DT)
        jax_ctx = JaxForecastContext(jnp.asarray(horizon), jnp.asarray(_f32(t0)), DT, STEPS * DT)
        times = _f32([time, t0 + 0.5 * DT])
        got = ctx.wrench(torch.tensor(times)).numpy()
        want = np.asarray(jax.jit(jax.vmap(jax_ctx.wrench))(jnp.asarray(times)))
        np.testing.assert_array_equal(got, want, err_msg=f"wrench at {time} from {t0}")


def test_forecast_query_matches_jax_at_step_boundaries():
    options = dict(order=1, time_step=DT, horizon=STEPS * DT)
    jax_strategy = jax_forecast.KalmanForecast(jax_forecast.KalmanForecastConfiguration(**options))
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**options))
    prediction = _f32(np.cumsum(np.random.default_rng(2).uniform(50.0, 150.0, (STEPS + 1, 6)), axis=0))
    jax_state = jax_strategy.init(dtype=jnp.float32)._replace(prediction=jnp.asarray(prediction))
    state = strategy.init(dtype=torch.float32, device="cpu")._replace(prediction=torch.tensor(prediction))
    query = jax.jit(jax_strategy.forecast)
    for time, t0 in PAIRS:
        got = strategy.forecast(state._replace(last_update=torch.tensor(_f32(t0))), torch.tensor(_f32(time)))
        want = query(jax_state._replace(last_update=jnp.asarray(_f32(t0))), jnp.asarray(_f32(time)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"forecast at {time} from {t0}")

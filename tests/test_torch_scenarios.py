"""The port's forecast scenario ensemble (forecast/scenarios.py) against the
JAX package's: posterior sampling with the same standard normals, the
scenario-mean rollout wrapper, and the serving loop they make.

Tolerances: float64 throughout, 1e-12 relative to each quantity's scale
for the sampled horizons (matmul summation order), rtol 1e-9 for rollout
costs (as tests/test_torch_rollout.py); NaN patterns exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.forecast import forecast as jax_forecast
from assistedmanipulation_tpu.forecast.scenarios import (
    make_scenario_rollout_fn as jax_make_scenario_rollout_fn,
    sample_scenarios as jax_sample_scenarios,
)
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_rollout_fn
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.forecast import forecast
from assistedmanipulation_tpu_torch.forecast.scenarios import (
    make_scenario_rollout_fn,
    sample_scenarios,
)
from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import make_cuda_rollout_fn
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 4
DT = 0.01
CONFIG = dict(order=1, time_step=DT, horizon=STEPS * DT, observation_variance=0.04, transition_variance=0.01)


def _kalman_states():
    """The same measurement stream through both packages' Kalman forecasts
    (float64); returns both strategies and states."""
    jax_strategy = jax_forecast.KalmanForecast(jax_forecast.KalmanForecastConfiguration(**CONFIG))
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**CONFIG))
    jax_state = jax_strategy.init(dtype=jnp.float64)
    state = strategy.init(dtype=torch.float64, device="cpu")
    for k in range(6):
        wrench = np.zeros(6)
        wrench[0] = 5.0 + k
        wrench[2] = -0.5 * k
        jax_state = jax_strategy.update(jax_state, wrench, DT * k)
        state = strategy.update(state, wrench, DT * k)
    return jax_strategy, jax_state, strategy, state


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = max(float(np.nanmax(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_sample_scenarios_matches_jax_with_the_same_draws():
    jax_strategy, jax_state, strategy, state = _kalman_states()
    count = 5
    key = jax.random.PRNGKey(3)
    want = jax_sample_scenarios(jax_strategy, jax_state, key, count)
    draws = np.array(jax.random.normal(key, (count - 1, strategy.configuration.states), jnp.float64))
    got = sample_scenarios(strategy, state, None, count, draws=draws)
    assert got.shape == (count, STEPS + 1, 6)
    torch.testing.assert_close(got[0], state.prediction, rtol=0, atol=0)
    _close(got.numpy(), want)
    assert float((got[1:] - got[0]).abs().max()) > 0.01  # a real spread
    # Its own draws: same shape, finite; one scenario is the mean alone.
    own = sample_scenarios(strategy, state, torch.Generator().manual_seed(0), count)
    assert own.shape == got.shape and torch.isfinite(own).all()
    assert torch.equal(sample_scenarios(strategy, state, None, 1)[0], state.prediction)
    with pytest.raises(ValueError, match="at least one"):
        sample_scenarios(strategy, state, None, 0)
    with pytest.raises(ValueError, match="draws"):
        sample_scenarios(strategy, state, None, count, draws=draws[:2])


def test_non_positive_definite_posterior_gives_nan_draws_as_jax():
    """jnp.linalg.cholesky returns NaN on a matrix that is not positive
    definite where torch.linalg.cholesky raises; the port turns the
    factorisation's failure into NaN, so every draw is NaN and scenario 0
    (the mean) stays finite, as in JAX."""
    jax_strategy, jax_state, strategy, state = _kalman_states()
    bad = np.diag(np.r_[-np.ones(6), np.ones(6)]) * 1e-3
    jax_state = jax_state._replace(filter=jax_state.filter._replace(covariance=jnp.asarray(bad)))
    state = state._replace(filter=state.filter._replace(covariance=torch.tensor(bad)))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_sample_scenarios(jax_strategy, jax_state, key, 3))
    draws = np.array(jax.random.normal(key, (2, 12), jnp.float64))
    got = sample_scenarios(strategy, state, None, 3, draws=draws).numpy()
    assert np.isnan(want[1:]).all() and np.isfinite(want[0]).all()
    _close(got, want)


def test_scenario_rollout_fn_matches_jax():
    """C = 3 scenarios through the rollout evaluators (the port's plain
    two-pass rollout, the JAX lanes rollout) at float64: the risk-neutral
    and a weighted scenario mean, states from scenario 0."""
    rollouts, count = 5, 3
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((rollouts, STEPS, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
    optimal = 0.3 * rng.standard_normal((STEPS, 12))
    x0 = fr.make_state("huddled")
    horizons = 20.0 + 10.0 * rng.standard_normal((count, STEPS + 1, 6))
    jax_rollout = make_lanes_rollout_fn(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), STEPS, DT
    )
    rollout_fn = make_cuda_rollout_fn(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), STEPS, DT, device="cpu"
    )
    jctx = JaxForecastContext(jnp.asarray(horizons), jnp.asarray(0.0), DT, STEPS * DT)
    ctx = ForecastContext(torch.tensor(horizons), torch.tensor(0.0, dtype=torch.float64), DT, STEPS * DT)
    for weights in (None, [1.0, 2.0, 0.5]):
        want_costs, want_states = jax_make_scenario_rollout_fn(jax_rollout, weights)(
            jnp.asarray(noise), jnp.asarray(optimal), jnp.asarray(x0), jnp.asarray(0.01), jctx
        )
        costs, states = make_scenario_rollout_fn(rollout_fn, weights)(
            torch.tensor(noise), torch.tensor(optimal), torch.tensor(x0),
            torch.tensor(0.01, dtype=torch.float64), ctx,
        )
        np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs), rtol=1e-9)
        np.testing.assert_allclose(states.numpy(), np.asarray(want_states), rtol=1e-9, atol=1e-12)


def test_nan_in_one_scenario_poisons_that_rollout_as_jax():
    """The wrapper's mean over scenarios propagates a NaN from one
    scenario's costs into that rollout only, in JAX and in the port. The
    rollout function here is a stand-in whose cost reads one horizon entry
    per rollout, so one NaN entry poisons one (rollout, channel)."""
    rollouts, count = 6, 3
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((rollouts, STEPS, 12))
    horizons = rng.standard_normal((count, STEPS + 1, 6))
    horizons[1, 2, 0] = np.nan

    def stand_in(xp):
        def fn(noise, optimal, x0, time, ctx):
            rows = ctx.wrench_horizon[xp.arange(rollouts) % (STEPS + 1)][:, :2]
            return noise.sum(axis=(1, 2))[:, None] * rows

        return fn

    torch_xp = type("xp", (), {"arange": staticmethod(torch.arange)})
    want = jax_make_scenario_rollout_fn(stand_in(jnp))(
        jnp.asarray(noise), None, None, None,
        JaxForecastContext(jnp.asarray(horizons), None, DT, STEPS * DT),
    )
    got = make_scenario_rollout_fn(stand_in(torch_xp))(
        torch.tensor(noise), None, None, None,
        ForecastContext(torch.tensor(horizons), None, DT, STEPS * DT),
    )
    want = np.asarray(want)
    assert np.isnan(want).sum() == 1 and np.isnan(want[2, 0])
    _close(got.numpy(), want)


def test_kalman_driven_serving_loop_on_the_plain_path():
    """measure wrench -> Kalman update -> draw C scenarios -> MPPI update
    scored by the two-pass rollout: the serving loop at a tiny size, on the
    CPU's plain path (no kernel launch). Controls stay finite and bounded,
    and the forecast state survives the round trip through interop."""
    cuda_rollout.reset_launch_counts()
    steps, count = 4, 3
    config = dict(CONFIG, horizon=steps * DT)
    strategy = forecast.KalmanForecast(forecast.KalmanForecastConfiguration(**config))
    fstate = strategy.init(dtype=torch.float32, device="cpu")
    flagship = build_flagship(rollouts=30, steps=steps, device="cpu", scenarios=count)
    state = flagship.init(seed=0)
    generator = torch.Generator().manual_seed(1)
    for k in range(4):
        time = 0.01 * k
        measurement = torch.tensor([20.0 + k, 0.0, -1.0, 0.0, 0.0, 0.0])
        fstate = strategy.update(fstate, measurement, time)
        horizons = sample_scenarios(strategy, fstate, generator, count)
        ctx = ForecastContext(horizons, fstate.last_update, DT, steps * DT)
        state, info = flagship.update(state, flagship.x0, time, ctx)
    assert horizons.shape == (count, steps + 1, 6)
    assert torch.isfinite(state.optimal_control).all()
    assert (state.optimal_control.abs() <= torch.tensor(fr.DEFAULT_CONTROL_MAX, dtype=torch.float32)).all()
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 0, "inkernel_rng_sample_rollout": 0, "fp32_chain": 0, "admm_qp": 0,
    }
    back = interop.forecast_state_from_numpy(interop.forecast_state_to_numpy(fstate), device="cpu")
    for got, want in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(fstate))):
        assert torch.equal(got, want)

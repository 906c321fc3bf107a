"""Resimulate mode: the port's planner publishes the re-rollout of each new
optimal sequence (``filter_rollout_fn`` = kernels/cuda_rollout.
make_cuda_filter_rollout_fn, the plain kernel-2 version at R = 1 on the
CPU), held to the JAX planner in resimulate mode (its plant re-rollout,
mppi.py:653-686) at float64; and what the CPU can check of the captured
update: it refuses to run there.

The draws: the JAX planner takes ``noise_override`` (every sampled row),
the port ``fresh=`` with the same rows. ``noise_override`` replaces the
elite rows too, so both planners run with keep_best_rollouts = 0 and the
override is the whole sampled noise on both sides; a third case feeds the
port the JAX planner's own draws with the elite rows kept
(tests/test_torch_flagship.py's way). With a 4-scenario ensemble the JAX
planner scores the batch on the scenario mean (make_scenario_rollout_fn)
and re-rolls on the nominal scenario, as the port does.

Tolerances, float64 over 3 updates: optimal_control within 1e-8 absolute
(controls span +-100; as the flagship's float64 free run), optimal_cost and
optimal_rollout_states within rtol 1e-9 (as the rollout twins,
tests/test_torch_rollout.py), violation counts exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu.forecast.scenarios import make_scenario_rollout_fn as jax_scenario_rollout_fn
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_planner
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu.parallel.flagship import (
    default_mppi_configuration as jax_default_configuration,
)
from assistedmanipulation_tpu_torch import graphs, mppi
from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import CudaSampler, make_cuda_filter_rollout_fn
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.parallel.flagship import (
    build_flagship,
    default_mppi_configuration,
    make_serving_tick,
)
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS, ROLLOUTS = 6, 30
R = ROLLOUTS + 2
TIMES = [0.0, 0.01, 0.03]


def _wrench(scenarios):
    """Forecast horizons whose end (0.095 s) falls between rollout step
    times (see test_torch_flagship's free run); scenario c adds 2c N."""
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 20.0
    wrench[:, 2] = np.linspace(0.0, -6.0, 11)
    if scenarios == 1:
        return wrench
    return np.stack([wrench + 2.0 * c * np.eye(6)[c % 3] for c in range(scenarios)])


def _port_planner(scenarios, keep_best):
    cfg = dataclasses.replace(
        default_mppi_configuration(ROLLOUTS, STEPS, "float64", optimal_rollout_mode="resimulate"),
        keep_best_rollouts=keep_best,
    )
    args = (frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration())
    sampler = CudaSampler(
        *args, cfg.rollout_count, cfg.step_count, cfg.time_step, np.sqrt(fr.DEFAULT_COVARIANCE),
        device="cpu", fused_assembly=scenarios == 1,
    )
    filter_rollout_fn = make_cuda_filter_rollout_fn(*args, STEPS, cfg.time_step, device="cpu")
    return mppi.Planner(cfg, sampler, 12, device="cpu", filter_rollout_fn=filter_rollout_fn)


def _jax_planner(scenarios, keep_best):
    cfg = dataclasses.replace(
        jax_default_configuration(ROLLOUTS, STEPS, "resimulate", rng_impl="threefry2x32"),
        dtype="float64", keep_best_rollouts=keep_best,
    )
    return make_lanes_planner(cfg, rollout_fn_wrapper=jax_scenario_rollout_fn if scenarios > 1 else None)


def _jax_fresh(words, scale):
    """The draws the JAX logical planner makes from its state's key
    (mppi.py:466-488)."""

    @jax.jit
    def draw(words):
        _, key = jax.random.split(jax.random.wrap_key_data(words, impl="threefry2x32"))
        return jax.random.normal(key, (R, STEPS, 12), jnp.float64) * scale

    return np.asarray(draw(words))


@pytest.mark.parametrize("scenarios,override", [(1, True), (4, True), (1, False)])
def test_resimulate_matches_jax_f64(scenarios, override):
    keep_best = 0 if override else ROLLOUTS // 5
    jax_planner, planner = _jax_planner(scenarios, keep_best), _port_planner(scenarios, keep_best)
    wrench = _wrench(scenarios)
    jax_ctx = JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float64), 0.01, 0.095)
    ctx = ForecastContext(torch.tensor(wrench), torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095)
    x0 = fr.make_state("huddled")
    rng = np.random.default_rng(scenarios)
    scale = np.sqrt(fr.DEFAULT_COVARIANCE)
    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    for time in TIMES:
        if override:
            fresh = rng.standard_normal((R, STEPS, 12)) * scale
            jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx, noise_override=fresh[2:])
        else:
            fresh = _jax_fresh(jax_state.rng, jnp.asarray(scale))
            jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx)
        state, info = planner.update(state, torch.tensor(x0), time, ctx, fresh=fresh)
        assert bool(info.degenerate) == bool(jax_info.degenerate) is False
        np.testing.assert_array_equal(state.costs.numpy()[:, 0], np.asarray(jax_state.costs)[:, 0])
        np.testing.assert_allclose(
            state.optimal_control.numpy(), np.asarray(jax_state.optimal_control), rtol=0, atol=1e-8
        )
        np.testing.assert_allclose(float(info.optimal_cost), float(jax_info.optimal_cost), rtol=1e-9)
        assert float(state.optimal_cost) == float(info.optimal_cost)
        np.testing.assert_allclose(
            info.optimal_rollout_states.numpy(), np.asarray(jax_info.optimal_rollout_states),
            rtol=1e-9, atol=1e-12,
        )
    # Resimulate publishes the new sequence's rollout, not rollout 0's.
    assert float(info.optimal_cost) != float(mppi.compose_cost(state.costs[0]))


def test_filter_rollout_scores_the_nominal_scenario():
    """With an ensemble ctx the re-rollout reads scenario 0 only, as the
    JAX objective's pointwise wrench does; on one forecast it is the
    two-pass rollout of the sequence as rollout 0 of a batch."""
    args = (frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration())
    fn = make_cuda_filter_rollout_fn(*args, STEPS, 0.01, device="cpu")
    rng = np.random.default_rng(5)
    optimal = torch.tensor(rng.normal(size=(STEPS, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE))
    x0, time = torch.tensor(fr.make_state("huddled")), torch.tensor(0.02, dtype=torch.float64)
    horizons = torch.tensor(_wrench(3))
    ensemble = ForecastContext(horizons, torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095)
    single = ensemble._replace(wrench_horizon=horizons[0])
    cost, states = fn(optimal, x0, time, ensemble)
    assert cost.shape == (2,) and states.shape == (STEPS, 31)
    want_cost, want_states = fn(optimal, x0, time, single)
    assert torch.equal(cost, want_cost) and torch.equal(states, want_states)
    batch_costs, batch_states = cuda_rollout.make_cuda_rollout_fn(*args, STEPS, 0.01, device="cpu")(
        torch.zeros((1, STEPS, 12), dtype=torch.float64), optimal, x0, time, single
    )
    assert torch.equal(cost, batch_costs[0]) and torch.equal(states, batch_states)
    np.testing.assert_array_equal(states[0].numpy(), x0.numpy())
    other = fn(optimal, x0, time, single._replace(wrench_horizon=horizons[2]))[0]
    assert not torch.equal(cost, other)  # the scenarios do differ


def test_configuration_default_is_resimulate_and_needs_the_hook():
    assert mppi.Configuration().optimal_rollout_mode == jax_mppi.Configuration().optimal_rollout_mode
    assert mppi.Configuration().optimal_rollout_mode == "resimulate"
    cfg = default_mppi_configuration(ROLLOUTS, STEPS, optimal_rollout_mode="resimulate")
    with pytest.raises(ValueError, match="filter_rollout_fn"):
        mppi.Planner(cfg, None, 12, device="cpu")
    with pytest.raises(ValueError, match="unknown optimal_rollout_mode"):
        mppi.Planner(dataclasses.replace(cfg, optimal_rollout_mode="replay"), None, 12, device="cpu")
    assert default_mppi_configuration(ROLLOUTS, STEPS).optimal_rollout_mode == "batch"


@pytest.mark.parametrize("mode", ["batch", "resimulate"])
def test_eager_update_leaves_its_state_untouched(mode):
    flagship = build_flagship(rollouts=14, steps=4, device="cpu", optimal_rollout_mode=mode)
    state, ctx = flagship.init(seed=3), flagship.make_ctx()
    state, _ = flagship.update(state, flagship.x0, 0.0, ctx)
    before = {name: value.clone() for name, value in state._asdict().items()}
    new_state, info = flagship.update(state, flagship.x0, 0.01, ctx)
    for name, value in state._asdict().items():
        assert torch.equal(value, before[name]), name
    assert not torch.equal(new_state.optimal_control, state.optimal_control)
    if mode == "resimulate":
        np.testing.assert_array_equal(info.optimal_rollout_states[0].numpy(), flagship.x0.numpy())


def test_capture_raises_on_the_cpu():
    flagship = build_flagship(rollouts=14, steps=4, device="cpu")
    state = flagship.init(seed=0)
    with pytest.raises(RuntimeError, match="Planner.capture captures a CUDA graph"):
        flagship.planner.capture(state, flagship.x0, 0.0, flagship.make_ctx())
    with pytest.raises(RuntimeError, match=r"build_flagship\(capture=True\) captures a CUDA graph"):
        build_flagship(rollouts=14, steps=4, device="cpu", capture=True)
    forecast = KalmanForecast(KalmanForecastConfiguration(horizon=0.04))
    with pytest.raises(RuntimeError, match=r"make_serving_tick\(capture=True\) captures a CUDA graph"):
        make_serving_tick(flagship, forecast, 2, torch.Generator(), capture=True)


def test_eager_serving_tick_is_the_composition():
    """make_serving_tick's eager tick: forecast update, scenario draw with
    the caller's generator, planner update against the ensemble."""
    from assistedmanipulation_tpu_torch.forecast.scenarios import sample_scenarios

    flagship = build_flagship(rollouts=14, steps=4, device="cpu", scenarios=3)
    forecast = KalmanForecast(KalmanForecastConfiguration(
        horizon=0.04, observation_variance=0.25, transition_variance=0.01,
    ))
    tick = make_serving_tick(flagship, forecast, 3, torch.Generator().manual_seed(3))
    generator = torch.Generator().manual_seed(3)
    f_state = f_want = forecast.init(device="cpu")
    p_state = p_want = flagship.init(seed=1)
    for k in range(3):
        wrench = torch.tensor([20.0, 2.0 * k, 0, 0, 0, 0])
        f_state, p_state, info, horizons = tick(f_state, p_state, flagship.x0, wrench, 0.01 * k)
        f_want = forecast.update(f_want, wrench, 0.01 * k)
        want_horizons = sample_scenarios(forecast, f_want, generator, 3)
        ctx = ForecastContext(want_horizons, f_want.last_update, 0.01, 0.04)
        p_want, _ = flagship.update(p_want, flagship.x0, 0.01 * k, ctx)
        assert torch.equal(horizons, want_horizons)
        for got, want in zip(p_state, p_want):
            assert torch.equal(got, want)


def test_capture_tallies_kernel_nodes_not_launches():
    build.reset_launch_counts()
    with build.capture_tally() as tally:
        build.count_launch("rollout")
        build.count_launch("rollout")
        with pytest.raises(RuntimeError, match="already"):
            with build.capture_tally():
                pass
    build.count_launch("fused_sample_rollout")
    assert tally["rollout"] == 2 and build.LAUNCHES["rollout"] == 0
    assert build.LAUNCHES["fused_sample_rollout"] == 1
    build.reset_launch_counts()


def test_graph_inputs_check_what_the_capture_fixed():
    """graphs.load refuses a value the capture baked in (a ctx's time step,
    a missing ctx) or another structure; host leaves are not read."""
    ctx = ForecastContext(torch.zeros((5, 6)), torch.zeros(()), 0.01, 0.04)
    graphs.load(ctx, ctx._replace(wrench_horizon=torch.ones((5, 6))))
    with pytest.raises(ValueError, match="ctx.time_step"):
        graphs.load(ctx, ctx._replace(time_step=0.02), "ctx")
    with pytest.raises(TypeError, match="ForecastContext"):
        graphs.load(ctx, None, "ctx")
    with pytest.raises(ValueError, match="ctx"):
        graphs.load(None, ctx, "ctx")

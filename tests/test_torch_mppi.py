"""The port's planner pieces against the JAX Planner at float64: the elite
keep mask (bit-identical, ties and NaN included), Savitzky-Golay smoothing,
the weighting/update step with its degenerate-spread skip and clipping, and
the ``get`` interpolation."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_planner
from assistedmanipulation_tpu.ops import sg_filter as jax_sg
from assistedmanipulation_tpu.parallel.flagship import (
    default_mppi_configuration as jax_default_configuration,
)
from assistedmanipulation_tpu_torch import mppi
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import CudaSampler, noise_from_logical
from assistedmanipulation_tpu_torch.kernels.philox import key_from_seed
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
)
from assistedmanipulation_tpu_torch.ops import sg_filter
from assistedmanipulation_tpu_torch.parallel.flagship import default_mppi_configuration
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

ROLLOUTS = 62
STEPS = 6
R = ROLLOUTS + 2


@pytest.fixture(scope="module")
def planners():
    jax_cfg = dataclasses.replace(
        jax_default_configuration(ROLLOUTS, STEPS, rng_impl="threefry2x32"), dtype="float64"
    )
    cfg = default_mppi_configuration(ROLLOUTS, STEPS, dtype="float64")
    sampler = CudaSampler(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
        cfg.rollout_count, cfg.step_count, cfg.time_step,
        np.sqrt(fr.DEFAULT_COVARIANCE), device="cpu",
    )
    planner = mppi.Planner(cfg, sampler, 12, device="cpu")
    return make_lanes_planner(jax_cfg), planner


def _states(costs, optimal, last_shift_time=0.0, sg_buffer=None, sg_time=np.nan, last_update_time=0.0):
    """The same planner state for both packages (noise irrelevant here)."""
    if sg_buffer is None:
        sg_buffer = np.zeros((12, STEPS + 21))
    jax_state = jax_mppi.PlannerState(
        optimal_control=jnp.asarray(optimal),
        noise=jnp.zeros((R, STEPS, 12)),
        costs=jnp.asarray(costs),
        last_shift_time=jnp.asarray(last_shift_time, jnp.float64),
        last_update_time=jnp.asarray(last_update_time, jnp.float64),
        sg_buffer=jnp.asarray(sg_buffer),
        sg_time=jnp.asarray(sg_time, jnp.float64),
        rng=jax.random.key_data(jax.random.key(0, impl="threefry2x32")),
        update_count=jnp.asarray(0, jnp.int32),
        optimal_cost=jnp.asarray(0.0, jnp.float64),
        update_duration=jnp.asarray(0.0, jnp.float64),
    )
    state = mppi.PlannerState(
        optimal_control=torch.tensor(optimal),
        noise=torch.zeros((STEPS, 12, R), dtype=torch.float64),
        costs=torch.tensor(costs),
        last_shift_time=torch.tensor(last_shift_time, dtype=torch.float64),
        last_update_time=torch.tensor(last_update_time, dtype=torch.float64),
        sg_buffer=torch.tensor(sg_buffer),
        sg_time=torch.tensor(sg_time, dtype=torch.float64),
        rng=key_from_seed(0),
        update_count=torch.tensor(0, dtype=torch.int32),
        optimal_cost=torch.tensor(0.0, dtype=torch.float64),
        update_duration=torch.tensor(0.0, dtype=torch.float64),
    )
    return jax_state, state


def _costs(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.stack([rng.integers(0, 3, R).astype(float), rng.uniform(10, 1000, R)], axis=1)
    if kind == "ties":
        return np.stack(
            [rng.integers(0, 2, R).astype(float), rng.choice([5.0, 7.5, 7.5, 9.0], R)], axis=1
        )
    if kind == "zero_violations":
        return np.stack([np.zeros(R), rng.choice([1.0, 2.0, 3.0], R)], axis=1)
    if kind == "nan":
        costs = np.stack([rng.integers(0, 2, R).astype(float), rng.uniform(0, 10, R)], axis=1)
        costs[rng.choice(R, 9, replace=False), 0] = np.nan
        costs[rng.choice(R, 9, replace=False), 1] = np.nan
        return costs
    if kind == "all_equal":
        return np.tile([0.0, 42.0], (R, 1))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "ties", "zero_violations", "nan", "all_equal"])
@pytest.mark.parametrize("time,last_shift", [(0.2, 0.15), (0.05, 0.05), (0.3, 0.0)])
def test_sample_meta_matches_jax(planners, kind, time, last_shift):
    jax_planner, planner = planners
    optimal = np.random.default_rng(1).normal(size=(STEPS, 12))
    jax_state, state = _states(_costs(kind), optimal, last_shift_time=last_shift)
    want = jax_planner._sample_meta(jax_state, jnp.asarray(time, jnp.float64))
    got = planner._sample_meta(state, torch.tensor(time, dtype=torch.float64))
    optimal_shifted, shift_by, do_shift, last_shift_time, keep_mask = got
    np.testing.assert_array_equal(keep_mask.numpy(), np.asarray(want[4]))
    assert int(keep_mask.sum()) == planner.keep_best
    assert not keep_mask[:2].any()
    assert int(shift_by) == int(want[1]) and bool(do_shift) == bool(want[2])
    assert float(last_shift_time) == float(want[3])
    np.testing.assert_array_equal(optimal_shifted.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shift_truncation_matches_jax(dtype):
    """The horizon shift truncates (time - last_shift) / dt in the planner's
    dtype with a true division, as JAX does; quotients a rounding away from
    an integer (float64 (0.3 - 0.27) / 0.01 = 2.999...) truncate alike."""
    from assistedmanipulation_tpu_torch.ops import true_divide

    pairs = [(0.2, 0.15), (0.3, 0.27), (0.07, 0.01), (1.13, 1.1), (0.05, 0.05)]
    for time, last in pairs:
        jt, jl = jnp.asarray(time, dtype), jnp.asarray(last, dtype)
        want = int(((jt - jl) / 0.01).astype(jnp.int32))
        t, l = (torch.tensor(x, dtype=getattr(torch, dtype)) for x in (time, last))
        assert int(true_divide(t - l, 0.01).to(torch.int32)) == want, (time, last)


def test_gram_weights_match_jax():
    for window, order in [(10, 1), (5, 2), (3, 0)]:
        np.testing.assert_array_equal(
            sg_filter.gram_weights(window, 0, order, 0), jax_sg.gram_weights(window, 0, order, 0)
        )


@pytest.mark.parametrize("shift", [0, 1, 3, STEPS])
def test_sg_smooth_matches_jax(shift):
    rng = np.random.default_rng(shift)
    smoother = sg_filter.SGSmoother(steps=STEPS, window=10, order=1)
    jax_smoother = jax_sg.SGSmoother(steps=STEPS, window=10, order=1)
    buffer = rng.normal(size=(12, smoother.buffer_length))
    controls = rng.normal(size=(STEPS, 12))
    got, got_buffer = sg_filter.sg_smooth(
        smoother, torch.tensor(buffer), torch.tensor(controls), torch.tensor(shift)
    )
    want, want_buffer = jax_sg.sg_smooth(
        jax_smoother, jnp.asarray(buffer), jnp.asarray(controls), jnp.asarray(shift)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_buffer.numpy(), np.asarray(want_buffer), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind", ["random", "nan", "all_equal", "clipped"])
def test_optimise_matches_jax(planners, kind):
    """Weights, gradient step, smoothing and clipping; "all_equal" is the
    degenerate spread (the update is skipped and the smoothing buffer kept),
    "clipped" drives the update past the control bounds."""
    jax_planner, planner = planners
    rng = np.random.default_rng(4)
    costs = _costs("nan" if kind == "nan" else "all_equal" if kind == "all_equal" else "random")
    scale = 400.0 if kind == "clipped" else 1.0
    noise = scale * rng.normal(size=(R, STEPS, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
    optimal_shifted = rng.normal(size=(STEPS, 12))
    sg_buffer = rng.normal(size=(12, STEPS + 21))
    want = jax_planner._optimise(
        jnp.asarray(costs), jnp.asarray(noise), jnp.asarray(optimal_shifted),
        jnp.asarray(sg_buffer), jnp.asarray(1),
    )
    got = planner._optimise(
        torch.tensor(costs), noise_from_logical(torch.tensor(noise)),
        torch.tensor(optimal_shifted), torch.tensor(sg_buffer), torch.tensor(1),
    )
    for name, g, w in zip(("optimal", "weights", "gradient", "sg_buffer"), got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12, err_msg=name)
    assert bool(got[4]) == bool(want[4]) == (kind == "all_equal")
    if kind == "all_equal":
        np.testing.assert_array_equal(got[0].numpy(), optimal_shifted)
        np.testing.assert_array_equal(got[3].numpy(), sg_buffer)
    if kind == "clipped":
        assert (np.abs(got[0].numpy()) == fr.DEFAULT_CONTROL_MAX).any()
    if kind == "nan":
        assert (got[1].numpy()[np.isnan(costs).any(axis=1)] == 0).all()


def test_get_interpolation_matches_jax(planners):
    jax_planner, planner = planners
    optimal = np.random.default_rng(9).normal(size=(STEPS, 12))
    jax_state, state = _states(_costs("random"), optimal, last_update_time=0.1)
    for time in (0.1, 0.1234, 0.149, 0.155, 0.2, 0.05):
        want = jax_planner._get_impl(jax_state, jnp.asarray(time, jnp.float64))
        got = planner.get(state, time)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=1e-15)


def test_planner_rejects_unported_modes():
    """Resimulate re-rolls through a filter_rollout_fn or a plant: a
    resimulate planner with neither is refused."""
    cfg = dataclasses.replace(
        default_mppi_configuration(ROLLOUTS, STEPS), optimal_rollout_mode="resimulate"
    )
    with pytest.raises(ValueError, match="'resimulate' needs a filter_rollout_fn"):
        mppi.Planner(cfg, None, 12, device="cpu")
    with pytest.raises(ValueError, match="covariance"):
        mppi.Planner(dataclasses.replace(cfg, covariance=None), None, 12, device="cpu")

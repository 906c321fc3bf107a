"""The slice as a whole: the port's flagship planner against the JAX one.

(a) Step by step at float32 against the JAX flagship (Pallas kernels in
    interpret mode): each update starts both packages from the same JAX
    state, carried across with interop.planner_state_from_numpy, and feeds
    the port the JAX update's own fresh draws. The fused flagship, the
    port's two-pass sampler against the JAX fused one, and the 3-scenario
    ensemble (two-pass on both sides).
(b) A free run at float64 against the JAX lanes planner: the two states
    evolve on their own, fed only the same fresh draws.
(c) The entry point needs CUDA unless the caller asks for the CPU.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_planner
from assistedmanipulation_tpu.models.model_data import (
    frankaridgeback_model as jax_model,
)
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu.parallel.flagship import (
    build_flagship as jax_build_flagship,
    default_mppi_configuration as jax_default_configuration,
)
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import noise_to_logical
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TIMES = [0.0, 0.01, 0.02, 0.05, 0.05, 0.06]  # shifts of 0, 1, 1, 3, 0, 1 slots


def _jax_fresh(rng_words, shape, scale, impl, lane_layout, shards=1):
    """The fresh draws the JAX update will make from its state's key
    (mppi.py:466-468 split, then pallas_rollout.py:1343-1350 or
    mppi.py:486-488), computed under jit so the bits match the planner's.
    In the lane layout, shard i of ``shards`` draws its G / shards tiles from
    ``fold_in(key, i)`` (pallas_rollout.py:1338-1350)."""

    @jax.jit
    def draw(words):
        _, key = jax.random.split(jax.random.wrap_key_data(words, impl=impl))
        if lane_layout:
            local = (shape[0] // shards, *shape[1:])
            return jnp.concatenate([
                jax.random.normal(jax.random.fold_in(key, jnp.asarray(i, jnp.int32)), local, scale.dtype)
                * scale[None, None, :, None, None]
                for i in range(shards)
            ])
        return jax.random.normal(key, shape, scale.dtype) * scale

    return draw(rng_words)


def _step_by_step(jax_flagship, flagships, times, shards=1):
    """Each update: both packages from the same JAX state and fresh draws,
    every port flagship in ``flagships`` held to the JAX update at float32
    (noise bitwise, violations exact, the rest at the tolerances below).
    ``shards``: the JAX sampler's ``sampler_shards``. Returns the port
    flagships' last (state, info) pairs."""
    R = jax_flagship.planner.rollout_count
    jax_ctx = jax_flagship.make_ctx()
    scale = jnp.asarray(np.sqrt(fr.DEFAULT_COVARIANCE), jnp.float32)
    jax_state = jax_flagship.init(seed=0)
    for time in times:
        arrays = {name: np.asarray(value) for name, value in jax_state._asdict().items()}
        fresh = interop.lane_noise_to_logical(
            np.asarray(_jax_fresh(jax_state.rng, jax_state.noise.shape, scale, "threefry2x32", True, shards)),
            R, shards,
        )
        jax_state, jax_info = jax_flagship.update(jax_state, jax_flagship.x0, time, jax_ctx)
        outs = []
        for flagship in flagships:
            state = interop.planner_state_from_numpy(arrays, R, device="cpu", shards=shards)
            outs.append(flagship.update(state, flagship.x0, time, flagship.make_ctx(), fresh=fresh))
            _check_update(*outs[-1], jax_state, jax_info, R, shards)
    return outs


def _check_update(state, info, jax_state, jax_info, R, shards=1):
    want_noise = interop.lane_noise_to_logical(np.asarray(jax_state.noise), R, shards)
    np.testing.assert_array_equal(
        noise_to_logical(state.noise).numpy().view(np.int32), want_noise.view(np.int32)
    )
    want_costs = np.asarray(jax_state.costs)
    np.testing.assert_array_equal(state.costs.numpy()[:, 0], want_costs[:, 0])
    np.testing.assert_allclose(state.costs.numpy(), want_costs, rtol=2e-5, atol=2e-5)
    # Weights are exp(-10 relative / spread): the costs' 2e-5 relative
    # agreement becomes ~1e-5 absolute here, and the weighted sum of
    # ~2.7-sigma noise carries that into the controls (range +-100).
    np.testing.assert_allclose(info.weights.numpy(), np.asarray(jax_info.weights), atol=1e-5)
    np.testing.assert_allclose(
        state.optimal_control.numpy(), np.asarray(jax_state.optimal_control), rtol=1e-5, atol=2e-4
    )
    np.testing.assert_allclose(
        info.optimal_rollout_states.numpy(), np.asarray(jax_info.optimal_rollout_states),
        rtol=1e-6, atol=2e-6,
    )
    assert bool(info.degenerate) == bool(jax_info.degenerate) is False
    for name in ("last_shift_time", "last_update_time", "sg_time", "update_count"):
        assert float(getattr(state, name)) == float(getattr(jax_state, name)), name
    np.testing.assert_allclose(
        state.sg_buffer.numpy(), np.asarray(jax_state.sg_buffer), rtol=1e-5, atol=2e-4
    )


def test_flagship_step_by_step_matches_jax_fused_f32():
    steps, rollouts = 6, 254
    jax_flagship = jax_build_flagship(
        rollouts=rollouts, steps=steps, backend="pallas", sublanes=1,
        interpret=True, rng_impl="threefry2x32",
    )
    _step_by_step(jax_flagship, [build_flagship(rollouts=rollouts, steps=steps, device="cpu")], TIMES)


def test_two_pass_flagship_matches_jax_fused_flagship():
    """The port's two-pass sampler (fused_assembly=False) against the JAX
    fused flagship, and bitwise against the port's fused one."""
    steps, rollouts = 6, 126
    jax_flagship = jax_build_flagship(
        rollouts=rollouts, steps=steps, backend="pallas", sublanes=1,
        interpret=True, rng_impl="threefry2x32",
    )
    fused, two_pass = _step_by_step(
        jax_flagship,
        [build_flagship(rollouts=rollouts, steps=steps, device="cpu", fused_assembly=fused)
         for fused in (True, False)],
        TIMES[:3],
    )
    for got, want in zip(two_pass, fused):
        for name in got._fields:
            if isinstance(getattr(got, name), torch.Tensor):
                assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_scenario_flagship_step_by_step_matches_jax():
    """BASELINE config 5 on one device: 3 forecast scenarios, the two-pass
    sampler on both sides, costs the scenario mean."""
    steps, rollouts = 6, 126
    jax_flagship = jax_build_flagship(
        rollouts=rollouts, steps=steps, backend="pallas", scenarios=3, sublanes=1,
        interpret=True, rng_impl="threefry2x32",
    )
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", scenarios=3)
    assert not flagship.planner.sampler.fused_assembly
    assert flagship.make_ctx().wrench_horizon.shape == (3, steps + 1, 6)
    np.testing.assert_array_equal(
        flagship.make_ctx().wrench_horizon.numpy(), np.asarray(jax_flagship.make_ctx().wrench_horizon)
    )
    _step_by_step(jax_flagship, [flagship], TIMES[:3])


def test_fused_sampler_refuses_a_scenario_ensemble():
    with pytest.raises(ValueError, match="two-pass"):
        build_flagship(rollouts=14, steps=3, device="cpu", scenarios=2, fused_assembly=True)
    fused = build_flagship(rollouts=14, steps=3, device="cpu")
    ensemble = build_flagship(rollouts=14, steps=3, device="cpu", scenarios=2).make_ctx()
    with pytest.raises(ValueError, match="fused_assembly cannot score"):
        fused.update(fused.init(seed=0), fused.x0, 0.0, ensemble)


def test_flagship_free_run_matches_jax_lanes_planner_f64():
    steps, rollouts, updates = 6, 62, 10
    R = rollouts + 2
    jax_cfg = dataclasses.replace(
        jax_default_configuration(rollouts, steps, rng_impl="threefry2x32"), dtype="float64"
    )
    jax_planner = make_lanes_planner(jax_cfg)
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", dtype="float64")
    # A forecast whose end (0.095 s) falls between rollout step times: XLA
    # fuses t0 + k * dt into one FMA under jit, so a step time on the
    # horizon's end could land on either side of it.
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 20.0
    wrench[:, 2] = np.linspace(0.0, -6.0, 11)
    jax_ctx = JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float64), 0.01, 0.095)
    ctx = ForecastContext(torch.tensor(wrench), torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095)
    x0 = fr.make_state("huddled")
    scale = jnp.asarray(np.sqrt(fr.DEFAULT_COVARIANCE), jnp.float64)
    jax_state = jax_planner.init(seed=0)
    state = flagship.init(seed=0)
    times = [0.01 * k for k in range(updates - 2)] + [0.12, 0.12]
    for time in times:
        fresh = np.asarray(_jax_fresh(jax_state.rng, (R, steps, 12), scale, "threefry2x32", False))
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx)
        state, info = flagship.update(state, torch.tensor(x0), time, ctx, fresh=fresh)
        np.testing.assert_allclose(
            state.optimal_control.numpy(), np.asarray(jax_state.optimal_control), rtol=0, atol=1e-8
        )
        np.testing.assert_array_equal(state.costs.numpy()[:, 0], np.asarray(jax_state.costs)[:, 0])
        assert bool(info.degenerate) == bool(jax_info.degenerate)
    assert int(state.update_count) == updates


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(rollouts=14, steps=3, device="cuda")


def test_cpu_flagship_runs_the_plain_path():
    """On the CPU the planner runs the plain rollout: finite, bounded
    controls, the published optimal rollout starts at x0, and no kernel
    launch is counted."""
    cuda_rollout.reset_launch_counts()
    flagship = build_flagship(rollouts=30, steps=4, device="cpu")
    state, ctx = flagship.init(seed=1), flagship.make_ctx()
    for time in (0.0, 0.01, 0.02):
        state, info = flagship.update(state, flagship.x0, time, ctx)
    control = flagship.planner.get(state, 0.025).numpy()
    assert np.isfinite(state.optimal_control.numpy()).all()
    assert (np.abs(control) <= fr.DEFAULT_CONTROL_MAX).all()
    np.testing.assert_array_equal(info.optimal_rollout_states[0].numpy(), flagship.x0.numpy())
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 0


def test_interop_round_trips():
    model = interop.model_from_numpy(jax_model())
    ours = frankaridgeback_model()
    for field in dataclasses.fields(model):
        a, b = getattr(model, field.name), getattr(ours, field.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for name in a:
                assert a[name][0] == b[name][0]
                np.testing.assert_array_equal(a[name][1], b[name][1])
                np.testing.assert_array_equal(a[name][2], b[name][2])
        else:
            assert a == b

    flagship = build_flagship(rollouts=10, steps=3, device="cpu")
    state, _ = flagship.update(flagship.init(seed=2), flagship.x0, 0.0, flagship.make_ctx())
    arrays = interop.planner_state_to_numpy(state)
    assert arrays["noise"].shape == (12, 3, 12)
    back = interop.planner_state_from_numpy(arrays, 12, device="cpu")  # the key included
    for name, value in arrays.items():
        got = interop.planner_state_to_numpy(back)[name]
        np.testing.assert_array_equal(got, value, err_msg=name)

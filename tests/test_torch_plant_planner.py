"""The port's plant planner against the JAX package, at float64 on the CPU.

(a) The generic planner (``mppi.Planner(configuration, plant)``, the
    flagship's ``backend="vmap"``: the plant rolled out over the batch in
    plain PyTorch) against the JAX ``Planner(configuration, plant)``, fed
    the same ``noise_override`` for 4 updates, in both optimal-rollout
    modes: every state field and info output within 1e-9.
(b) The Franka parity replay through the port
    (scripts/torch_parity_replay.run_franka, the protocol of
    scripts/parity_replay.run_franka): the port's float64
    reference-pipeline replayer (parity.py) over the port's plant records
    its noise, the port's planner is fed it; from the out-of-bounds
    joint_limit preset, so barrier saturation and NaN-poisoned rollouts are
    live. control_seq_max_error < 2e-6, the bound of
    tests/test_reference_replay.py (the reference's own serial float64
    accumulation rounds the smooth cost at ulp(V * 1e10)).
    tests/test_torch_parity.py runs the replays at the sizes of
    tests/test_reference_replay.py.
(c) The kernel-path flagship with the safety filter
    (``build_flagship(safety=True)``, the plain kernel versions on the CPU)
    against the JAX lanes planner with ``filter_fn=make_safety_filter()``,
    fed the JAX planner's own fresh draws: 3 updates within 1e-8.

Tolerances: |port - jax| <= tol * max(|jax|, 1).
"""

import dataclasses
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_planner
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    AssistedManipulation as JaxObjective,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu.parallel.flagship import default_mppi_configuration as jax_default_configuration
from assistedmanipulation_tpu.safety import make_safety_filter as jax_make_safety_filter
from assistedmanipulation_tpu_torch import mppi
from assistedmanipulation_tpu_torch.kernels import build
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import noise_to_logical
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation, ForecastContext
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scripts.torch_parity_replay as replay  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def close(port, want, tol, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want, dtype=np.float64)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(port), nan, err_msg=what)
    err = np.abs(port[~nan] - want[~nan])
    assert (err <= tol * np.maximum(np.abs(want[~nan]), 1.0)).all(), (what, float(err.max()))


def _wrench():
    """A forecast whose end (0.095 s) falls between rollout step times: XLA
    fuses t0 + k * dt into one FMA under jit, so a step time on the
    horizon's end could land on either side of it."""
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 20.0
    wrench[:, 2] = np.linspace(0.0, -6.0, 11)
    return (
        ForecastContext(torch.tensor(wrench), torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095),
        JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float64), 0.01, 0.095),
    )


@pytest.mark.parametrize("mode", ["batch", "resimulate"])
def test_vmap_planner_matches_jax(mode):
    steps, rollouts = 6, 22
    R = rollouts + 2
    configuration = dict(
        rollouts=rollouts, keep_best_rollouts=5, time_step=0.01, horizon=steps * 0.01,
        covariance=fr.DEFAULT_COVARIANCE, control_min=fr.DEFAULT_CONTROL_MIN,
        control_max=fr.DEFAULT_CONTROL_MAX, control_default=np.zeros(12),
        smoothing=None, dtype="float64", optimal_rollout_mode=mode,
    )
    jax_planner = jax_mppi.Planner(
        jax_mppi.Configuration(**{**configuration, "smoothing": jax_mppi.Smoothing(10, 1)}),
        jax_fr.make_plant(JaxObjective()),
    )
    planner = mppi.Planner(
        mppi.Configuration(**{**configuration, "smoothing": mppi.Smoothing(10, 1)}),
        fr.make_plant(AssistedManipulation()), device="cpu",
    )
    ctx, jax_ctx = _wrench()
    x0 = fr.make_state("huddled")
    rng = np.random.default_rng(5)
    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    for time in (0.0, 0.01, 0.03, 0.03):
        override = rng.standard_normal((R - 2, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx, noise_override=override)
        state, info = planner.update(state, x0, time, ctx, noise_override=override)
        # Row 1 is the negated last control; the sampled rows are the override.
        close(noise_to_logical(state.noise), jax_state.noise, 1e-9, "noise")
        np.testing.assert_array_equal(noise_to_logical(state.noise)[2:].numpy(), override)
        for name in ("optimal_control", "costs", "last_shift_time", "last_update_time", "sg_buffer",
                     "sg_time", "update_count", "optimal_cost"):
            close(getattr(state, name), getattr(jax_state, name), 1e-9, name)
        for name in jax_info._fields:
            close(getattr(info, name), getattr(jax_info, name), 1e-9, f"info.{name}")


def test_franka_parity_replay_through_the_port():
    """scripts/torch_parity_replay.run_franka at float64 on the CPU: the
    port's replayer and plant against the port's planner."""
    result = replay.run_franka(updates=3, rollouts=10, dtype="float64", device="cpu")
    assert result["nan_poisoned_rollouts"] > 0 and result["saturated_rollouts"] > 0, result
    assert result["control_seq_max_error"] < 2e-6, result


def _jax_fresh(words, shape, scale):
    """The draws the JAX logical planner makes from its state's key
    (mppi.py:466-488)."""

    @jax.jit
    def draw(words):
        _, key = jax.random.split(jax.random.wrap_key_data(words, impl="threefry2x32"))
        return jax.random.normal(key, shape, jnp.float64) * scale

    return np.asarray(draw(words))


def test_safety_flagship_matches_jax_lanes_planner_with_the_filter():
    steps, rollouts = 6, 30
    R = rollouts + 2
    jax_cfg = dataclasses.replace(
        jax_default_configuration(rollouts, steps, rng_impl="threefry2x32"), dtype="float64"
    )
    jax_planner = make_lanes_planner(jax_cfg, filter_fn=jax_make_safety_filter())
    build.reset_launch_counts()
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", dtype="float64", safety=True)
    ctx, jax_ctx = _wrench()
    x0 = fr.make_state("huddled")
    scale = np.sqrt(fr.DEFAULT_COVARIANCE)
    jax_state, state = jax_planner.init(seed=0), flagship.init(seed=0)
    for time in (0.0, 0.01, 0.03):
        fresh = _jax_fresh(jax_state.rng, (R, steps, 12), scale)
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, jax_ctx)
        state, info = flagship.update(state, torch.tensor(x0), time, ctx, fresh=fresh)
        close(state.optimal_control, jax_state.optimal_control, 1e-8, "optimal_control")
        close(state.optimal_cost, jax_state.optimal_cost, 1e-8, "optimal_cost")
        close(info.optimal_rollout_states, jax_info.optimal_rollout_states, 1e-8, "optimal states")
        np.testing.assert_array_equal(state.costs.numpy()[:, 0], np.asarray(jax_state.costs)[:, 0])
    # The filter moved the published sequence off the unfiltered update's.
    plain = build_flagship(rollouts=rollouts, steps=steps, device="cpu", dtype="float64")
    fresh = 3.0 * np.random.default_rng(7).standard_normal((R, steps, 12)) * scale
    unfiltered, _ = plain.update(plain.init(seed=0), torch.tensor(x0), 0.0, ctx, fresh=fresh)
    filtered, _ = flagship.update(flagship.init(seed=0), torch.tensor(x0), 0.0, ctx, fresh=fresh)
    assert (unfiltered.optimal_control - filtered.optimal_control).abs().max() > 1e-3
    assert all(count == 0 for count in build.LAUNCHES.values())


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for options in ({"safety": True}, {"backend": "vmap"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_flagship(rollouts=6, steps=3, **options)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            build_flagship(rollouts=6, steps=3, device="cpu", capture=True, **options)
    with pytest.raises(ValueError, match="unknown backend"):
        build_flagship(rollouts=6, steps=3, device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="vmap backend has none"):
        build_flagship(rollouts=6, steps=3, device="cpu", backend="vmap", inkernel_rng=True)


def test_vmap_flagship_matches_the_kernel_path_and_scores_an_ensemble():
    """The vmap flagship publishes what the kernel path's plain version does
    from the same draws (both float64), and with a 3-scenario ensemble the
    scenario-mean costs of make_scenario_rollout_fn."""
    steps, rollouts = 4, 14
    R = rollouts + 2
    rng = np.random.default_rng(6)
    for scenarios in (1, 3):
        vmap = build_flagship(rollouts, steps, device="cpu", dtype="float64", backend="vmap", scenarios=scenarios)
        kernel = build_flagship(rollouts, steps, device="cpu", dtype="float64", scenarios=scenarios)
        states = [vmap.init(seed=0), kernel.init(seed=0)]
        for time in (0.0, 0.01):
            fresh = rng.standard_normal((R, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
            (v_state, v_info), (k_state, k_info) = (
                f.update(s, f.x0, time, f.make_ctx(), fresh=fresh) for f, s in zip((vmap, kernel), states)
            )
            states = [v_state, k_state]
            close(v_state.costs, k_state.costs.numpy(), 1e-9, f"costs x{scenarios}")
            close(v_state.optimal_control, k_state.optimal_control.numpy(), 1e-9, f"control x{scenarios}")
            close(v_info.optimal_rollout_states, k_info.optimal_rollout_states.numpy(), 1e-9, "states")

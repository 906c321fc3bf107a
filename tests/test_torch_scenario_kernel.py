"""The two-pass rollout at C forecast scenarios in one call (plain PyTorch
version of csrc/rollout.cu with (C, S, 8) tables) against the JAX package's
scenario path, the batched step tables, the scenario mean and the wrapper's
limits.

The JAX side runs its two-pass Pallas kernel as tests/test_pallas_rollout.py
does: interpret mode, one sublane, one kernel call per scenario and the
scenario mean (PallasSampler._scenario_costs_padded). Both sides get the
same controls and wrench ensemble, made from a numpy seed. Tolerances as
tests/test_torch_two_pass.py states them: float32 costs within rtol/atol
2e-5, states within 2e-6, violation counts exact; float64 against the JAX
lanes rollout under make_scenario_rollout_fn, rtol 1e-9. The batched tables
and the sampler's one-call scenario path are held bitwise to the
one-scenario forms they replace.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.forecast.scenarios import (
    make_scenario_rollout_fn as jax_make_scenario_rollout_fn,
)
from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_rollout_fn
from assistedmanipulation_tpu.kernels.pallas_rollout import PallasSampler
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.forecast.kalman import KalmanState
from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import (
    RolloutSpec,
    initial_state,
    noise_from_logical,
    rollout,
    rollout_reference,
    step_table,
)
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
    scenario_contexts,
)
from assistedmanipulation_tpu_torch.ops.sg_filter import SGSmoother
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

DT = 0.01
TIME = 0.02


def _spec():
    return RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)


def _inputs(rollouts, steps, scenarios, dtype, seed):
    """Noise (R, S, 12) with rollout 0 the zero-noise static rollout, the
    shifted optimal (S, 12), x0 and a (C, S+1, 6) wrench ensemble around a
    25 N x-pull."""
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal((rollouts, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)).astype(dtype)
    noise[0] = 0.0
    optimal_shifted = (0.3 * rng.standard_normal((steps, 12))).astype(dtype)
    x0 = fr.make_state("huddled").astype(dtype)
    horizons = np.zeros((scenarios, steps + 1, 6))
    horizons[:, :, 0] = 25.0
    horizons += 8.0 * rng.standard_normal((scenarios, steps + 1, 6))
    return noise, optimal_shifted, x0, horizons.astype(dtype)


def _ctx(horizons, steps, horizon=None):
    h = torch.tensor(horizons)
    return ForecastContext(h, torch.zeros((), dtype=h.dtype), DT, steps * DT if horizon is None else horizon)


def _port_scenarios(noise, optimal_shifted, x0, horizons, steps):
    """(C, R, 2) costs and (S, 24) states of the plain version on the
    (C, S, 8) tables of the ensemble."""
    tx0 = torch.tensor(x0)
    tables = step_table(ObjectiveConfiguration(), steps, DT, 1.0, tx0, torch.tensor(TIME, dtype=tx0.dtype),
                        _ctx(horizons, steps))
    assert tables.shape == (horizons.shape[0], steps, 8)
    controls = noise_from_logical(torch.tensor(noise + optimal_shifted[None]))
    return rollout(_spec(), initial_state(tx0), tables, controls)


def test_scenario_plain_version_matches_jax_two_pass_kernel_f32():
    """Each scenario's costs against the JAX two-pass kernel on that
    scenario, the mean against its scenario path, and the states."""
    steps, rollouts, count = 4, 9, 3
    noise, optimal_shifted, x0, horizons = _inputs(rollouts, steps, count, np.float32, seed=21)
    sampler = PallasSampler(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(),
        rollout_count=rollouts, steps=steps, dt=DT,
        diag_scale=np.sqrt(np.asarray(jax_fr.DEFAULT_COVARIANCE)),
        sublanes=1, interpret=True, emit_states=True,
    )
    padded = np.zeros((sampler.grid * 128, steps, 12), np.float32)
    padded[:rollouts] = noise + optimal_shifted[None]
    lanes = jnp.asarray(padded.reshape(sampler.grid, 1, 128, steps, 12).transpose(0, 3, 4, 1, 2))
    jctx = JaxForecastContext(jnp.asarray(horizons), jnp.asarray(0.0, jnp.float32), DT, steps * DT)
    time = jnp.asarray(TIME, jnp.float32)
    want_mean, want_states = sampler._scenario_costs_padded(lanes, jnp.asarray(x0), time, jctx, sharded=False)

    costs, states = _port_scenarios(noise, optimal_shifted, x0, horizons, steps)
    assert costs.shape == (count, rollouts, 2) and states.shape == (steps, 24)
    for c in range(count):
        want, _ = sampler._costs_padded(lanes, jnp.asarray(x0), time, jctx._replace(wrench_horizon=jctx.wrench_horizon[c]))
        want = np.asarray(want)[:rollouts]
        np.testing.assert_array_equal(costs[c].numpy()[:, 0], want[:, 0])
        np.testing.assert_allclose(costs[c].numpy(), want, rtol=2e-5, atol=2e-5)
    want_mean = np.asarray(want_mean)[:rollouts]
    np.testing.assert_array_equal(costs.mean(dim=0).numpy()[:, 0], want_mean[:, 0])
    np.testing.assert_allclose(costs.mean(dim=0).numpy(), want_mean, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states)[:, :, 0, 0], rtol=1e-6, atol=2e-6)


def test_scenario_mean_matches_jax_lanes_scenario_fn_f64():
    steps, rollouts, count = 5, 6, 4
    noise, optimal_shifted, x0, horizons = _inputs(rollouts, steps, count, np.float64, seed=22)
    lanes_fn = make_lanes_rollout_fn(jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), steps, DT)
    jctx = JaxForecastContext(jnp.asarray(horizons), jnp.asarray(0.0), DT, steps * DT)
    want_costs, want_states = jax_make_scenario_rollout_fn(lanes_fn)(
        jnp.asarray(noise), jnp.asarray(optimal_shifted), jnp.asarray(x0), jnp.asarray(TIME), jctx
    )
    costs, states = _port_scenarios(noise, optimal_shifted, x0, horizons, steps)
    np.testing.assert_array_equal(costs.mean(dim=0).numpy()[:, 0], np.asarray(want_costs)[:, 0])
    np.testing.assert_allclose(costs.mean(dim=0).numpy(), np.asarray(want_costs), rtol=1e-9)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states)[:, :24], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_tables_equal_stacked_one_scenario_tables(dtype):
    """One batched pass over the (C, S+1, 6) ensemble gives bitwise the
    tables of C one-scenario calls, with a forecast that ends inside the
    horizon and a time between cached steps."""
    steps, count = 7, 4
    _, _, x0, horizons = _inputs(1, steps, count, dtype, seed=23)
    tx0 = torch.tensor(x0)
    time = torch.tensor(0.013, dtype=tx0.dtype)
    ctx = _ctx(horizons, steps, horizon=(steps - 2.5) * DT)
    tables = step_table(ObjectiveConfiguration(), steps, DT, 0.97, tx0, time, ctx)
    singles = torch.stack([
        step_table(ObjectiveConfiguration(), steps, DT, 0.97, tx0, time, one) for one in scenario_contexts(ctx)
    ])
    assert tables.shape == (count, steps, 8) and tables.dtype == tx0.dtype
    assert torch.equal(tables, singles)
    assert bool((tables[:, -2:, cuda_rollout.COL_INV2] == 0).all())  # past the forecast's end
    assert bool((tables[:, 0, cuda_rollout.COL_INV2] > 0).all())


def test_one_scenario_through_the_new_signature_is_the_single_forecast_rollout():
    steps, rollouts = 4, 11
    noise, optimal_shifted, x0, horizons = _inputs(rollouts, steps, 1, np.float32, seed=24)
    tx0 = torch.tensor(x0)
    table = step_table(ObjectiveConfiguration(), steps, DT, 1.0, tx0, torch.tensor(TIME), _ctx(horizons[0], steps))
    controls = noise_from_logical(torch.tensor(noise + optimal_shifted[None]))
    costs, states = rollout_reference(_spec(), initial_state(tx0), table[None], controls)
    want_costs, want_states = rollout_reference(_spec(), initial_state(tx0), table, controls)
    assert costs.shape == (1, rollouts, 2)
    assert torch.equal(costs[0], want_costs) and torch.equal(states, want_states)


def test_sampler_scores_the_ensemble_in_one_call_as_per_scenario_calls():
    """The two-pass sampler's one call over the (C, S, 8) tables gives
    bitwise the mean of C one-scenario rollouts of the same controls, and
    scenario 0's states."""
    steps, rollouts, count = 4, 14, 3
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", scenarios=count)
    sampler, R = flagship.planner.sampler, flagship.planner.rollout_count
    rng = np.random.default_rng(25)
    fresh = torch.tensor((rng.standard_normal((steps, 12, R)) * 0.3).astype(np.float32))
    old = torch.tensor((rng.standard_normal((steps, 12, R)) * 0.3).astype(np.float32))
    optimal = torch.tensor((0.2 * rng.standard_normal((steps, 12))).astype(np.float32))
    keep = torch.tensor(rng.random(R) < 0.3)
    ctx, x0, time = flagship.make_ctx(), flagship.x0, torch.tensor(0.01)
    costs, noise, states = sampler.sample_and_rollout(
        None, keep, torch.tensor(1), torch.tensor(True), old, optimal, optimal.roll(1, 0), x0, time, ctx, fresh=fresh,
    )
    controls = noise + optimal.roll(1, 0)[:, :, None]
    scored = [
        rollout_reference(sampler.spec, initial_state(x0),
                          step_table(ObjectiveConfiguration(), steps, DT, 1.0, x0, time, one), controls)
        for one in scenario_contexts(ctx)
    ]
    assert torch.equal(costs, torch.stack([c for c, _ in scored]).mean(dim=0))
    assert torch.equal(states[:, :24], scored[0][1])


def test_nan_in_one_scenario_poisons_only_that_rollouts_mean(monkeypatch):
    """A NaN in one scenario's cost of one rollout reaches that rollout's
    mean and no other, as jnp.mean over the scenario axis gives it
    (pallas_rollout.py:1125)."""
    steps, rollouts, count = 3, 14, 3
    flagship = build_flagship(rollouts=rollouts, steps=steps, device="cpu", scenarios=count)
    sampler, R = flagship.planner.sampler, flagship.planner.rollout_count
    injected = []

    def poisoned(spec, init, table, controls):
        costs, states = rollout_reference(spec, init, table, controls)
        costs = costs.clone()
        costs[1, 5, 1] = float("nan")
        injected.append(costs)
        return costs, states

    monkeypatch.setattr(cuda_rollout, "rollout", poisoned)
    fresh = torch.tensor(np.random.default_rng(26).standard_normal((steps, 12, R)).astype(np.float32) * 0.3)
    costs, _, _ = sampler.sample_and_rollout(
        None, torch.zeros(R, dtype=torch.bool), torch.tensor(0), torch.tensor(False), sampler.init_noise(torch.float32),
        torch.zeros((steps, 12)), torch.zeros((steps, 12)), flagship.x0, torch.tensor(0.0), flagship.make_ctx(),
        fresh=fresh,
    )
    assert len(injected) == 1  # one call for the whole ensemble
    want = np.asarray(jnp.mean(jnp.asarray(injected[0].numpy()), axis=0))
    assert np.array_equal(np.isnan(costs.numpy()), np.isnan(want))
    assert np.isnan(costs.numpy()).sum() == 1 and np.isnan(costs.numpy()[5, 1])
    np.testing.assert_allclose(costs.numpy(), want, rtol=1e-6)


def test_wrapper_refuses_scenarios_beyond_shared_memory_or_the_compiled_maximum():
    R = 3

    def check(scenarios, steps):
        cuda_rollout._check_rollout_inputs(
            torch.zeros(32), torch.zeros((scenarios, steps, 8)), torch.zeros((steps, 12, R))
        )

    check(cuda_rollout.MAX_SCENARIOS, 859)  # 6,872 of the 6,878 rows of 32 B beside the state ring
    check(4, 1719)
    with pytest.raises(ValueError, match="shared memory"):
        check(cuda_rollout.MAX_SCENARIOS, 860)
    with pytest.raises(ValueError, match="shared memory"):
        check(4, 1720)
    with pytest.raises(ValueError, match="compiled for 1 to 8"):
        check(cuda_rollout.MAX_SCENARIOS + 1, 4)
    with pytest.raises(ValueError, match="compiled for"):
        check(0, 4)
    with pytest.raises(ValueError, match="shape"):
        cuda_rollout._check_rollout_inputs(torch.zeros(32), torch.zeros((2, 5, 8)), torch.zeros((4, 12, R)))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The three functions that once defaulted to the CPU now default to
    the card, as every entry point does, and raise without one."""
    flagship = build_flagship(rollouts=10, steps=3, device="cpu")
    state, _ = flagship.update(flagship.init(seed=2), flagship.x0, 0.0, flagship.make_ctx())
    planner_arrays = {**interop.planner_state_to_numpy(state), "rng": np.zeros(2, np.uint32)}
    forecast_arrays = {
        "filter": {name: np.zeros(2) for name in KalmanState._fields},
        "measurement": np.zeros(6), "prediction": np.zeros((4, 6)), "last_update": np.zeros(()),
    }
    smoother = SGSmoother(steps=5, window=2, order=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (
        lambda **device: interop.planner_state_from_numpy(planner_arrays, 12, **device),
        lambda **device: interop.forecast_state_from_numpy(forecast_arrays, **device),
        lambda **device: smoother.init_buffer(12, **device),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        out = call(device="cpu")
        leaves = [out] if isinstance(out, torch.Tensor) else [
            value for value in out._asdict().values() if isinstance(value, torch.Tensor)
        ]
        assert leaves and all(leaf.device.type == "cpu" for leaf in leaves)

"""The port's fused sample+rollout (plain PyTorch version) against the JAX
fused Pallas sampler and the JAX lanes rollout.

The JAX side runs its Pallas kernel as tests/test_pallas_rollout.py does:
interpret mode, one sublane. Both sides get the same old noise, fresh
draws, keep mask, shift and optimal sequences, made from a numpy seed.
Tolerances: the assembled noise is a chain of selects, so it must match
bitwise; float32 costs within rtol/atol 2e-5 (the JAX suite's own bound
between its Pallas and lanes paths), float32 states within 2e-6 (XLA's and
PyTorch's float32 sin/cos differ by an ulp, and the difference grows over
the horizon's steps); at float64 against the lanes path, rtol 1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_rollout_fn
from assistedmanipulation_tpu.kernels.pallas_rollout import PallasSampler
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import (
    frankaridgeback_model as jax_model,
)
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu_torch.interop import lane_noise_to_logical
from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import (
    CudaSampler,
    RolloutSpec,
    fused_sample_rollout,
    noise_from_logical,
    noise_to_logical,
    rollout_inputs,
)
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 6
DT = 0.01
R = 200  # not a multiple of the JAX tile: exercises its padding
TIME = 0.02


def _logical_to_lane(x: np.ndarray, grid: int) -> np.ndarray:
    """(R, S, 12) -> the JAX sampler's (G, S, 12, 1, 128) lane layout."""
    padded = np.zeros((grid * 128,) + x.shape[1:], x.dtype)
    padded[: x.shape[0]] = x
    return padded.reshape(grid, 1, 128, *x.shape[1:]).transpose(0, 3, 4, 1, 2)


def _contexts(dtype):
    wrench = np.zeros((STEPS + 1, 6))
    wrench[:, 0] = 25.0
    wrench[:, 1] = np.linspace(-5.0, 5.0, STEPS + 1)
    jctx = JaxForecastContext(
        jnp.asarray(wrench, dtype), jnp.asarray(0.0, dtype), DT, STEPS * DT
    )
    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64
    ctx = ForecastContext(
        torch.tensor(wrench, dtype=tdtype), torch.zeros((), dtype=tdtype), DT, STEPS * DT
    )
    return jctx, ctx


@pytest.fixture(scope="module")
def jax_sampler():
    sampler = PallasSampler(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(),
        rollout_count=R, steps=STEPS, dt=DT,
        diag_scale=np.sqrt(np.asarray(jax_fr.DEFAULT_COVARIANCE)),
        sublanes=1, interpret=True, fused_assembly=True, emit_states=True,
    )

    @jax.jit
    def fused(old, fresh, keep, shift, do_shift, optimal, optimal_shifted, x0, time, ctx):
        costs, noise, states = sampler._fused_sample_costs(
            old, fresh, keep, shift, do_shift, jnp.asarray(True), optimal,
            optimal_shifted, x0, time, ctx,
        )
        return costs, noise, sampler._assemble_states(states, x0)

    return sampler, fused


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    scale = np.sqrt(fr.DEFAULT_COVARIANCE)
    old = (rng.standard_normal((R, STEPS, 12)) * scale).astype(np.float32)
    fresh = (rng.standard_normal((R, STEPS, 12)) * scale).astype(np.float32)
    keep = rng.random(R) < 0.3
    keep[:2] = False  # statics are never kept
    optimal = (0.3 * rng.standard_normal((STEPS, 12))).astype(np.float32)
    optimal_shifted = (0.3 * rng.standard_normal((STEPS, 12))).astype(np.float32)
    x0 = fr.make_state("huddled").astype(np.float32)
    return old, fresh, keep, optimal, optimal_shifted, x0


@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False), (STEPS, True)])
def test_plain_fused_rollout_matches_jax_fused_sampler(jax_sampler, inputs, shift, do_shift):
    old, fresh, keep, optimal, optimal_shifted, x0 = inputs
    jctx, ctx = _contexts(jnp.float32)
    sampler, fused = jax_sampler
    grid = sampler.grid
    jcosts, jnoise, jstates = fused(
        jnp.asarray(_logical_to_lane(old, grid)),
        jnp.asarray(_logical_to_lane(fresh, grid)),
        jnp.asarray(keep),
        jnp.asarray(shift, jnp.int32),
        jnp.asarray(do_shift),
        jnp.asarray(optimal),
        jnp.asarray(optimal_shifted),
        jnp.asarray(x0),
        jnp.asarray(TIME, jnp.float32),
        jctx,
    )
    want_noise = lane_noise_to_logical(np.asarray(jnoise), R)
    want_costs = np.asarray(jcosts)[:R]
    want_states = np.asarray(jstates)

    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    tx0 = torch.tensor(x0)
    init, table = rollout_inputs(
        ObjectiveConfiguration(), STEPS, DT, 1.0, tx0, torch.tensor(TIME),
        ctx, torch.tensor(optimal), torch.tensor(optimal_shifted),
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32)
    noise, costs, qv = fused_sample_rollout(
        spec, init, table, meta, noise_from_logical(torch.tensor(old)),
        noise_from_logical(torch.tensor(fresh)), torch.tensor(keep),
    )
    np.testing.assert_array_equal(
        noise_to_logical(noise).numpy().view(np.int32), want_noise.view(np.int32)
    )
    np.testing.assert_array_equal(costs.numpy()[:, 0], want_costs[:, 0])
    np.testing.assert_allclose(costs.numpy(), want_costs, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(qv.numpy(), want_states[:, :24], rtol=1e-6, atol=2e-6)

    # The sampler path around the same call: its (S, 31) states append x0's
    # wrench and energy.
    sampler = CudaSampler(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
        R, STEPS, DT, np.sqrt(fr.DEFAULT_COVARIANCE), device="cpu",
    )
    scosts, snoise, sstates = sampler.sample_and_rollout(
        None, torch.tensor(keep), torch.tensor(shift, dtype=torch.int32),
        torch.tensor(do_shift), noise_from_logical(torch.tensor(old)),
        torch.tensor(optimal), torch.tensor(optimal_shifted), tx0,
        torch.tensor(TIME), ctx, fresh=noise_from_logical(torch.tensor(fresh)),
    )
    assert torch.equal(snoise, noise) and torch.equal(scosts, costs)
    np.testing.assert_allclose(sstates.numpy(), want_states, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("with_ctx", [True, False])
def test_plain_fused_rollout_matches_lanes_f64(with_ctx):
    """With every rollout kept, no shift and no static rows, the assembled
    noise is the old noise, and the rollout must equal the JAX lanes
    rollout_fn at float64."""
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((R, STEPS, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
    optimal_shifted = 0.3 * rng.standard_normal((STEPS, 12))
    x0 = fr.make_state("huddled")
    jctx, ctx = _contexts(jnp.float64) if with_ctx else (None, None)
    lanes_fn = make_lanes_rollout_fn(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), STEPS, DT
    )
    want_costs, want_states = lanes_fn(
        jnp.asarray(noise), jnp.asarray(optimal_shifted), jnp.asarray(x0),
        jnp.asarray(TIME, jnp.float64), jctx,
    )
    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    init, table = rollout_inputs(
        ObjectiveConfiguration(), STEPS, DT, 1.0, torch.tensor(x0),
        torch.tensor(TIME, dtype=torch.float64), ctx,
        torch.zeros((STEPS, 12), dtype=torch.float64), torch.tensor(optimal_shifted),
    )
    old = noise_from_logical(torch.tensor(noise))
    out_noise, costs, qv = fused_sample_rollout(
        spec, init, table, torch.zeros(3, dtype=torch.int32), old,
        torch.zeros_like(old), torch.ones(R, dtype=torch.bool),
    )
    assert torch.equal(out_noise, old)
    np.testing.assert_array_equal(costs.numpy()[:, 0], np.asarray(want_costs)[:, 0])
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs), rtol=1e-9)
    np.testing.assert_allclose(qv.numpy(), np.asarray(want_states)[:, :24], rtol=1e-9, atol=1e-12)


def test_nan_poisons_a_rollout():
    """A NaN control poisons that rollout's cost sum and no other."""
    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float32)
    init, table = rollout_inputs(
        ObjectiveConfiguration(), 3, DT, 1.0, x0, torch.tensor(0.0), None,
        torch.zeros((3, 12)), torch.zeros((3, 12)),
    )
    old = torch.zeros((3, 12, 8))
    old[1, 4, 5] = float("nan")
    _, costs, _ = fused_sample_rollout(
        spec, init, table, torch.zeros(3, dtype=torch.int32), old,
        torch.zeros_like(old), torch.ones(8, dtype=torch.bool),
    )
    assert torch.isnan(costs[5]).any()
    assert torch.isfinite(costs[torch.arange(8) != 5]).all()


def test_step_counts_match_jax_flop_walk():
    """The bound's hardware-neutral counts are the JAX step graph's."""
    from assistedmanipulation_tpu.ops import flops

    assert cuda_rollout.STEP_FLOPS == flops.rollout_step_flops()
    assert cuda_rollout.STEP_FP32_INSTRUCTIONS == (
        flops.rollout_step_flops() - flops.count_fma_pairs(flops.rollout_step_jaxpr())
    )


def test_kernel_wrapper_checks_its_inputs():
    """What the CUDA launch would refuse is refused before it: dtype, shape,
    contiguity, and devices with no kernel."""
    S, Rk = 4, 16
    good = dict(
        init=torch.zeros(32), table=torch.zeros((S, 32)),
        meta=torch.zeros(3, dtype=torch.int32), old=torch.zeros((S, 12, Rk)),
        fresh=torch.zeros((S, 12, Rk)), keep=torch.zeros(Rk, dtype=torch.bool),
    )
    cuda_rollout._check_kernel_inputs(**good)
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout._check_kernel_inputs(**{**good, "fresh": good["fresh"].double()})
    with pytest.raises(ValueError, match="shape"):
        cuda_rollout._check_kernel_inputs(**{**good, "table": torch.zeros((S, 31))})
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rollout._check_kernel_inputs(
            **{**good, "fresh": torch.zeros((Rk, 12, S)).permute(2, 1, 0)}
        )
    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    meta_device = {k: v.to("meta") for k, v in good.items()}
    with pytest.raises(ValueError, match="no fused rollout"):
        fused_sample_rollout(spec, **meta_device)


def test_kernel_parameters_describe_the_model():
    """The by-value parameter block and the topology the wrapper checks
    against the compiled kernel come from the model and the objective."""
    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    topology = spec.topology()
    assert topology[:13] == [12, -1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9]
    assert topology[13:25] == [0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
    assert topology[25:36] == [10, 2, 3, 4, 5, 6, 7, 8, 9, 9, 2]
    assert topology[36] == 20 and len(topology) == 37 + 40
    params = spec.kernel_params()
    assert params.kd_dt[0] == pytest.approx(1000.0 * DT)
    assert params.pair_radius[0] == pytest.approx(0.75 + 0.1)
    assert params.enable_energy == 0 and params.enable_workspace == 1
    assert list(params.axis[11]) == [0.0, -1.0, 0.0]


def test_sampler_draws_scaled_fresh_noise():
    """Without injected draws the sampler draws N(0, diag) from its
    generator: zero-variance gripper dofs stay zero, the rest have the
    configured spread."""
    Rs = 4096
    sampler = CudaSampler(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
        Rs, 2, DT, np.sqrt(fr.DEFAULT_COVARIANCE), device="cpu",
    )
    old = sampler.init_noise(torch.float32)
    seed = torch.tensor([0, 0], dtype=torch.int32)
    x0 = torch.tensor(fr.make_state("huddled"), dtype=torch.float32)
    costs, noise, states = sampler.sample_and_rollout(
        seed, torch.zeros(Rs, dtype=torch.bool), torch.tensor(0, dtype=torch.int32),
        torch.tensor(False), old, torch.zeros((2, 12)), torch.zeros((2, 12)), x0,
        torch.tensor(0.0), None,
    )
    assert costs.shape == (Rs, 2) and states.shape == (2, 31)
    std = noise[:, :, 2:].std(dim=(0, 2)).numpy()
    np.testing.assert_allclose(std[:10], np.sqrt(fr.DEFAULT_COVARIANCE[:10]), rtol=0.05)
    assert not noise[:, 10:].any()

"""The in-kernel-RNG sampler of the port (plain version of
kernels/csrc/inkernel_rng_sample_rollout.cu, ``CudaSampler(inkernel_rng=
True)``, ``build_flagship(inkernel_rng=True)``) against the JAX package.

The JAX in-kernel-RNG kernel draws from the TPU's hardware generator, which
has no CPU lowering (pallas_rollout.py:438-440), so its fused kernel is the
reference: it runs in interpret mode, as tests/test_pallas_rollout.py runs
it, fed as fresh draws exactly what ``philox.normal_draws`` makes of the
seed words. Tolerances as tests/test_torch_rollout.py states them: noise
bitwise, float32 costs rtol/atol 2e-5, states 2e-6. On the CPU the in-kernel
flagship is bitwise the fused flagship fed the same draws.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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
    inkernel_rng_sample_rollout,
    noise_from_logical,
    noise_to_logical,
    rollout_inputs,
)
from assistedmanipulation_tpu_torch.kernels.philox import normal_draws, seed_words, split_key
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from assistedmanipulation_tpu_torch.ops.gaussian import diagonal_scale
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 6
DT = 0.01
R = 200  # not a multiple of the JAX tile: exercises its padding
TIME = 0.02
SEED = torch.tensor([0x1234567, -0x7654321], dtype=torch.int32)
SCALE = torch.tensor(diagonal_scale(fr.DEFAULT_COVARIANCE), dtype=torch.float32)


def _logical_to_lane(x: np.ndarray, grid: int) -> np.ndarray:
    """(R, S, 12) -> the JAX sampler's (G, S, 12, 1, 128) lane layout."""
    padded = np.zeros((grid * 128,) + x.shape[1:], x.dtype)
    padded[: x.shape[0]] = x
    return padded.reshape(grid, 1, 128, *x.shape[1:]).transpose(0, 3, 4, 1, 2)


@pytest.fixture(scope="module")
def jax_fused():
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

    return sampler.grid, fused


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    old = (rng.standard_normal((R, STEPS, 12)) * SCALE.numpy()).astype(np.float32)
    keep = rng.random(R) < 0.3
    keep[:2] = False  # statics are never kept
    optimal = (0.3 * rng.standard_normal((STEPS, 12))).astype(np.float32)
    optimal_shifted = (0.3 * rng.standard_normal((STEPS, 12))).astype(np.float32)
    x0 = fr.make_state("huddled").astype(np.float32)
    wrench = np.zeros((STEPS + 1, 6), np.float32)
    wrench[:, 0] = 25.0
    wrench[:, 1] = np.linspace(-5.0, 5.0, STEPS + 1)
    return old, keep, optimal, optimal_shifted, x0, wrench


@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False), (STEPS, True)])
def test_plain_inkernel_rollout_matches_jax_fused_sampler(jax_fused, inputs, shift, do_shift):
    old, keep, optimal, optimal_shifted, x0, wrench = inputs
    grid, fused = jax_fused
    fresh = noise_to_logical(normal_draws(SEED, STEPS, R, SCALE)).numpy()
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
        JaxForecastContext(jnp.asarray(wrench), jnp.asarray(0.0, jnp.float32), DT, STEPS * DT),
    )
    want_noise = lane_noise_to_logical(np.asarray(jnoise), R)
    want_costs = np.asarray(jcosts)[:R]
    want_states = np.asarray(jstates)

    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    ctx = ForecastContext(torch.tensor(wrench), torch.zeros(()), DT, STEPS * DT)
    init, table = rollout_inputs(
        ObjectiveConfiguration(), STEPS, DT, 1.0, torch.tensor(x0), torch.tensor(TIME),
        ctx, torch.tensor(optimal), torch.tensor(optimal_shifted),
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32)
    noise, costs, qv = inkernel_rng_sample_rollout(
        spec, init, table, meta, noise_from_logical(torch.tensor(old)), torch.tensor(keep), SEED, SCALE,
    )
    np.testing.assert_array_equal(
        noise_to_logical(noise).numpy().view(np.int32), want_noise.view(np.int32)
    )
    np.testing.assert_array_equal(costs.numpy()[:, 0], want_costs[:, 0])
    np.testing.assert_allclose(costs.numpy(), want_costs, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(qv.numpy(), want_states[:, :24], rtol=1e-6, atol=2e-6)

    # The draws the kernel takes are exactly where fresh_mask says.
    taken = cuda_rollout.fresh_mask(meta, torch.tensor(keep), STEPS).expand(STEPS, 12, R)
    drawn = noise_from_logical(torch.tensor(fresh))
    assert torch.equal(noise[taken], drawn[taken])
    assert not torch.equal(noise[~taken], drawn[~taken])

    # The sampler path around the same call takes the seed words it is given
    # as the kernel's key.
    sampler = CudaSampler(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
        R, STEPS, DT, diagonal_scale(fr.DEFAULT_COVARIANCE), device="cpu", inkernel_rng=True,
    )
    words = seed_words(torch.Generator().manual_seed(4))
    scosts, snoise, sstates = sampler.sample_and_rollout(
        words, torch.tensor(keep), torch.tensor(shift, dtype=torch.int32),
        torch.tensor(do_shift), noise_from_logical(torch.tensor(old)),
        torch.tensor(optimal), torch.tensor(optimal_shifted), torch.tensor(x0),
        torch.tensor(TIME), ctx,
    )
    direct = inkernel_rng_sample_rollout(
        spec, init, table, meta, noise_from_logical(torch.tensor(old)), torch.tensor(keep),
        words, SCALE,
    )
    assert torch.equal(snoise, direct[0]) and torch.equal(scosts, direct[1])
    assert torch.equal(sstates[:, :24], direct[2])


TIMES = [0.0, 0.01, 0.02, 0.05, 0.05, 0.06]  # shifts of 0, 1, 1, 3, 0, 1 slots


def test_inkernel_flagship_is_the_fused_flagship_fed_the_same_draws():
    """Six updates on the CPU: each in-kernel update equals, bitwise, the
    fused flagship's update from the same state fed the draws
    ``normal_draws`` makes of the seed words the in-kernel sampler takes
    (``split_key`` of the state's key), the next key included."""
    steps, rollouts = 6, 126
    inkernel = build_flagship(rollouts, steps, device="cpu", inkernel_rng=True)
    fused = build_flagship(rollouts, steps, device="cpu")
    assert inkernel.planner.sampler.inkernel_rng and inkernel.planner.sampler.fused_assembly
    count = inkernel.planner.rollout_count
    state, ctx = inkernel.init(seed=0), inkernel.make_ctx()
    kept = 0
    for time in TIMES:
        next_key, words = split_key(state.rng)
        fresh = noise_to_logical(normal_draws(words, steps, count, SCALE))
        want, want_info = fused.update(state, fused.x0, time, ctx, fresh=fresh)
        kept += int(fused.planner._sample_meta(state, torch.tensor(time))[4].sum())
        state, info = inkernel.update(state, inkernel.x0, time, ctx)
        for got_part, want_part in ((state, want), (info, want_info)):
            for name in got_part._fields:
                got_value, want_value = getattr(got_part, name), getattr(want_part, name)
                if isinstance(got_value, torch.Tensor):
                    assert torch.equal(got_value, want_value), name
        assert torch.equal(state.rng, next_key)
    assert kept > 0  # elite rows carried old noise in some update
    assert int(state.update_count) == len(TIMES)
    assert torch.isfinite(state.optimal_control).all()


def test_inkernel_sampler_refuses_what_it_cannot_do(monkeypatch):
    with pytest.raises(ValueError, match="scenario ensemble"):
        build_flagship(rollouts=14, steps=3, device="cpu", scenarios=2, inkernel_rng=True)
    with pytest.raises(ValueError, match="fused assembly"):
        build_flagship(rollouts=14, steps=3, device="cpu", inkernel_rng=True, fused_assembly=False)
    flagship = build_flagship(rollouts=14, steps=3, device="cpu", inkernel_rng=True)
    state = flagship.init(seed=0)
    ensemble = build_flagship(rollouts=14, steps=3, device="cpu", scenarios=2).make_ctx()
    with pytest.raises(ValueError, match="scenario-ensemble"):
        flagship.update(state, flagship.x0, 0.0, ensemble)
    with pytest.raises(ValueError, match="fresh="):
        flagship.update(state, flagship.x0, 0.0, flagship.make_ctx(), fresh=np.zeros((16, 3, 12), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(inkernel_rng=True)


def test_inkernel_wrapper_checks_its_inputs():
    S, Rk = 4, 16
    good = dict(
        init=torch.zeros(32), table=torch.zeros((S, 32)), meta=torch.zeros(3, dtype=torch.int32),
        old=torch.zeros((S, 12, Rk)), keep=torch.zeros(Rk, dtype=torch.bool),
        seed=torch.zeros(2, dtype=torch.int32), scale=torch.ones(12),
    )
    cuda_rollout._check_kernel_inputs(**good)
    with pytest.raises(TypeError, match="int32"):
        cuda_rollout._check_kernel_inputs(**{**good, "seed": torch.zeros(2, dtype=torch.int64)})
    with pytest.raises(ValueError, match="shape"):
        cuda_rollout._check_kernel_inputs(**{**good, "scale": torch.ones(10)})
    with pytest.raises(ValueError, match="fresh noise, or seed words"):
        cuda_rollout._check_kernel_inputs(**{**good, "fresh": torch.zeros((S, 12, Rk))})
    with pytest.raises(ValueError, match="fresh noise, or seed words"):
        cuda_rollout._check_kernel_inputs(**{**good, "scale": None})
    spec = RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)
    with pytest.raises(ValueError, match="no in-kernel-RNG rollout"):
        inkernel_rng_sample_rollout(spec, **{k: v.to("meta") for k, v in good.items()})

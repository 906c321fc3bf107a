"""The port's two-pass rollout (plain PyTorch version of csrc/rollout.cu)
against the JAX package's two-pass kernel and its lanes rollout.

The JAX side runs its Pallas kernel as tests/test_pallas_rollout.py does:
interpret mode, one sublane. Both sides get the same noise, optimal
sequence and state, made from a numpy seed. Tolerances as
tests/test_torch_rollout.py states them: float32 costs within rtol/atol
2e-5, states within 2e-6 (an ulp of sin/cos between XLA and PyTorch, grown
over the steps), violation counts exact; float64 against the lanes rollout
rtol 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.kernels.lane_rollout import make_lanes_rollout_fn
from assistedmanipulation_tpu.kernels.pallas_rollout import (
    PallasSampler,
    make_pallas_rollout_fn,
)
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import (
    frankaridgeback_model as jax_model,
)
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu_torch.kernels import build, cuda_rollout
from assistedmanipulation_tpu_torch.kernels.cuda_rollout import (
    RolloutSpec,
    initial_state,
    make_cuda_rollout_fn,
    noise_from_logical,
    rollout,
    step_table,
)
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

DT = 0.01
TIME = 0.02


def _contexts(steps, dtype):
    """The same forecast for both packages: a 25 N x-pull with a y-sweep."""
    wrench = np.zeros((steps + 1, 6))
    wrench[:, 0] = 25.0
    wrench[:, 1] = np.linspace(-5.0, 5.0, steps + 1)
    jctx = JaxForecastContext(jnp.asarray(wrench, dtype), jnp.asarray(0.0, dtype), DT, steps * DT)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64
    ctx = ForecastContext(torch.tensor(wrench, dtype=tdtype), torch.zeros((), dtype=tdtype), DT, steps * DT)
    return jctx, ctx


def _inputs(rollouts, steps, dtype, seed):
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal((rollouts, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)).astype(dtype)
    # Rollout 0, whose states both sides return, is the planner's
    # zero-noise static rollout. (Under full-scale random torques each
    # float32 path drifts ~6e-6 from float64 within 4 steps.)
    noise[0] = 0.0
    optimal_shifted = (0.3 * rng.standard_normal((steps, 12))).astype(dtype)
    x0 = fr.make_state("huddled").astype(dtype)
    return noise, optimal_shifted, x0


def _spec():
    return RolloutSpec(frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), DT)


@pytest.mark.parametrize("with_ctx", [True, False])
def test_cuda_rollout_fn_matches_jax_pallas_rollout_fn(with_ctx):
    """R = 7 pads the JAX tile of 128 lanes."""
    steps, rollouts = 4, 7
    noise, optimal_shifted, x0 = _inputs(rollouts, steps, np.float32, seed=5)
    jctx, ctx = _contexts(steps, jnp.float32) if with_ctx else (None, None)
    jax_fn = make_pallas_rollout_fn(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), steps, DT,
        sublanes=1, interpret=True,
    )
    want_costs, want_states = jax_fn(
        jnp.asarray(noise), jnp.asarray(optimal_shifted), jnp.asarray(x0),
        jnp.asarray(TIME, jnp.float32), jctx,
    )
    fn = make_cuda_rollout_fn(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), steps, DT, device="cpu"
    )
    costs, states = fn(
        torch.tensor(noise), torch.tensor(optimal_shifted), torch.tensor(x0), TIME, ctx
    )
    assert costs.shape == (rollouts, 2) and states.shape == (steps, 31)
    np.testing.assert_array_equal(costs.numpy()[:, 0], np.asarray(want_costs)[:, 0])
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), rtol=1e-6, atol=2e-6)


def test_plain_rollout_matches_jax_chunked_kernel(monkeypatch):
    """The single unchunked loop against the JAX two-pass kernel forced to
    chunk the horizon (3-step chunks over 4 steps: one chunk is padded with
    a zero-discount step)."""
    steps, rollouts = 4, 130
    monkeypatch.setenv("PALLAS_CHUNK_STEPS", "3")
    sampler = PallasSampler(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(),
        rollout_count=rollouts, steps=steps, dt=DT,
        diag_scale=np.sqrt(np.asarray(jax_fr.DEFAULT_COVARIANCE)),
        sublanes=1, interpret=True, emit_states=True,
    )
    assert sampler._chunk_steps == 3
    noise, optimal_shifted, x0 = _inputs(rollouts, steps, np.float32, seed=8)
    controls = noise + optimal_shifted[None]
    padded = np.zeros((sampler.grid * 128, steps, 12), np.float32)
    padded[:rollouts] = controls
    lanes = padded.reshape(sampler.grid, 1, 128, steps, 12).transpose(0, 3, 4, 1, 2)
    jctx, ctx = _contexts(steps, jnp.float32)
    want_costs, want_states = sampler._costs_padded(
        jnp.asarray(lanes), jnp.asarray(x0), jnp.asarray(TIME, jnp.float32), jctx
    )

    tx0 = torch.tensor(x0)
    table = step_table(ObjectiveConfiguration(), steps, DT, 1.0, tx0, torch.tensor(TIME), ctx)
    costs, states = rollout(
        _spec(), initial_state(tx0), table, noise_from_logical(torch.tensor(controls))
    )
    want_costs = np.asarray(want_costs)[:rollouts]
    np.testing.assert_array_equal(costs.numpy()[:, 0], want_costs[:, 0])
    np.testing.assert_allclose(costs.numpy(), want_costs, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        states.numpy(), np.asarray(want_states)[:, :, 0, 0], rtol=1e-6, atol=2e-6
    )


def test_long_horizon_matches_jax_lanes_f64():
    """130 steps, past the JAX package's ~64-step switch to the (chunked)
    two-pass kernel, in one loop: equal to the JAX lanes rollout at
    float64."""
    steps, rollouts = 130, 5
    noise, optimal_shifted, x0 = _inputs(rollouts, steps, np.float64, seed=13)
    jctx, ctx = _contexts(steps, jnp.float64)
    lanes_fn = make_lanes_rollout_fn(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), steps, DT
    )
    want_costs, want_states = lanes_fn(
        jnp.asarray(noise), jnp.asarray(optimal_shifted), jnp.asarray(x0),
        jnp.asarray(TIME, jnp.float64), jctx,
    )
    fn = make_cuda_rollout_fn(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), steps, DT, device="cpu"
    )
    costs, states = fn(
        torch.tensor(noise), torch.tensor(optimal_shifted), torch.tensor(x0),
        torch.tensor(TIME, dtype=torch.float64), ctx,
    )
    np.testing.assert_array_equal(costs.numpy()[:, 0], np.asarray(want_costs)[:, 0])
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs), rtol=1e-9)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), rtol=1e-9, atol=1e-12)


def test_rollout_wrapper_checks_its_inputs():
    """What the two-pass launch would refuse is refused before it: dtype,
    shape, contiguity, a horizon whose table exceeds a block's shared
    memory, and devices with no kernel."""
    S, R = 4, 16
    good = dict(init=torch.zeros(32), table=torch.zeros((S, 8)), controls=torch.zeros((S, 12, R)))
    cuda_rollout._check_rollout_inputs(**good)
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout._check_rollout_inputs(**{**good, "controls": good["controls"].double()})
    with pytest.raises(ValueError, match="shape"):
        cuda_rollout._check_rollout_inputs(**{**good, "table": torch.zeros((S, 32))})
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rollout._check_rollout_inputs(
            **{**good, "controls": torch.zeros((R, 12, S)).permute(2, 1, 0)}
        )
    cuda_rollout._check_rollout_inputs(
        torch.zeros(32), torch.zeros((6878, 8)), torch.zeros((6878, 12, 1))
    )
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rollout._check_rollout_inputs(
            torch.zeros(32), torch.zeros((6879, 8)), torch.zeros((6879, 12, 1))
        )
    with pytest.raises(ValueError, match="no rollout kernel"):
        rollout(_spec(), **{k: v.to("meta") for k, v in good.items()})


def test_plain_rollout_runs_on_the_cpu_without_a_launch():
    """On the CPU the wrapper takes the plain version and counts nothing;
    the two-pass and fused plain versions agree bitwise on the same
    controls."""
    steps, rollouts = 3, 9
    noise, optimal_shifted, x0 = _inputs(rollouts, steps, np.float32, seed=2)
    tx0 = torch.tensor(x0)
    old = noise_from_logical(torch.tensor(noise))
    opt = torch.tensor(optimal_shifted)
    cuda_rollout.reset_launch_counts()
    init, fused_table = cuda_rollout.rollout_inputs(
        ObjectiveConfiguration(), steps, DT, 1.0, tx0, torch.tensor(0.0), None, torch.zeros_like(opt), opt
    )
    _, fused_costs, fused_states = cuda_rollout.fused_sample_rollout(
        _spec(), init, fused_table, torch.zeros(3, dtype=torch.int32), old,
        torch.zeros_like(old), torch.ones(rollouts, dtype=torch.bool),
    )
    table = step_table(ObjectiveConfiguration(), steps, DT, 1.0, tx0, torch.tensor(0.0), None)
    costs, states = rollout(_spec(), init, table, old + opt[:, :, None])
    assert torch.equal(costs, fused_costs) and torch.equal(states, fused_states)
    assert cuda_rollout.LAUNCHES == {
        "fused_sample_rollout": 0, "rollout": 0, "inkernel_rng_sample_rollout": 0, "fp32_chain": 0, "admm_qp": 0,
    }


def test_editing_a_header_rebuilds_every_library(tmp_path, monkeypatch):
    """The library name hashes the source and every csrc/*.cuh, so an edited
    shared header never loads a stale library."""
    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text(f'#include "step.cuh"\n// {name}\n')
    header = tmp_path / "step.cuh"
    header.write_text("// step v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in ("a", "b")}
    assert before["a"] != before["b"]
    assert build.library_path("a") == before["a"]
    header.write_text("// step v2\n")
    for name in ("a", "b"):
        assert build.library_path(name) != before[name]
    assert build.KERNEL_SOURCES == (
        "fused_sample_rollout", "rollout", "inkernel_rng_sample_rollout", "fp32_chain", "admm_qp",
    )

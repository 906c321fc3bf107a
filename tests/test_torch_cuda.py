"""The fused sample+rollout CUDA kernel against its plain PyTorch version, on
the card. These tests need a CUDA device and skip without one; they import
nothing of JAX, so on a machine with a card and no JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

Tolerances as chip_smoke.py states them: noise bitwise, violation counts
exact, smooth costs and states within 1e-4 * max(|plain|, 1).
"""

import pytest
import torch

from assistedmanipulation_tpu_torch.kernels import cuda_rollout
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
)
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

pytestmark = pytest.mark.gpu

STEPS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rollouts, shift, do_shift, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(rollouts + shift)
    scale = torch.tensor(fr.DEFAULT_COVARIANCE, dtype=dtype, device=device).sqrt()
    old = torch.randn((STEPS, 12, rollouts), generator=g, device=device, dtype=dtype) * scale[None, :, None]
    fresh = torch.randn((STEPS, 12, rollouts), generator=g, device=device, dtype=dtype) * scale[None, :, None]
    keep = torch.rand(rollouts, generator=g, device=device) < 0.25
    keep[:2] = False
    x0 = torch.tensor(fr.make_state("huddled"), dtype=dtype, device=device)
    optimal = 0.3 * torch.randn((STEPS, 12), generator=g, device=device, dtype=dtype)
    init, table = cuda_rollout.rollout_inputs(
        ObjectiveConfiguration(), STEPS, 0.01, 1.0, x0, torch.zeros((), dtype=dtype, device=device),
        None, optimal, optimal.flip(0),
    )
    meta = torch.tensor([shift, int(do_shift), 1], dtype=torch.int32, device=device)
    return init, table, meta, old, fresh, keep


def _spec():
    return cuda_rollout.RolloutSpec(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), 0.01
    )


@pytest.mark.parametrize("rollouts", [257, 1000])
@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False), (STEPS, True)])
def test_kernel_matches_plain_version(cuda, rollouts, shift, do_shift):
    inputs = _inputs(rollouts, shift, do_shift, cuda)
    noise, costs, states = cuda_rollout.fused_sample_rollout(_spec(), *inputs)
    want_noise, want_costs, want_states = cuda_rollout.fused_sample_rollout_reference(_spec(), *inputs)
    assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    assert torch.equal(costs[:, 0], want_costs[:, 0])
    for got, want in ((costs[:, 1], want_costs[:, 1]), (states, want_states)):
        assert ((got - want).abs() <= 1e-4 * want.abs().clamp(min=1.0)).all()


def test_kernel_counts_its_launches_and_refuses_float64(cuda):
    cuda_rollout.reset_launch_counts()
    cuda_rollout.fused_sample_rollout(_spec(), *_inputs(64, 0, False, cuda))
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 1
    with pytest.raises(TypeError, match="float32"):
        cuda_rollout.fused_sample_rollout(_spec(), *_inputs(64, 0, False, cuda, torch.float64))
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 1


def test_flagship_updates_go_through_the_kernel(cuda):
    flagship = build_flagship(rollouts=510, steps=STEPS)
    state, ctx = flagship.init(seed=0), flagship.make_ctx()
    cuda_rollout.reset_launch_counts()
    for k in range(4):
        state, info = flagship.update(state, flagship.x0, 0.01 * k, ctx)
    assert cuda_rollout.LAUNCHES["fused_sample_rollout"] == 4
    assert torch.isfinite(state.optimal_control).all()
    assert not bool(info.degenerate)

"""The fused and two-pass samplers' draws: ``torch.randn`` of (S, 12, R)
float32 standard normals from a generator on the state's device, seeded
with the update's 64 seed bits, each dof scaled by its standard
deviation."""

import torch

from ..keys import seed_bits


def fresh_draws(setup, words: tuple, device) -> torch.Tensor:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed_bits(words))
    z = torch.randn((setup.steps, 12, setup.rollouts), generator=generator, dtype=torch.float32, device=device)
    return z * torch.as_tensor(setup.scale, device=device).reshape(1, 12, 1)

"""The plant protocol and the one-sequence re-rollout through it, copied from
``assistedmanipulation_tpu_torch/mppi.py`` (``Plant``, ``as_cost_channels``,
``plant_rollout``) at commit 761f38a."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Plant(NamedTuple):
    derive: Callable
    cost: Callable
    integrate: Callable
    state_dof: int
    control_dof: int


def as_cost_channels(cost: torch.Tensor, batch_shape) -> torch.Tensor:
    if tuple(cost.shape) == tuple(batch_shape):
        return torch.stack([torch.zeros_like(cost), cost], dim=-1)
    return cost


def plant_rollout(plant: Plant, controls, x0, time, ctx, dt: float, discount: float = 1.0, filter_fn=None):
    """Roll ``plant`` out from ``x0`` under ``controls`` (S, ..., dof), each
    step's control filtered first by ``filter_fn(x, u, t)`` when given.
    Returns ((..., 2) cost channels, (S, ...) pre-step states, (S, ..., dof)
    controls applied)."""
    steps = controls.shape[0]
    k = torch.arange(steps, dtype=controls.dtype, device=controls.device)
    times, discounts = time.to(controls.dtype) + k * dt, discount ** k
    batch = x0.shape[:-1]
    x = x0
    total = torch.zeros((*batch, 2), dtype=controls.dtype, device=controls.device)
    states, applied = [], []
    for step in range(steps):
        t, u = times[step], controls[step]
        if filter_fn is not None:
            u = filter_fn(x, u, t).to(u.dtype)
        aux = plant.derive(x, t, ctx)
        step_cost = as_cost_channels(plant.cost(x, u, aux, t, ctx), batch).to(total.dtype)
        total = total + step_cost * discounts[step]
        states.append(x)
        applied.append(u)
        x = plant.integrate(x, u, aux, t, dt, ctx)
    return total, torch.stack(states), torch.stack(applied)

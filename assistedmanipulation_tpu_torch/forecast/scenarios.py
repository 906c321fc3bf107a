"""Batched wrench-forecast scenarios (port of
assistedmanipulation_tpu/forecast/scenarios.py).

The reference plans against a single point forecast of the human wrench
(DynamicsForecast caches one horizon, frankaridgeback/dynamics.cpp:104-138).
The Kalman filter, however, carries a full posterior covariance it never
uses for planning. This module samples a scenario ensemble from that
posterior — scenario 0 is always the mean (the reference's forecast), the
rest are posterior draws rolled through the same constant-derivative
predictor — and scores every MPPI rollout against the ensemble, so forecast
uncertainty widens the effective cost landscape instead of being discarded.
The cost channels average over scenarios; a NaN in any scenario poisons the
rollout.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..objectives.assisted_manipulation import scenario_contexts
from .forecast import KalmanForecast, KalmanForecastState


def sample_scenarios(
    forecast: KalmanForecast,
    state: KalmanForecastState,
    generator: Optional[torch.Generator],
    count: int,
    draws=None,
) -> torch.Tensor:
    """Sample ``count`` wrench horizons (count, steps + 1, observed) from
    the filter posterior. Scenario 0 is the cached mean prediction.

    ``draws`` (count - 1, n): standard normals to use instead of drawing
    from ``generator`` (the parity tests feed the JAX draws here). A
    posterior that is not positive definite gives NaN draws, as JAX's
    Cholesky does, and poisons every rollout it scores. Inside a captured
    serving tick ``generator`` must be registered with the graph
    (parallel/flagship.capture_serving_tick does): each replay then draws
    what the eager call draws from the generator's state at that point."""
    if count < 1:
        raise ValueError("need at least one scenario")
    if count == 1:
        return state.prediction[None]
    dtype, device = state.prediction.dtype, state.prediction.device
    covariance = state.filter.covariance
    # Symmetrize + jitter: the filter covariance is tiny (the reference
    # fixes process/observation noise at 1e-8 I, forecast.cpp:277-286) and
    # f32 round-off can push it indefinite.
    covariance = 0.5 * (covariance + covariance.T)
    jitter = 1e-10 * torch.eye(covariance.shape[0], dtype=dtype, device=device)
    transform, info = torch.linalg.cholesky_ex(covariance + jitter)
    transform = torch.where(info != 0, torch.full_like(transform, float("nan")), transform)

    n = covariance.shape[0]
    if draws is None:
        draws = torch.randn((count - 1, n), generator=generator, dtype=dtype, device=device)
    else:
        draws = torch.as_tensor(draws, dtype=dtype).to(device)
        if tuple(draws.shape) != (count - 1, n):
            raise ValueError(f"draws must have shape {(count - 1, n)}, got {tuple(draws.shape)}")
    x = state.filter.state[None] + draws @ transform.T
    # Each draw rolled through the predictor: F^k x for k = 0..steps in one
    # product (KalmanForecast.horizon_map).
    sampled = torch.einsum("kon,cn->cko", forecast.horizon_map(dtype, device), x)
    return torch.cat([state.prediction[None], sampled], dim=0)


def make_scenario_rollout_fn(rollout_fn, weights=None):
    """Wrap a rollout_fn (``make_cuda_rollout_fn``'s signature) to accept a
    ctx whose ``wrench_horizon`` carries a leading scenario axis
    (C, steps + 1, 6). Cost channels are the (optionally weighted) scenario
    mean — risk-neutral scoring; pass e.g. softmax weights for
    risk-sensitive variants.

    A rollout_fn returning ``(costs, rollout-0 states)`` passes the states
    through from scenario 0 (the dynamics do not depend on the forecast —
    only the cost reads the wrench horizon)."""

    def fn(noise, optimal_shifted, x0, time, ctx):
        if ctx is None or ctx.wrench_horizon.ndim == 2:
            return rollout_fn(noise, optimal_shifted, x0, time, ctx)
        out = [rollout_fn(noise, optimal_shifted, x0, time, c) for c in scenario_contexts(ctx)]
        states = None
        if isinstance(out[0], tuple):
            costs = torch.stack([costs for costs, _ in out])  # (C, R, 2)
            states = out[0][1]  # scenario-independent
        else:
            costs = torch.stack(out)
        mean = reduce_scenarios(costs, weights)
        return mean if states is None else (mean, states)

    return fn


def reduce_scenarios(costs: torch.Tensor, weights=None) -> torch.Tensor:
    """(C, R, 2) scenario costs -> (R, 2): the scenario mean, or the mean
    under ``weights`` (C,) (normalised here). A NaN in any scenario poisons
    the rollout."""
    if weights is None:
        return torch.mean(costs, dim=0)
    w = torch.as_tensor(weights, dtype=costs.dtype).to(costs.device)
    return torch.einsum("c,crk->rk", w / torch.sum(w), costs)

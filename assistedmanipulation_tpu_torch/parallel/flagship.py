"""Flagship serving composition on one GPU (port of the single-device,
single-scenario path of assistedmanipulation_tpu/parallel/flagship.py).

``build_flagship()`` is the serving MPPI solve: 9,998 sampled + 2 static
rollouts over 50 steps of 10 ms, the 12-dof Franka-Ridgeback model with the
default 7-term assisted-manipulation objective, batch optimal-rollout mode,
every update one launch of the fused sample+rollout CUDA kernel
(kernels/cuda_rollout.CudaSampler). Multi-device sharding and scenario
ensembles are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import mppi as mppi_module
from .. import resolve_device
from ..kernels.cuda_rollout import CudaSampler
from ..models import frankaridgeback as fr
from ..models.model_data import frankaridgeback_model
from ..objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from ..ops.gaussian import diagonal_scale


class Flagship(NamedTuple):
    """A ready-to-run flagship planner bundle."""

    planner: mppi_module.Planner
    update: Callable  # (state, x0, time, ctx, fresh=None) -> (state, info)
    init: Callable  # (seed) -> PlannerState
    make_ctx: Callable  # () -> ForecastContext
    x0: torch.Tensor


def default_mppi_configuration(
    rollouts: int, steps: int, dtype: str = "float32"
) -> mppi_module.Configuration:
    """The serving MPPI configuration: reference defaults (base.hpp:69-101)
    at production rollout counts."""
    return mppi_module.Configuration(
        rollouts=rollouts,
        keep_best_rollouts=max(1, rollouts // 5),
        time_step=0.01,
        horizon=steps * 0.01,
        gradient_step=2.0,
        cost_scale=10.0,
        covariance=fr.DEFAULT_COVARIANCE,
        control_min=fr.DEFAULT_CONTROL_MIN,
        control_max=fr.DEFAULT_CONTROL_MAX,
        control_default=np.zeros(12),
        smoothing=mppi_module.Smoothing(window=10, order=1),
        dtype=dtype,
        optimal_rollout_mode="batch",
    )


def synthetic_wrench_horizons(steps: int, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Deterministic stand-in for the Kalman forecast (one scenario): a
    constant 20 N x-force, the benchmark's canonical human pull."""
    horizon = torch.zeros((steps + 1, 6), dtype=dtype)
    horizon[:, 0] = 20.0
    return horizon.to(resolve_device(device))


def build_flagship(
    rollouts: int = 10_000 - mppi_module.STATIC_ROLLOUTS,
    steps: int = 50,
    device="cuda",
    dtype: str = "float32",
) -> Flagship:
    """Compose the flagship planner on one device. ``device="cpu"`` runs the
    plain PyTorch rollout (tests); the default needs CUDA and raises without
    it. The CUDA kernel takes float32 only."""
    device = resolve_device(device)
    configuration = default_mppi_configuration(rollouts, steps, dtype)
    sampler = CudaSampler(
        frankaridgeback_model(),
        ObjectiveConfiguration(),
        fr.Configuration(),
        configuration.rollout_count,
        configuration.step_count,
        configuration.time_step,
        diag_scale=diagonal_scale(configuration.covariance),
        discount=configuration.cost_discount_factor,
        device=device,
    )
    planner = mppi_module.Planner(configuration, sampler, fr.DoF.CONTROL, device=device)
    torch_dtype = getattr(torch, dtype)

    def make_ctx():
        return ForecastContext(
            wrench_horizon=synthetic_wrench_horizons(steps, device),
            start_time=torch.zeros((), dtype=torch.float32, device=device),
            time_step=0.01,
            horizon=steps * 0.01,
        )

    x0 = torch.as_tensor(fr.make_state("huddled"), dtype=torch_dtype).to(device)
    return Flagship(planner, planner.update, planner.init, make_ctx, x0)

"""Flagship serving composition on one GPU (port of the single-device path
of assistedmanipulation_tpu/parallel/flagship.py).

``build_flagship()`` is the serving MPPI solve: 9,998 sampled + 2 static
rollouts over 50 steps of 10 ms, the 12-dof Franka-Ridgeback model with the
default 7-term assisted-manipulation objective, batch optimal-rollout mode,
every update one launch of the fused sample+rollout CUDA kernel
(kernels/cuda_rollout.CudaSampler). ``build_flagship(scenarios=C)`` scores
every rollout against a C-scenario forecast ensemble (BASELINE config 5):
the two-pass sampler, one launch of the two-pass rollout kernel per update
for all C scenarios.
``build_flagship(inkernel_rng=True)`` is the serving solve with its fresh
draws made inside the kernel: one launch of the in-kernel-RNG kernel per
update and no fresh-noise tensor. Multi-device sharding is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import mppi as mppi_module
from .. import resolve_device
from ..kernels.cuda_rollout import FUSED_MAX_STEPS, INKERNEL_MAX_STEPS, CudaSampler
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


def synthetic_wrench_horizons(
    steps: int, scenarios: int = 1, device="cuda", dtype=torch.float32
) -> torch.Tensor:
    """Deterministic stand-in for the Kalman forecast ensemble
    (forecast/scenarios.sample_scenarios): scenario 0 is the mean — a
    constant 20 N x-force, the benchmark's canonical human pull — and the
    rest spread around it like posterior draws. (steps + 1, 6) for one
    scenario, else (scenarios, steps + 1, 6)."""
    mean = torch.zeros((steps + 1, 6), dtype=dtype)
    mean[:, 0] = 20.0
    if scenarios == 1:
        return mean.to(resolve_device(device))
    offsets = np.zeros((scenarios, 6), dtype=np.float32)
    # Alternate +/- force offsets of growing magnitude per scenario.
    for c in range(1, scenarios):
        offsets[c, (c - 1) % 3] = 2.0 * ((-1) ** c) * ((c + 1) // 2)
    horizons = mean[None] + torch.as_tensor(offsets, dtype=dtype)[:, None, :]
    return horizons.to(resolve_device(device))


def build_flagship(
    rollouts: int = 10_000 - mppi_module.STATIC_ROLLOUTS,
    steps: int = 50,
    device="cuda",
    dtype: str = "float32",
    scenarios: int = 1,
    fused_assembly: Optional[bool] = None,
    inkernel_rng: bool = False,
) -> Flagship:
    """Compose the flagship planner on one device. ``device="cpu"`` runs the
    plain PyTorch rollouts (tests); the default needs CUDA and raises without
    it. The CUDA kernels take float32 only.

    - ``scenarios`` > 1 scores every rollout against a wrench-forecast
      ensemble (risk-neutral scenario mean), BASELINE config 5; ``make_ctx``
      then returns the (scenarios, steps + 1, 6) ensemble.
    - ``fused_assembly`` picks the sampler: the fused sample+rollout kernel
      (True) or the two-pass sampler (False: noise assembled in plain
      PyTorch, then one launch of the two-pass rollout kernel against
      every scenario). It
      defaults to the fused kernel for one scenario up to
      ``FUSED_MAX_STEPS`` steps, whose (S, 32) table and state ring fill a
      block's shared memory there, and to the two-pass sampler otherwise
      (its kernel takes one scenario up to 7,264 steps); a scenario
      ensemble needs the two-pass sampler. The JAX package switches for
      horizons past ~64 steps (``max_sublanes_for_vmem(steps, 3, 16) <
      16``), a rule of the TPU's VMEM. The noise is bitwise the same on
      either path, so the results are the same.
    - ``inkernel_rng=True`` draws the fresh noise inside the kernel
      (Philox from 2 seed words per update, kernels/philox.py): the
      composition of the JAX package's ``make_pallas_planner(cfg,
      fused_sampling=True, fused_assembly=True, inkernel_rng=True)``. It
      needs one scenario and fused assembly, and its updates take no
      ``fresh=`` draws, and at most ``INKERNEL_MAX_STEPS`` steps."""
    device = resolve_device(device)
    configuration = default_mppi_configuration(rollouts, steps, dtype)
    horizon = configuration.step_count
    if inkernel_rng and fused_assembly is False:
        raise ValueError("inkernel_rng is fused assembly; it cannot run with fused_assembly=False")
    if inkernel_rng and horizon > INKERNEL_MAX_STEPS:
        raise ValueError(
            f"{horizon} steps: the in-kernel-RNG kernel takes at most {INKERNEL_MAX_STEPS} "
            "(its (S, 32) table lives in shared memory)"
        )
    if fused_assembly is None:
        fused_assembly = (scenarios == 1 and horizon <= FUSED_MAX_STEPS) or inkernel_rng
    if fused_assembly and scenarios > 1:
        raise ValueError("a scenario ensemble needs the two-pass sampler (fused_assembly=False)")
    if fused_assembly and not inkernel_rng and horizon > FUSED_MAX_STEPS:
        raise ValueError(
            f"{horizon} steps: the fused kernel takes at most {FUSED_MAX_STEPS}; "
            "the two-pass sampler (fused_assembly=False) takes longer horizons"
        )
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
        fused_assembly=fused_assembly,
        inkernel_rng=inkernel_rng,
    )
    planner = mppi_module.Planner(configuration, sampler, fr.DoF.CONTROL, device=device)
    torch_dtype = getattr(torch, dtype)

    def make_ctx():
        return ForecastContext(
            wrench_horizon=synthetic_wrench_horizons(steps, scenarios, device),
            start_time=torch.zeros((), dtype=torch.float32, device=device),
            time_step=0.01,
            horizon=steps * 0.01,
        )

    x0 = torch.as_tensor(fr.make_state("huddled"), dtype=torch_dtype).to(device)
    return Flagship(planner, planner.update, planner.init, make_ctx, x0)

"""MPPI trajectory optimizer, sampler path (port of assistedmanipulation_tpu/mppi.py).

One ``Planner.update`` (mppi::Trajectory::update, mppi.cpp:154-187 of the
C++ reference):

1. ``_sample_meta``: horizon shift, elite keep mask from the last costs,
   shifted optimal sequence (mppi.cpp:189-231);
2. the sampler draws fresh N(0, diag) noise, assembles the rollout noise
   (elite reuse, zero and negated-optimal static rollouts) and scores every
   rollout — one fused kernel launch on the GPU (kernels/cuda_rollout.py);
3. ``_optimise``: NaN-masked min/max-normalised softmax over the two cost
   channels, weighted noise sum, gradient step, Savitzky-Golay smoothing
   and clipping (mppi.cpp:344-448);
4. rollout 0 (zero noise on the shifted optimal) is published as the
   optimal rollout, its cost and states read from the batch
   (optimal_rollout_mode "batch").

Everything stays on the device between updates: no step reads a value back
to the host. The state is an explicit ``PlannerState``; its ``rng`` is a
``torch.Generator`` that the fresh draws advance in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import resolve_device
from .ops import true_divide
from .ops.costs import MAXIMUM_COST_DEFAULT
from .ops.sg_filter import SGSmoother, sg_smooth

# Static rollouts: index 0 carries zero noise, index 1 carries the negated
# previous optimal control (mppi.cpp:264-269, mppi.hpp s_static_rollouts).
STATIC_ROLLOUTS = 2

# Composition scale for the two-channel (saturations, smooth) cost — equals
# the barriers' maximum_cost, so the composed scalar matches the reference's
# float64 totals.
BARRIER_SCALE = MAXIMUM_COST_DEFAULT


def compose_cost(channels: torch.Tensor) -> torch.Tensor:
    """Composed scalar cost = saturations * BARRIER_SCALE + smooth (lossy in
    f32; for logging only, never for weighting)."""
    return channels[..., 0] * BARRIER_SCALE + channels[..., 1]


@dataclasses.dataclass
class Smoothing:
    window: int = 10
    order: int = 1


@dataclasses.dataclass
class Configuration:
    """Mirror of mppi::Configuration (reference mppi.hpp:242-248 and the
    defaults at src/test/case/base.hpp:69-101)."""

    rollouts: int = 50
    keep_best_rollouts: int = 20
    time_step: float = 0.01
    horizon: float = 0.3
    gradient_step: float = 2.0
    cost_scale: float = 10.0
    cost_discount_factor: float = 1.0
    covariance: Optional[np.ndarray] = None
    control_bound: bool = True
    control_min: Optional[np.ndarray] = None
    control_max: Optional[np.ndarray] = None
    control_default: Optional[np.ndarray] = None
    initial_state: Optional[np.ndarray] = None
    smoothing: Optional[Smoothing] = None
    dtype: str = "float32"
    # Only "batch" is ported: the published optimal rollout's cost and
    # states are rollout 0's, read from the batch (one update early); the
    # "resimulate" re-rollout is not ported yet.
    optimal_rollout_mode: str = "batch"

    @property
    def step_count(self) -> int:
        return int(math.ceil(self.horizon / self.time_step))

    @property
    def rollout_count(self) -> int:
        return self.rollouts + STATIC_ROLLOUTS


class PlannerState(NamedTuple):
    """Everything the controller carries between updates (the reference's
    mutable Trajectory members, mppi.hpp:600-650)."""

    optimal_control: torch.Tensor  # (steps, dof) published control sequence
    noise: torch.Tensor  # the sampler's noise representation (elite reuse)
    costs: torch.Tensor  # (R, 2) rollout cost channels from the last update
    last_shift_time: torch.Tensor  # 0-d: time the horizon was last aligned to
    last_update_time: torch.Tensor  # 0-d: time of the last publish
    sg_buffer: torch.Tensor  # (dof, L) smoothing history ((0, 0) if disabled)
    sg_time: torch.Tensor  # 0-d: time sg_buffer was last filled (NaN before)
    rng: torch.Generator  # fresh-noise stream, advanced in place
    update_count: torch.Tensor  # 0-d int32
    optimal_cost: torch.Tensor  # 0-d: cost of the optimal rollout (logging)
    update_duration: torch.Tensor  # 0-d seconds, host-measured (logging)


class UpdateInfo(NamedTuple):
    """Per-update observability outputs (logger::MPPI's costs, weights and
    gradient CSVs, src/logging/mppi.cpp:23-72)."""

    costs: torch.Tensor  # (R,) composed
    weights: torch.Tensor  # (R,)
    gradient: torch.Tensor  # (steps, dof)
    optimal_rollout_states: torch.Tensor  # (steps, state_dof)
    optimal_cost: torch.Tensor
    degenerate: torch.Tensor  # True when max-min < 1e-6 (update skipped)


def _shift_columns(array: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Shift ``array`` left along axis 0 by a tensor ``shift``, replicating
    the final entry (mppi.cpp:204-206)."""
    length = array.shape[0]
    index = torch.clamp(torch.arange(length, device=array.device) + shift, max=length - 1)
    return array[index]


def _lexsort(keys) -> torch.Tensor:
    """Indices that sort by the last key, then the one before, ... — numpy's
    lexsort, as chained stable sorts from the least significant key."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


class Planner:
    """The MPPI update and query around a sampler (kernels/cuda_rollout.
    CudaSampler: it owns the noise layout, the rollout and the weighted noise
    sum). Construction validates the configuration like
    mppi::Trajectory::create (mppi.cpp:11-77) but raises instead of
    returning nullptr."""

    def __init__(
        self,
        configuration: Configuration,
        sampler,
        control_dof: int,
        device="cuda",
    ):
        cfg = configuration
        dof = control_dof
        if cfg.covariance is None:
            raise ValueError("mppi configuration requires a covariance")
        covariance = np.asarray(cfg.covariance, dtype=np.float64)
        if covariance.ndim == 1:
            covariance = np.diag(covariance)
        if covariance.shape != (dof, dof):
            raise ValueError(f"covariance shape {covariance.shape} != control dof {dof}")
        if cfg.rollouts < 1:
            raise ValueError("rollouts must be greater than zero")
        if cfg.keep_best_rollouts < 0:
            raise ValueError("keep_best_rollouts cannot be negative")
        if cfg.control_min is None or cfg.control_max is None:
            raise ValueError("control bounds are required")
        if len(np.asarray(cfg.control_min)) != dof or len(np.asarray(cfg.control_max)) != dof:
            raise ValueError(f"control bounds must have length {dof}")
        if cfg.optimal_rollout_mode != "batch":
            raise ValueError(
                f"optimal_rollout_mode {cfg.optimal_rollout_mode!r} is not "
                "ported; only 'batch' is"
            )

        self.configuration = cfg
        self.sampler = sampler
        self.control_dof = control_dof
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.steps = cfg.step_count
        self.rollout_count = cfg.rollout_count
        self.keep_best = min(cfg.keep_best_rollouts, cfg.rollouts)

        def constant(values):
            return torch.as_tensor(np.asarray(values), dtype=self.dtype).to(self.device)

        self._control_min = constant(cfg.control_min)
        self._control_max = constant(cfg.control_max)
        self._control_default = (
            constant(cfg.control_default) if cfg.control_default is not None else None
        )
        R = self.rollout_count
        row = torch.arange(R, device=self.device)
        self._is_static = row < STATIC_ROLLOUTS
        # Sampled rollouts in index order first, statics last: the same
        # ranks as sorting costs[2:] alone.
        self._tiebreak = torch.where(self._is_static, R + row, row)
        self._arange = row
        self._slot_offsets = torch.arange(self.steps, dtype=self.dtype, device=self.device)
        self._smoother = (
            SGSmoother(
                steps=self.steps,
                window=int(cfg.smoothing.window),
                order=int(cfg.smoothing.order),
            )
            if cfg.smoothing is not None
            else None
        )

    # -- state ---------------------------------------------------------------

    def init(self, seed: int = 0) -> PlannerState:
        steps, dof = self.steps, self.control_dof
        device, dtype = self.device, self.dtype

        def scalar(value, kind=None):
            return torch.full((), value, dtype=kind or dtype, device=device)

        sg_buffer = (
            self._smoother.init_buffer(dof, dtype, device)
            if self._smoother is not None
            else torch.zeros((0, 0), dtype=dtype, device=device)
        )
        rng = torch.Generator(device=device)
        rng.manual_seed(seed)
        return PlannerState(
            optimal_control=torch.zeros((steps, dof), dtype=dtype, device=device),
            noise=self.sampler.init_noise(dtype),
            costs=torch.zeros((self.rollout_count, 2), dtype=dtype, device=device),
            last_shift_time=scalar(0.0),
            last_update_time=scalar(0.0),
            sg_buffer=sg_buffer,
            sg_time=scalar(float("nan")),
            rng=rng,
            update_count=scalar(0, torch.int32),
            optimal_cost=scalar(0.0),
            update_duration=scalar(0.0),
        )

    # -- public API ----------------------------------------------------------

    def _as_tensor(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(value), dtype=self.dtype, device=self.device)

    def update(
        self, state: PlannerState, x, time, ctx=None, fresh=None
    ) -> tuple[PlannerState, UpdateInfo]:
        """One MPPI update at plant state ``x`` and time ``time``
        (mppi::Trajectory::update, mppi.cpp:154-187). ``ctx`` is the
        forecast context the objective reads. Pass ``x`` and ``time`` as
        tensors on the planner's device to keep the update free of host
        copies.

        ``fresh`` (parity-test hook): logical (R, steps, dof) N(0, cov)
        draws replacing the sampler's own, so a test can feed both packages
        the same numbers (the JAX planner's ``noise_override`` serves the
        same purpose)."""
        x0 = self._as_tensor(x)
        time = self._as_tensor(time)
        if fresh is not None:
            from .kernels.cuda_rollout import noise_from_logical

            fresh = noise_from_logical(self._as_tensor(fresh))
        (
            optimal_shifted, shift_by, do_shift, last_shift_time, keep_mask,
        ) = self._sample_meta(state, time)
        costs, noise, states0 = self.sampler.sample_and_rollout(
            state.rng, keep_mask, shift_by, do_shift, state.noise,
            state.optimal_control, optimal_shifted, x0, time, ctx, fresh=fresh,
        )
        optimal, weights, gradient, sg_buffer, degenerate = self._optimise(
            costs, noise, optimal_shifted, state.sg_buffer,
            self._sg_trim_offset(state, time),
        )
        sg_time = torch.where(degenerate, state.sg_time, time)
        # Zero-noise rollout 0 = the shifted optimal at the current state;
        # its cost and per-step states come from the batch, one update early.
        optimal_cost = compose_cost(costs[0])
        new_state = PlannerState(
            optimal_control=optimal,
            noise=noise,
            costs=costs,
            last_shift_time=last_shift_time,
            last_update_time=time,
            sg_buffer=sg_buffer,
            sg_time=sg_time,
            rng=state.rng,
            update_count=state.update_count + 1,
            optimal_cost=optimal_cost,
            update_duration=state.update_duration,
        )
        info = UpdateInfo(
            costs=compose_cost(costs),
            weights=weights,
            gradient=gradient,
            optimal_rollout_states=states0,
            optimal_cost=optimal_cost,
            degenerate=degenerate,
        )
        return new_state, info

    def get(self, state: PlannerState, time) -> torch.Tensor:
        """The published control at ``time`` by linear interpolation
        (mppi::Trajectory::get, mppi.cpp:481-512)."""
        time = self._as_tensor(time)
        t = true_divide(time - state.last_update_time, self.configuration.time_step)
        lower = torch.clamp(t.to(torch.int32), 0, self.steps - 1)
        upper = torch.clamp(lower + 1, max=self.steps - 1)
        frac = torch.clamp(t - lower, 0.0, 1.0)
        interpolated = (
            (1.0 - frac) * state.optimal_control[lower.long()]
            + frac * state.optimal_control[upper.long()]
        )
        past_end = lower + 1 >= self.steps
        if self._control_default is not None:
            fallback = self._control_default
        else:
            fallback = state.optimal_control[-1]
        return torch.where(past_end, fallback, interpolated)

    # -- implementation ------------------------------------------------------

    def _sample_meta(self, state: PlannerState, time: torch.Tensor):
        """Horizon shift, shifted optimal and elite keep mask
        (mppi.cpp:189-231)."""
        steps = self.steps
        shift_by = torch.clamp(
            true_divide(time - state.last_shift_time, self.configuration.time_step).to(
                torch.int32
            ),
            0,
            steps,
        )
        do_shift = shift_by > 0
        last_shift_time = torch.where(do_shift, time, state.last_shift_time)
        optimal_shifted = torch.where(
            do_shift,
            _shift_columns(state.optimal_control, shift_by),
            state.optimal_control,
        )

        # Elite ordering by last update's cost: lexicographic over
        # (saturations V, smooth S, index), NaN as +inf, statics pushed
        # behind every sampled rollout. Adding 0.0 turns -0.0 into +0.0, so
        # a radix sort on the float bits sees them as the tie they are.
        inf = torch.full((), float("inf"), dtype=state.costs.dtype, device=self.device)
        V = torch.where(torch.isnan(state.costs[:, 0]) | self._is_static, inf, state.costs[:, 0]) + 0.0
        S = torch.where(torch.isnan(state.costs[:, 1]) | self._is_static, inf, state.costs[:, 1]) + 0.0
        order = _lexsort((self._tiebreak, S, V))
        rank = torch.empty_like(order)
        rank[order] = self._arange
        keep_mask = rank < self.keep_best  # never True for statics
        return optimal_shifted, shift_by, do_shift, last_shift_time, keep_mask

    def _sg_trim_offset(self, state: PlannerState, time: torch.Tensor) -> torch.Tensor:
        """The smoothing window's trim offset, time-based like
        MovingExtendedWindow::trim (filter.cpp:47-60): the number of horizon
        slots whose fill time (sg_time + i*dt) precedes the update time. Not
        the same as the horizon shift: the truncating (time - last_shift)/dt
        and the slot-time search can disagree by one slot, as in the
        reference."""
        slot_times = state.sg_time + self._slot_offsets * self.configuration.time_step
        return torch.where(
            torch.isnan(state.sg_time),
            0,
            torch.sum((slot_times < time).to(torch.int32)),
        )

    def _optimise(self, costs, noise, optimal_shifted, sg_buffer, sg_shift):
        """Weight, step, smooth, clip (mppi.cpp:344-448). The min/max
        normalisation and softmax run on the lexicographic composition
        (V - Vmin) * BARRIER_SCALE + (S - Sref), the reference's float64
        (cost - minimum) without float32 cancellation."""
        cfg = self.configuration
        V, S = costs[..., 0], costs[..., 1]
        valid = ~(torch.isnan(V) | torch.isnan(S))
        big = torch.full((), float("inf"), dtype=S.dtype, device=S.device)

        v_min = torch.min(torch.where(valid, V, big))
        s_at_vmin = torch.min(torch.where(valid & (V == v_min), S, big))
        v_max = torch.max(torch.where(valid, V, -big))
        s_at_vmax = torch.max(torch.where(valid & (V == v_max), S, -big))

        difference = (v_max - v_min) * BARRIER_SCALE + (s_at_vmax - s_at_vmin)
        # Degenerate spread: skip the update entirely (mppi.cpp:373-375);
        # also covers the all-NaN case.
        degenerate = ~(difference >= 1e-6)

        relative = (V - v_min) * BARRIER_SCALE + (S - s_at_vmin)
        likelihood = torch.where(
            valid,
            torch.exp(
                -cfg.cost_scale * relative / torch.where(difference > 0, difference, 1.0)
            ),
            0.0,
        )
        total = torch.sum(likelihood)
        weights = likelihood / torch.where(total > 0, total, 1.0)

        # Weighted noise sum = gradient estimate (mppi.cpp:413-418).
        gradient = self.sampler.weighted_noise_sum(noise, weights)
        updated = optimal_shifted + cfg.gradient_step * gradient

        if self._smoother is not None:
            smoothed, new_buffer = sg_smooth(self._smoother, sg_buffer, updated, sg_shift)
            updated = smoothed
            sg_buffer = torch.where(degenerate, sg_buffer, new_buffer)

        if cfg.control_bound:
            updated = torch.clamp(updated, self._control_min, self._control_max)

        optimal = torch.where(degenerate, optimal_shifted, updated)
        return optimal, weights, gradient, sg_buffer, degenerate

"""The plain reference of one MPPI update of a ``franka-mppi-*``
configuration (mppi::Trajectory::update, mppi.cpp:154-187 of the C++
reference), in plain PyTorch on whatever device its tensors are on.

It imports nothing of the program. The discrete decisions of an update
(the horizon shift, the elite keep mask, the smoothing window's trim, the
static rows of the noise) are taken in float32 from the float32 state, as a
float32 configuration states them; everything continuous (the 10,000
rollouts through the frozen lanes step, the weights, the gradient step, the
Savitzky-Golay pass, the clip, the safety filter's re-rollout through the
frozen plant) runs in ``dtype``: float64 for the judge, bfloat16 for the
benchmark's lower-precision control. The fresh draws are made here from the
update's seed words, as the configuration's sampler defines them
(``samplers/<name>.py``).

``Setup.from_config`` reads a configuration file's numbers; ``init_state``
is a planner's first state; ``update(setup, state, time, words, dtype)``
returns the state after one update (``optimal_control`` is the published
sequence)."""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from . import frankaridgeback as fr
from .assisted_manipulation import AssistedManipulation, Configuration as ObjectiveConfiguration, ForecastContext
from .lane_rollout import rollout_steps, step_data
from .model_data import frankaridgeback_model
from .plant import plant_rollout
from .safety import make_safety_filter
from .sg_filter import SGSmoother, sg_apply_sequential, sg_fill_horizon, sg_trim

STATIC_ROLLOUTS = 2
BARRIER_SCALE = 1e10  # ops/costs.MAXIMUM_COST_DEFAULT: saturations before smooth cost


@dataclasses.dataclass
class Setup:
    """What one update of the configuration reads besides its state."""

    rollouts: int  # all rollouts, the two static ones included
    steps: int
    time_step: float
    keep_best: int
    gradient_step: float
    cost_scale: float
    discount: float
    scale: np.ndarray  # (12,) float32 standard deviations of the draws
    control_min: np.ndarray
    control_max: np.ndarray
    smoother: SGSmoother
    x0: np.ndarray  # (31,) plant state
    wrench: np.ndarray  # (6,) the constant forecast wrench
    safety: bool
    sampler: str  # the module of samplers/ that makes the fresh draws

    @classmethod
    def from_config(cls, config: dict, traffic: dict) -> "Setup":
        mppi = config["mppi"]
        steps = int(round(mppi["horizon"] / mppi["time_step"]))
        covariance = np.asarray(mppi["covariance"], np.float64)
        return cls(
            rollouts=int(mppi["rollouts"]) + STATIC_ROLLOUTS,
            steps=steps,
            time_step=float(mppi["time_step"]),
            keep_best=min(int(mppi["keep_best_rollouts"]), int(mppi["rollouts"])),
            gradient_step=float(mppi["gradient_step"]),
            cost_scale=float(mppi["cost_scale"]),
            discount=float(mppi["cost_discount_factor"]),
            scale=np.sqrt(covariance).astype(np.float32),
            control_min=np.asarray(mppi["control_min"], np.float64),
            control_max=np.asarray(mppi["control_max"], np.float64),
            smoother=SGSmoother(steps, int(mppi["smoothing"]["window"]), int(mppi["smoothing"]["order"])),
            x0=fr.make_state(config["plant"]["preset"], float(config["plant"]["energy"])),
            wrench=np.asarray(traffic["wrench"], np.float64),
            safety=bool(config["safety_filter"]),
            sampler=mppi["sampler"],
        )


def init_state(setup: Setup, device) -> dict:
    """The planner's first state (mppi.Planner.init): zeros, NaN smoothing
    time, update count 0."""
    f32 = torch.float32
    S, R = setup.steps, setup.rollouts

    def scalar(value, dtype=f32):
        return torch.full((), value, dtype=dtype, device=device)

    return {
        "optimal_control": torch.zeros((S, 12), dtype=f32, device=device),
        "noise": torch.zeros((S, 12, R), dtype=f32, device=device),
        "costs": torch.zeros((R, 2), dtype=f32, device=device),
        "last_shift_time": scalar(0.0),
        "last_update_time": scalar(0.0),
        "sg_buffer": torch.zeros((12, setup.smoother.buffer_length), dtype=f32, device=device),
        "sg_time": scalar(float("nan")),
        "update_count": scalar(0, torch.int32),
    }


def _per_step32(elapsed: torch.Tensor, dt: float) -> torch.Tensor:
    """A float32 span in steps: the product with float32(1 / dt)."""
    return elapsed * torch.tensor(np.float32(1.0) / np.float32(dt), device=elapsed.device)


def keep_mask(setup: Setup, costs: torch.Tensor) -> torch.Tensor:
    """The ``keep_best`` sampled rollouts first in (saturations, smooth,
    index) order, NaN as +inf, statics never (numpy's lexsort on the host)."""
    R = setup.rollouts
    values = costs.detach().cpu().numpy().astype(np.float32)
    static = np.arange(R) < STATIC_ROLLOUTS
    V = np.where(np.isnan(values[:, 0]) | static, np.inf, values[:, 0]) + np.float32(0.0)
    S = np.where(np.isnan(values[:, 1]) | static, np.inf, values[:, 1]) + np.float32(0.0)
    order = np.lexsort((np.arange(R), static, S, V))
    rank = np.empty(R, np.int64)
    rank[order] = np.arange(R)
    return torch.as_tensor((rank < setup.keep_best) & ~static, device=costs.device)


def fresh_draws(setup: Setup, words: tuple, device) -> torch.Tensor:
    """(S, 12, R) float32 N(0, diag(scale^2)) draws of one update, made by
    the configuration's sampler (``samplers/<name>.py``)."""
    return importlib.import_module(f"{__package__}.samplers.{setup.sampler}").fresh_draws(setup, words, device)


def assemble_noise(optimal, shift, do_shift, old, fresh, keep) -> torch.Tensor:
    """Elite rows keep their noise, shifted with a fresh tail; the others
    take fresh draws; row 0 carries zero noise, row 1 minus the previous
    optimal sequence (mppi.cpp:239-269)."""
    S, _, R = old.shape
    col = torch.arange(S, device=old.device)
    kept = torch.where((col >= S - shift)[:, None, None], fresh, old[torch.clamp(col + shift, max=S - 1)])
    kept = torch.where(do_shift, kept, old)
    noise = torch.where(keep[None, None, :], kept, fresh)
    noise[:, :, 0] = 0.0
    noise[:, :, 1] = -optimal
    return noise


def _ctx(setup: Setup, time: torch.Tensor, dtype) -> ForecastContext:
    horizon = torch.as_tensor(np.tile(setup.wrench, (setup.steps + 1, 1)), dtype=dtype, device=time.device)
    return ForecastContext(horizon, time.to(dtype), setup.time_step, setup.steps * setup.time_step)


def update(setup: Setup, state: dict, time: float, words: tuple, dtype=torch.float64) -> dict:
    """The state after one update at tick ``time`` (a float32 value) with
    the update's seed ``words``."""
    f32 = torch.float32
    device = state["noise"].device
    S, R, dt = setup.steps, setup.rollouts, setup.time_step
    t = torch.tensor(time, dtype=f32, device=device)

    # Horizon shift and elite mask (mppi.cpp:189-231), in float32.
    shift = torch.clamp(_per_step32(t - state["last_shift_time"], dt).to(torch.int32), 0, S)
    do_shift = shift > 0
    last_shift_time = torch.where(do_shift, t, state["last_shift_time"])
    optimal = state["optimal_control"]
    shifted = torch.where(do_shift, optimal[torch.clamp(torch.arange(S, device=device) + shift, max=S - 1)], optimal)
    keep = keep_mask(setup, state["costs"])
    noise = assemble_noise(optimal, shift, do_shift, state["noise"], fresh_draws(setup, words, device), keep)

    # The rollouts (mppi.cpp:272-342) through the frozen lanes step.
    model = frankaridgeback_model()
    objective = ObjectiveConfiguration()
    _, kp, kd = fr.Configuration().resolve()
    ctx = _ctx(setup, t, dtype)
    traj = step_data(objective, ctx, t.to(dtype), S, dt, noise.to(dtype))
    discounts = setup.discount ** torch.arange(S, dtype=dtype, device=device)
    costs, _ = rollout_steps(
        model, objective, kp, kd, dt, noise.to(dtype), shifted.to(dtype), torch.as_tensor(setup.x0, dtype=dtype, device=device),
        traj, discounts,
    )

    # Weights, gradient step, smoothing, clip (mppi.cpp:344-448).
    V, Sm = costs[:, 0], costs[:, 1]
    valid = ~(torch.isnan(V) | torch.isnan(Sm))
    inf = torch.tensor(math.inf, dtype=dtype, device=device)
    v_min = torch.min(torch.where(valid, V, inf))
    s_at_vmin = torch.min(torch.where(valid & (V == v_min), Sm, inf))
    v_max = torch.max(torch.where(valid, V, -inf))
    s_at_vmax = torch.max(torch.where(valid & (V == v_max), Sm, -inf))
    difference = (v_max - v_min) * BARRIER_SCALE + (s_at_vmax - s_at_vmin)
    degenerate = ~(difference >= 1e-6)
    relative = (V - v_min) * BARRIER_SCALE + (Sm - s_at_vmin)
    likelihood = torch.where(
        valid, torch.exp(-setup.cost_scale * relative / torch.where(difference > 0, difference, 1.0)), 0.0
    )
    total = torch.sum(likelihood)
    weights = likelihood / torch.where(total > 0, total, 1.0)
    gradient = torch.einsum("sdr,r->sd", noise.to(dtype), weights)
    updated = shifted.to(dtype) + setup.gradient_step * gradient

    slot_times = state["sg_time"] + torch.arange(S, dtype=f32, device=device) * dt
    trim = torch.where(torch.isnan(state["sg_time"]), 0, torch.sum((slot_times < t).to(torch.int32)))
    buffer = sg_trim(setup.smoother, state["sg_buffer"].to(dtype), trim)
    buffer = sg_fill_horizon(setup.smoother, buffer, updated)
    smoothed, buffer = sg_apply_sequential(setup.smoother, buffer)
    sg_buffer = torch.where(degenerate, state["sg_buffer"].to(dtype), buffer)
    lower = torch.as_tensor(setup.control_min, dtype=dtype, device=device)
    upper = torch.as_tensor(setup.control_max, dtype=dtype, device=device)
    published = torch.where(degenerate, shifted.to(dtype), torch.clamp(smoothed, lower, upper))

    if setup.safety:
        # The published sequence re-rolled through the plant, each step's
        # control through the ADMM-QP filter (mppi.cpp:450-479).
        plant = fr.make_plant(AssistedManipulation(objective), fr.Configuration(), model)
        _, _, published = plant_rollout(
            plant, published, torch.as_tensor(setup.x0, dtype=dtype, device=device), t.to(dtype), ctx, dt,
            setup.discount, filter_fn=make_safety_filter(),
        )

    return {
        "optimal_control": published,
        "noise": noise,
        "costs": costs,
        "last_shift_time": last_shift_time,
        "last_update_time": t,
        "sg_buffer": sg_buffer,
        "sg_time": torch.where(degenerate, state["sg_time"], t),
        "update_count": state["update_count"] + 1,
    }

"""The plain reference of one Kalman-driven serving tick of a
``franka-mppi-*-kalman*`` configuration: the forecast update, the
posterior scenario ensemble and the MPPI update scored against every
scenario and reduced by their mean (the port's
``parallel/flagship.make_serving_tick``; in the C++ reference
``Actor::add_end_effector_wrench`` -> ``KalmanForecast::update`` and then
``mppi::Trajectory::update``, mppi.cpp:154-187).

Plain PyTorch on whatever device its tensors are on; it imports nothing of
the program, and turns TF32 off. The forecast half is ``forecast.py``. The
update is ``update.py``'s, with its functions, except where the ensemble
enters: each rollout's controls run once per scenario, the C copies of the
batch side by side in the lanes of the frozen lanes step (lane c R + r is
rollout r under scenario c), and the two cost channels are the scenario
mean, a NaN in any scenario poisoning the rollout. The discrete decisions
and the draws are made in the program's precision, the state's dtype
(float32 in every cell); the rest in ``dtype`` (float64 for the judge,
bfloat16 for the lower-precision control).

The draws are made here: the planner's fresh noise from the update's seed
words, as ``samplers/torch_randn.py`` makes it, and the scenario normals by
``torch.randn`` from the generator state the tick started at.

``TickSetup.from_config`` reads a configuration file's numbers;
``tick(setup, state, measurement, time, words, dtype)`` returns the state
after the tick: the planner's fields as ``update.update`` names them, ``forecast`` (the forecast state),
``horizons`` (C, steps + 1, observed) and ``scenario_rng`` (the scenario
generator's state after its draw)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import forecast as forecast_reference
from . import frankaridgeback as fr
from .assisted_manipulation import Configuration as ObjectiveConfiguration, ForecastContext
from .keys import seed_bits
from .lane_rollout import TrajectoryStepData, rollout_steps, step_data
from .model_data import frankaridgeback_model
from .ops import per_step
from .sg_filter import sg_apply_sequential, sg_fill_horizon, sg_trim
from .update import BARRIER_SCALE, STATIC_ROLLOUTS, Setup, assemble_noise


@dataclasses.dataclass
class TickSetup:
    """What one tick of the configuration reads besides its state."""

    planner: Setup  # ``update.Setup``; its constant ``wrench`` is unused: the tick's forecast is the ensemble
    forecast: forecast_reference.Forecast
    scenarios: int
    covariance: np.ndarray  # (12,) the draws' variances

    @classmethod
    def from_config(cls, config: dict) -> "TickSetup":
        return cls(
            planner=Setup.from_config(config, {"wrench": np.zeros(6)}),
            forecast=forecast_reference.Forecast.from_config(config),
            scenarios=int(config["flagship"]["scenarios"]),
            covariance=np.asarray(config["mppi"]["covariance"], np.float64),
        )


PLANNER_FIELDS = ("optimal_control", "noise", "costs", "last_shift_time", "last_update_time", "sg_buffer", "sg_time",
                  "update_count")


def keep_mask(keep_best: int, costs: torch.Tensor) -> torch.Tensor:
    """``update.keep_mask`` in the costs' own precision: the ``keep_best``
    sampled rollouts first in (saturations, smooth, index) order, NaN as
    +inf, statics never."""
    R = costs.shape[0]
    values = costs.detach().cpu().numpy()
    static = np.arange(R) < STATIC_ROLLOUTS
    inf = values.dtype.type(np.inf)
    V = np.where(np.isnan(values[:, 0]) | static, inf, values[:, 0]) + values.dtype.type(0.0)
    S = np.where(np.isnan(values[:, 1]) | static, inf, values[:, 1]) + values.dtype.type(0.0)
    order = np.lexsort((np.arange(R), static, S, V))
    rank = np.empty(R, np.int64)
    rank[order] = np.arange(R)
    return torch.as_tensor((rank < keep_best) & ~static, device=costs.device)


def fresh_draws(setup: TickSetup, words: tuple, device, precision) -> torch.Tensor:
    """(S, 12, R) N(0, diag(covariance)) draws of one update in the state's
    precision (``samplers/torch_randn.py`` for float32): the standard
    deviations taken in float64 and rounded to the precision."""
    planner = setup.planner
    generator = torch.Generator(device=device)
    generator.manual_seed(seed_bits(words))
    z = torch.randn((planner.steps, 12, planner.rollouts), generator=generator, dtype=precision, device=device)
    scale = torch.as_tensor(np.sqrt(setup.covariance), dtype=precision, device=device)
    return z * scale.reshape(1, 12, 1)


def _lanes(traj: TrajectoryStepData, rollouts: int) -> TrajectoryStepData:
    """(C, S, ...) per-scenario step data -> per-lane (S, ..., C x R), lane
    c R + r under scenario c."""
    return TrajectoryStepData(*(field.movedim(0, -1).repeat_interleave(rollouts, dim=-1) for field in traj))


def ensemble_costs(setup: Setup, noise, shifted, t, horizons, horizon: float, dtype) -> torch.Tensor:
    """(R, 2) costs: every rollout under every scenario of ``horizons``
    (C, S + 1, 6), the scenario mean of each channel."""
    S, R, dt = setup.steps, setup.rollouts, setup.time_step
    C = horizons.shape[0]
    device = noise.device
    objective = ObjectiveConfiguration()
    _, kp, kd = fr.Configuration().resolve()
    ctx = ForecastContext(horizons.to(dtype), t.to(dtype), dt, horizon)
    traj = _lanes(step_data(objective, ctx, t.to(dtype), S, dt, noise.to(dtype)), R)
    discounts = setup.discount ** torch.arange(S, dtype=dtype, device=device)
    costs, _ = rollout_steps(
        frankaridgeback_model(), objective, kp, kd, dt, noise.to(dtype).repeat(1, 1, C), shifted.to(dtype),
        torch.as_tensor(setup.x0, dtype=dtype, device=device), traj, discounts,
    )
    return costs.reshape(C, R, 2).mean(dim=0)


def planner_update(tick_setup: TickSetup, state: dict, t: torch.Tensor, words: tuple, horizons, dtype) -> dict:
    """``update.update`` against the ensemble ``horizons`` at tick ``t`` (a
    0-d tensor in the state's precision)."""
    setup = tick_setup.planner
    device = state["noise"].device
    precision = state["noise"].dtype
    S = setup.steps

    shift = torch.clamp(per_step(t - state["last_shift_time"], setup.time_step).to(torch.int32), 0, S)
    do_shift = shift > 0
    last_shift_time = torch.where(do_shift, t, state["last_shift_time"])
    optimal = state["optimal_control"]
    shifted = torch.where(do_shift, optimal[torch.clamp(torch.arange(S, device=device) + shift, max=S - 1)], optimal)
    keep = keep_mask(setup.keep_best, state["costs"])
    noise = assemble_noise(optimal, shift, do_shift, state["noise"], fresh_draws(tick_setup, words, device, precision),
                           keep)

    costs = ensemble_costs(setup, noise, shifted, t, horizons, tick_setup.forecast.horizon, dtype)

    # Weights, gradient step, smoothing, clip (mppi.cpp:344-448), as update.py.
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

    slot_times = state["sg_time"] + torch.arange(S, dtype=precision, device=device) * setup.time_step
    trim = torch.where(torch.isnan(state["sg_time"]), 0, torch.sum((slot_times < t).to(torch.int32)))
    buffer = sg_trim(setup.smoother, state["sg_buffer"].to(dtype), trim)
    buffer = sg_fill_horizon(setup.smoother, buffer, updated)
    smoothed, buffer = sg_apply_sequential(setup.smoother, buffer)
    sg_buffer = torch.where(degenerate, state["sg_buffer"].to(dtype), buffer)
    lower = torch.as_tensor(setup.control_min, dtype=dtype, device=device)
    upper = torch.as_tensor(setup.control_max, dtype=dtype, device=device)
    published = torch.where(degenerate, shifted.to(dtype), torch.clamp(smoothed, lower, upper))
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


def tick(setup: TickSetup, state: dict, measurement, time, words: tuple, dtype=torch.float64) -> dict:
    """The state after one tick from ``state`` (the planner's fields, the
    forecast state under ``forecast`` and the scenario generator's state
    under ``scenario_rng``): ``measurement`` (6,) measured at ``time``, the
    planner's seed ``words``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f_state = state["forecast"]
    device = f_state["state"].device
    precision = f_state["state"].dtype
    forecast = setup.forecast
    new_forecast = forecast_reference.update(forecast, f_state, measurement, time, dtype)
    normals, rng_after = forecast_reference.draws(state["scenario_rng"], setup.scenarios, forecast, device, precision)
    horizons = forecast_reference.scenarios(forecast, new_forecast, normals, dtype)
    t = torch.as_tensor(time, dtype=state["noise"].dtype, device=device)
    planner = planner_update(setup, {name: state[name] for name in PLANNER_FIELDS}, t, words, horizons, dtype)
    return dict(planner, forecast=new_forecast, horizons=horizons, scenario_rng=rng_after)

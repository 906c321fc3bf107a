"""AssistedManipulation objective: configuration and forecast context (port
of the parts of assistedmanipulation_tpu/objectives/assisted_manipulation.py
that the fused rollout reads; the per-term objective class is not ported
yet — kernels/lane_rollout.step_cost_and_dynamics evaluates the seven terms).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import true_divide

# Self-collision pair table (assisted_manipulation.cpp:92-125), as indices
# into the collision link positions [pivot, panda_link1..7]. The radii table
# indexes the same way (link enum - 3, assisted_manipulation.cpp:144).
COLLISION_PAIRS = np.array(
    [(0, j) for j in (3, 4, 5, 6, 7)]
    + [(1, j) for j in (3, 4, 5, 6, 7)]
    + [(2, j) for j in (4, 5, 6, 7)]
    + [(3, j) for j in (5, 6, 7)]
    + [(4, j) for j in (6, 7)]
    + [(5, 7)],
    dtype=np.int32,
)


class ForecastContext(NamedTuple):
    """Per-update forecast cache: the end-effector wrench over the horizon
    (the DynamicsForecast handle of the reference, dynamics.hpp:133-171).

    ``wrench_horizon`` is one forecast (steps + 1, 6), or a scenario
    ensemble (C, steps + 1, 6) — scenario 0 the mean, the rest posterior
    draws (forecast/scenarios.sample_scenarios). The two-pass sampler scores
    all scenarios in one kernel launch; the plain scenario rollout
    (forecast/scenarios.make_scenario_rollout_fn) scores them one by one
    (``scenario_contexts``).

    ``wrench(t)`` interpolates linearly between cached steps and is zero
    beyond the horizon (KalmanForecast::forecast, forecast.cpp:342-367),
    for every scenario of an ensemble at once."""

    wrench_horizon: torch.Tensor  # (steps + 1, 6) or (C, steps + 1, 6)
    start_time: torch.Tensor  # 0-d
    time_step: float
    horizon: float

    def wrench(self, t: torch.Tensor) -> torch.Tensor:
        """(T,) times -> (T, 6) wrenches, or (C, T, 6) for an ensemble."""
        horizon = self.wrench_horizon
        rel = true_divide(t - self.start_time, self.time_step)
        steps = horizon.shape[-2] - 1
        lower = torch.clamp(rel.to(torch.int32), 0, steps - 1)
        frac = torch.clamp(rel - lower, 0.0, 1.0)[:, None]
        lower = lower.long()
        value = (1.0 - frac) * horizon[..., lower, :] + frac * horizon[..., lower + 1, :]
        beyond = ((t - self.start_time) > self.horizon)[:, None]
        return torch.where(beyond, torch.zeros_like(value), value)


def scenario_contexts(ctx: Optional[ForecastContext]) -> list:
    """One context per forecast scenario: a (C, S+1, 6) ensemble ctx splits
    into C contexts; a single-forecast ctx (or none) stays one."""
    if ctx is None or ctx.wrench_horizon.ndim == 2:
        return [ctx]
    return [ctx._replace(wrench_horizon=horizon) for horizon in ctx.wrench_horizon]


@dataclasses.dataclass
class Configuration:
    """Defaults = assisted_manipulation.hpp:133-206 verbatim."""

    enable_joint_limit: bool = True
    enable_self_collision_limit: bool = True
    enable_workspace_limit: bool = True
    enable_energy_limit: bool = False
    enable_velocity_cost: bool = True
    enable_trajectory_cost: bool = True
    enable_manipulability_cost: bool = True

    # (bound, scale) per joint.
    lower_joint_limit: tuple = (
        (-2.0, 0.0), (-2.0, 0.0), (-6.28, 0.0),
        (-2.8, 10.0), (-1.745, 10.0), (-2.8, 10.0), (-3.0718, 10.0),
        (-2.7925, 10.0), (0.349, 10.0), (-2.967, 10.0),
        (0.0, 0.0), (0.0, 0.0),
    )
    upper_joint_limit: tuple = (
        (2.0, 0.0), (2.0, 0.0), (6.28, 0.0),
        (2.8, 10.0), (1.745, 10.0), (2.8, 10.0), (0.0, 10.0),
        (2.7925, 10.0), (4.53785, 10.0), (2.967, 10.0),
        (0.5, 0.0), (0.5, 0.0),
    )
    self_collision_limit: tuple = (0.0, 1.0)  # (lower_bound, scale)
    self_collision_radii: tuple = (0.75, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
    workspace_limit_above: tuple = (0.0, 1.0)
    workspace_limit_infront: tuple = (0.0, 1.0)
    workspace_limit_reach: tuple = (1.0, 1.0)  # (upper_bound, scale)
    workspace_cost_yaw: float = 400.0  # quadratic
    energy_limit_below: tuple = (0.0, 10.0)
    energy_limit_above: tuple = (20.0, 10.0)
    velocity_cost: tuple = (
        1000.0, 1000.0, 100.0, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.0, 0.0
    )
    trajectory_target_scale: float = 1e-2
    trajectory_target_maximum: float = 1.0
    trajectory_position_constant: float = 100.0
    trajectory_position_quadratic: float = 500.0
    trajectory_position_threshold: float = 0.0
    trajectory_velocity_quadratic: float = 500.0
    trajectory_velocity_minimum: float = 0.1
    trajectory_velocity_maximum: float = 5.0
    trajectory_velocity_dropoff: float = 2.0
    manipulability_quadratic: float = 10.0

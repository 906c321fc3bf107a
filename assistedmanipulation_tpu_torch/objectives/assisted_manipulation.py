"""AssistedManipulation objective: 7 independently-toggled cost terms (port
of assistedmanipulation_tpu/objectives/assisted_manipulation.py).

Batched re-implementation of the reference objective
(src/frankaridgeback/objective/assisted_manipulation.cpp:37-319) with the
exact default gain table (assisted_manipulation.hpp:133-206). Each term is a
function of (state, control, RobotAux, t, ForecastContext) over a batch of
states; the total is their sum, as (saturations, smooth) channels. Per-term
values are exposed for observability (assisted_manipulation.cpp:24-35).
The fused CUDA kernels evaluate the same seven terms in
kernels/csrc/franka_step.cuh (plain version:
kernels/lane_rollout.step_cost_and_dynamics).

Every term is branch-free; NaN state still poisons the cost (the rollout
weighting relies on it, mppi.cpp:331-334).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.frankaridgeback import ENERGY, POSITION, VELOCITY, RobotAux
from ..ops import constant, per_step
from ..ops.costs import LeftInverseBarrier, QuadraticCost, RightInverseBarrier

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


def _pair_difference_matrix(pairs: np.ndarray, links: int) -> np.ndarray:
    """(P, links) matrix D with D @ positions = positions[first] - positions[second]."""
    D = np.zeros((len(pairs), links))
    D[np.arange(len(pairs)), pairs[:, 0]] = 1.0
    D[np.arange(len(pairs)), pairs[:, 1]] = -1.0
    return D


PAIR_DIFFERENCE = _pair_difference_matrix(COLLISION_PAIRS, 8)


def _compose(channels):
    violations, smooth = channels
    return violations * 1e10 + smooth


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
        rel = per_step(t - self.start_time, self.time_step)
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


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices: the triple product of the rows
    (elementwise; the JAX version's jnp.linalg.det is an LU factorisation)."""
    return torch.sum(m[..., 0, :] * torch.linalg.cross(m[..., 1, :], m[..., 2, :], dim=-1), dim=-1)


def pointwise_wrench(ctx: ForecastContext, t) -> torch.Tensor:
    """The forecast wrench at time(s) ``t`` (...) as (..., 6). A scenario
    ensemble is read at its nominal scenario 0, as the JAX objective's
    pointwise reads are (objectives/assisted_manipulation.py:65-69); the
    batch rollout scores an ensemble scenario by scenario
    (forecast/scenarios.make_scenario_rollout_fn)."""
    if ctx.wrench_horizon.ndim == 3:
        ctx = ctx._replace(wrench_horizon=ctx.wrench_horizon[0])
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=ctx.wrench_horizon.dtype, device=ctx.wrench_horizon.device)
    return ctx.wrench(t.reshape(-1)).reshape(*t.shape, 6)


class AssistedManipulation:
    """Callable objective with per-term breakdown, over a batch of states."""

    TERM_NAMES = (
        "joint_limit",
        "self_collision",
        "workspace",
        "energy",
        "velocity",
        "trajectory",
        "manipulability",
    )

    def __init__(self, configuration: Configuration = None):
        self.configuration = configuration or Configuration()
        c = self.configuration
        # Array-parameterized barriers: all 12 joints evaluate in one
        # decomposed() call (the bounds/scales broadcast).
        lower = np.asarray(c.lower_joint_limit)
        upper = np.asarray(c.upper_joint_limit)
        self._lower = LeftInverseBarrier(lower[:, 0], lower[:, 1])
        self._upper = RightInverseBarrier(upper[:, 0], upper[:, 1])
        self._collision = LeftInverseBarrier(*c.self_collision_limit)
        self._above = LeftInverseBarrier(*c.workspace_limit_above)
        self._infront = LeftInverseBarrier(*c.workspace_limit_infront)
        self._reach = RightInverseBarrier(*c.workspace_limit_reach)
        self._yaw = QuadraticCost(quadratic_cost=c.workspace_cost_yaw)
        self._energy_below = LeftInverseBarrier(*c.energy_limit_below)
        self._energy_above = RightInverseBarrier(*c.energy_limit_above)
        self._trajectory_position = QuadraticCost(
            constant_cost=c.trajectory_position_constant,
            quadratic_cost=c.trajectory_position_quadratic,
        )
        self._trajectory_velocity = QuadraticCost(quadratic_cost=c.trajectory_velocity_quadratic)
        self._manipulability = QuadraticCost(quadratic_cost=c.manipulability_quadratic)
        radii = np.asarray(c.self_collision_radii)
        self._pair_radii = radii[COLLISION_PAIRS[:, 0]] + radii[COLLISION_PAIRS[:, 1]]

    # -- terms (assisted_manipulation.cpp:74-319) ----------------------------
    # Each *_channels method returns (saturations, smooth) — see
    # ops/costs.py two-channel decomposition. The *_cost wrappers compose a
    # scalar for logging/tests.

    def joint_limit_channels(self, q):
        vl, sl = self._lower.decomposed(q)
        vu, su = self._upper.decomposed(q)
        return torch.sum(vl + vu, dim=-1), torch.sum(sl + su, dim=-1)

    def joint_limit_cost(self, q):
        return _compose(self.joint_limit_channels(q))

    def self_collision_channels(self, aux: RobotAux):
        positions = aux.collision_link_positions  # (..., 8, 3)
        difference = constant(PAIR_DIFFERENCE, positions) @ positions  # (..., pairs, 3)
        distance = torch.linalg.vector_norm(difference, dim=-1)
        # collision = distance - radii (assisted_manipulation.cpp:149)
        gap = distance - constant(self._pair_radii, distance)
        v, s = self._collision.decomposed(gap)
        return torch.sum(v, dim=-1), torch.sum(s, dim=-1)

    def self_collision_cost(self, aux: RobotAux):
        return _compose(self.self_collision_channels(aux))

    def workspace_channels(self, x, aux: RobotAux):
        yaw = x[..., POSITION][..., 2]
        c, s = torch.cos(yaw), torch.sin(yaw)
        forward = torch.stack([c, s, torch.zeros_like(c)], dim=-1)
        offset = torch.stack([0.1 * c - 0.0 * s, 0.1 * s, torch.full_like(c, 0.15)], dim=-1)
        robot = aux.arm_mount_position + offset
        to_ee = aux.ee_position - robot

        projection = torch.sum(to_ee * forward, dim=-1) / torch.sum(forward * forward, dim=-1)
        v_in, s_in = self._infront.decomposed(projection)

        reach = torch.linalg.vector_norm(to_ee, dim=-1)
        v_re, s_re = self._reach.decomposed(reach)

        v1 = to_ee[..., :2]
        v2 = forward[..., :2]
        denom = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
        cos_angle = torch.sum(v1 * v2, dim=-1) / torch.where(denom > 0, denom, 1.0)
        angle = torch.arccos(torch.clamp(cos_angle, -1.0, 1.0))
        # The reference skips NaN yaw (assisted_manipulation.cpp:199-201).
        yaw_cost = torch.where(denom > 0, self._yaw(torch.abs(angle)), 0.0)

        height = aux.ee_position[..., 2] - robot[..., 2]
        v_ab, s_ab = self._above.decomposed(height)
        return v_in + v_re + v_ab, s_in + s_re + s_ab + yaw_cost

    def workspace_cost(self, x, aux: RobotAux):
        return _compose(self.workspace_channels(x, aux))

    def energy_channels(self, x):
        energy = x[..., ENERGY]
        vb, sb = self._energy_below.decomposed(energy)
        va, sa = self._energy_above.decomposed(energy)
        return vb + va, sb + sa

    def energy_cost(self, x):
        return _compose(self.energy_channels(x))

    def velocity_cost(self, x):
        v = x[..., VELOCITY]
        return torch.sum(constant(self.configuration.velocity_cost, v) * v * v, dim=-1)

    def trajectory_cost(self, aux: RobotAux, t, ctx: Optional[ForecastContext]):
        velocity = aux.ee_linear_velocity
        if ctx is None:
            return torch.zeros_like(velocity[..., 0])
        c = self.configuration
        force = pointwise_wrench(ctx, t)[..., :3]
        target = torch.clamp(
            c.trajectory_target_scale * force, -c.trajectory_target_maximum, c.trajectory_target_maximum
        )
        distance = torch.linalg.vector_norm(target, dim=-1)

        position_cost = self._trajectory_position(distance)

        denom = torch.sum(target * target, dim=-1)
        safe_denom = torch.where(denom > 0, denom, 1.0)
        projection = torch.sum(velocity * target, dim=-1) / safe_denom
        projection = torch.sign(projection) * torch.linalg.vector_norm(target * projection[..., None], dim=-1)

        velocity_target = torch.clamp(
            torch.exp(c.trajectory_velocity_dropoff * distance) - 1.0,
            c.trajectory_velocity_minimum,
            c.trajectory_velocity_maximum,
        )
        velocity_cost = self._trajectory_velocity(torch.abs(velocity_target - projection))

        active = distance > c.trajectory_position_threshold
        return torch.where(active, position_cost + velocity_cost, 0.0)

    def manipulability_cost(self, aux: RobotAux):
        # jacobian.rightCols(9).topLeftCorner(3, 7) = linear rows, arm columns
        # (assisted_manipulation.cpp:296-298).
        J_arm = aux.ee_jacobian[..., 0:3, 3:10]
        volume = torch.sqrt(_det3(J_arm @ J_arm.mT))
        volume = torch.where(torch.isnan(volume), 1e-5, torch.clamp(volume, 1e-5, 1e5))
        return self._manipulability(1.0 / volume)

    # -- aggregation ---------------------------------------------------------

    def channel_terms(self, x, u, aux: RobotAux, t, ctx=None):
        """Per-term (saturations, smooth) channel pairs."""
        c = self.configuration
        zero = torch.zeros_like(x[..., 0])

        def smooth_only(value):
            return (torch.zeros_like(value), value)

        return {
            "joint_limit": (
                self.joint_limit_channels(x[..., POSITION]) if c.enable_joint_limit else (zero, zero)
            ),
            "self_collision": (
                self.self_collision_channels(aux) if c.enable_self_collision_limit else (zero, zero)
            ),
            "workspace": (self.workspace_channels(x, aux) if c.enable_workspace_limit else (zero, zero)),
            "energy": (self.energy_channels(x) if c.enable_energy_limit else (zero, zero)),
            "velocity": (smooth_only(self.velocity_cost(x)) if c.enable_velocity_cost else (zero, zero)),
            "trajectory": (
                smooth_only(self.trajectory_cost(aux, t, ctx)) if c.enable_trajectory_cost else (zero, zero)
            ),
            "manipulability": (
                smooth_only(self.manipulability_cost(aux)) if c.enable_manipulability_cost else (zero, zero)
            ),
        }

    def terms(self, x, u, aux: RobotAux, t, ctx=None):
        """Composed per-term scalars for observability (the reference's
        per-term accumulators, assisted_manipulation.cpp:24-35)."""
        return {name: _compose(channels) for name, channels in self.channel_terms(x, u, aux, t, ctx).items()}

    def __call__(self, x, u, aux, t, ctx=None):
        """The (saturations, smooth) channel pair as (..., 2) — the planner
        accumulates the channels separately (mppi.as_cost_channels)."""
        violations, smooth = 0.0, 0.0
        for v, s in self.channel_terms(x, u, aux, t, ctx).values():
            violations = violations + v
            smooth = smooth + s
        return torch.stack([violations, smooth], dim=-1)

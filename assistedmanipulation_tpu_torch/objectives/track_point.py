"""TrackPoint objective: reach a fixed point with the end effector (port of
assistedmanipulation_tpu/objectives/track_point.py), over a batch of states.

Re-implementation of src/frankaridgeback/objective/track_point.cpp:
- 100 * d^2 to the target point (track_point.cpp:36-43);
- hard-coded quadratic joint-limit penalties (1000 + 1e5 * excess^2 over the
  first 10 joints, track_point.cpp:45-79);
- the same self-collision sphere table, with the intended gap = distance -
  radii where the reference computes radii - distance (track_point.cpp:137:
  every non-colliding pair would saturate its barrier; see the JAX module);
- reach barrier from the arm-mount plane with a (0.3, 0, 0.15) offset
  (track_point.cpp:150-174).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.frankaridgeback import POSITION, RobotAux
from ..ops import constant
from ..ops.costs import LeftInverseBarrier, RightInverseBarrier
from .assisted_manipulation import COLLISION_PAIRS, PAIR_DIFFERENCE

LOWER_LIMIT = np.array(
    [-2.0, -2.0, -6.28, -2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973]
)
UPPER_LIMIT = np.array(
    [2.0, 2.0, 6.28, 2.8973, 1.7628, 2.8973, 0.0698, 2.8973, 3.7525, 2.8973]
)


@dataclasses.dataclass
class Configuration:
    point: tuple = (1.0, 1.0, 1.0)
    enable_joint_limits: bool = True
    enable_self_collision_avoidance: bool = True
    enable_reach_limits: bool = True
    self_collision_limit: tuple = (0.0, 1.0)  # LeftInverseBarrier (bound, scale)
    self_collision_radii: tuple = (0.75, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
    maximum_reach_limit: tuple = (1.0, 1.0)  # RightInverseBarrier


class TrackPoint:
    def __init__(self, configuration: Configuration = None):
        self.configuration = configuration or Configuration()
        c = self.configuration
        self._collision = LeftInverseBarrier(*c.self_collision_limit)
        self._reach = RightInverseBarrier(*c.maximum_reach_limit)
        radii = np.asarray(c.self_collision_radii)
        self._pair_radii = radii[COLLISION_PAIRS[:, 0]] + radii[COLLISION_PAIRS[:, 1]]
        self._point = np.asarray(c.point, dtype=np.float64)

    def point_cost(self, aux: RobotAux):
        distance = torch.linalg.vector_norm(aux.ee_position - constant(self._point, aux.ee_position), dim=-1)
        return 100.0 * distance**2

    def joint_limit_cost(self, q):
        lower, upper = constant(LOWER_LIMIT, q), constant(UPPER_LIMIT, q)
        q10 = q[..., :10]
        below = torch.where(q10 < lower, 1000.0 + 100000.0 * (lower - q10) ** 2, 0.0)
        above = torch.where(q10 > upper, 1000.0 + 100000.0 * (q10 - upper) ** 2, 0.0)
        return torch.sum(below + above, dim=-1)

    def self_collision_channels(self, aux: RobotAux):
        positions = aux.collision_link_positions
        distance = torch.linalg.vector_norm(constant(PAIR_DIFFERENCE, positions) @ positions, dim=-1)
        gap = distance - constant(self._pair_radii, distance)
        v, s = self._collision.decomposed(gap)
        return torch.sum(v, dim=-1), torch.sum(s, dim=-1)

    def self_collision_cost(self, aux: RobotAux):
        v, s = self.self_collision_channels(aux)
        return v * 1e10 + s

    def reach_channels(self, x, aux: RobotAux):
        yaw = x[..., POSITION][..., 2]
        c, s = torch.cos(yaw), torch.sin(yaw)
        offset = torch.stack([0.3 * c, 0.3 * s, torch.full_like(c, 0.15)], dim=-1)
        robot = aux.arm_mount_position + offset
        return self._reach.decomposed(torch.linalg.vector_norm(aux.ee_position - robot, dim=-1))

    def reach_cost(self, x, aux: RobotAux):
        v, s = self.reach_channels(x, aux)
        return v * 1e10 + s

    def channel_terms(self, x, u, aux, t, ctx=None):
        c = self.configuration
        zero = torch.zeros_like(x[..., 0])

        def smooth_only(value):
            return (torch.zeros_like(value), value)

        return {
            "point": smooth_only(self.point_cost(aux)),
            "joint_limit": (
                smooth_only(self.joint_limit_cost(x[..., POSITION])) if c.enable_joint_limits else (zero, zero)
            ),
            "self_collision": (
                self.self_collision_channels(aux) if c.enable_self_collision_avoidance else (zero, zero)
            ),
            "reach": (self.reach_channels(x, aux) if c.enable_reach_limits else (zero, zero)),
        }

    def terms(self, x, u, aux, t, ctx=None):
        return {name: v * 1e10 + s for name, (v, s) in self.channel_terms(x, u, aux, t, ctx).items()}

    def __call__(self, x, u, aux, t, ctx=None):
        violations, smooth = 0.0, 0.0
        for v, s in self.channel_terms(x, u, aux, t, ctx).values():
            violations = violations + v
            smooth = smooth + s
        return torch.stack([violations, smooth], dim=-1)

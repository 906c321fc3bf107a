"""Reference position / orientation trajectory generators (port of
assistedmanipulation_tpu/sim/trajectories.py).

Pure functions of a time tensor, re-implementing
src/controller/trajectory.cpp:

- Position: Point (93-107), Circular (108-155), Rectangular (157-218),
  Lissajous (220-246), FigureEight = Lissajous with y_freq = 2 x_freq and
  y_phase = pi (248-267).
- Orientation: AxisAngle (269-291), Slerp with t = (sin(t)+1)/2 (293-325).

``position(t)`` / ``orientation(t)`` take a tensor ``t`` of any shape and
return (..., 3) / (..., 4) in its dtype, on its device; the generators'
constants are host arrays copied to the device once (``ops.constant``), so
a query runs inside a captured CUDA graph.

Defaults mirror the inline DEFAULT_CONFIGURATION blocks
(trajectory.hpp:102-104, 168-173, 248-255, 353-363, 428-433, 477-480,
552-557).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import constant
from ..ops.rotations import (
    quat_from_axis_angle,
    quat_from_two_vectors,
    quat_multiply,
    quat_rotate,
    quat_slerp,
    quat_to_matrix,
)


def _host(fn, *arrays) -> np.ndarray:
    """A rotation helper evaluated once on the host, in float64."""
    return fn(*(torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in arrays)).numpy()


def _axis_angle_quat(axis, angle) -> np.ndarray:
    """Rz(angle) * FromTwoVectors(z, axis) (trajectory.cpp:277-291)."""
    qz = _host(quat_from_axis_angle, [0.0, 0.0, 1.0], angle)
    qa = _host(quat_from_two_vectors, [0.0, 0.0, 1.0], axis)
    return _host(quat_multiply, qz, qa)


# --- position ----------------------------------------------------------------


@dataclasses.dataclass
class PointConfiguration:
    point: tuple = (1.0, 1.0, 1.0)


class PointTrajectory:
    def __init__(self, configuration: PointConfiguration):
        self._point = np.asarray(configuration.point, dtype=np.float64)

    def position(self, t):
        return constant(self._point, t).expand(*t.shape, 3)


@dataclasses.dataclass
class CircularConfiguration:
    origin: tuple = (1.0, 1.0, 1.0)
    axis: tuple = (0.0, 0.0, 1.0)
    radius: float = 0.25
    angular_velocity: float = 1.0


class CircularTrajectory:
    """Rotate an initial radius vector about the axis (trajectory.cpp:118-155).

    The initial point projects (axis + offset) onto the rotation plane and
    rescales to the radius (trajectory.cpp:129-146)."""

    def __init__(self, configuration: CircularConfiguration):
        axis = np.asarray(configuration.axis, dtype=np.float64)
        offset = np.array([1.0, 0.0, 0.0])
        if np.allclose(np.abs(axis / np.linalg.norm(axis)), np.abs(offset), atol=1e-9):
            offset = np.array([0.0, 1.0, 0.0])
        to_project = axis + offset
        projected = to_project - axis.dot(to_project) / axis.dot(axis) * axis
        self._point = projected / np.linalg.norm(projected) * configuration.radius
        self._origin = np.asarray(configuration.origin, dtype=np.float64)
        self._axis = axis
        self._angular_velocity = configuration.angular_velocity

    def position(self, t):
        q = quat_from_axis_angle(constant(self._axis, t), t * self._angular_velocity)
        return constant(self._origin, t) + quat_rotate(q, constant(self._point, t))


@dataclasses.dataclass
class RectangularConfiguration:
    origin: tuple = (1.0, 1.0, 1.0)
    axis: tuple = (0.0, 0.0, 1.0)
    width: float = 1.0
    height: float = 0.0
    velocity: float = 0.5


class RectangularTrajectory:
    """Perimeter walk under an affine plane transform (trajectory.cpp:170-218)."""

    def __init__(self, configuration: RectangularConfiguration):
        if configuration.velocity < 0:
            raise ValueError("cannot have non-positive velocity")
        c = configuration
        q = _host(quat_from_two_vectors, [0.0, 0.0, 1.0], c.axis)
        self._rotation = _host(quat_to_matrix, q)
        self._translation = np.asarray(c.origin, dtype=np.float64) - np.array([c.width / 2, c.height / 2, 0.0])
        self._width = c.width
        self._height = c.height
        self._velocity = c.velocity
        self._circumference = 2 * c.width + 2 * c.height

    def position(self, t):
        w, h = self._width, self._height
        d = torch.remainder(t * self._velocity, self._circumference)
        zero = torch.zeros_like(d)
        # Four perimeter segments, selected branch-free.
        p0 = torch.stack([d, zero, zero], -1)
        d1 = d - w
        p1 = torch.stack([torch.full_like(d, w), d1, zero], -1)
        d2 = d1 - h
        p2 = torch.stack([w - d2, torch.full_like(d, h), zero], -1)
        d3 = d2 - w
        p3 = torch.stack([zero, h - d3, zero], -1)
        local = torch.where(
            (d < w)[..., None],
            p0,
            torch.where((d1 < h)[..., None], p1, torch.where((d2 < w)[..., None], p2, p3)),
        )
        return (constant(self._rotation, d) @ local[..., None])[..., 0] + constant(self._translation, d)


@dataclasses.dataclass
class LissajousConfiguration:
    origin: tuple = (1.0, 1.0, 1.0)
    x_amplitude: float = 0.4
    y_amplitude: float = 0.2
    z_amplitude: float = 0.0
    x_frequency: float = 0.5
    y_frequency: float = 1.5
    z_frequency: float = 0.0
    y_phase: float = float(np.pi / 2)
    z_phase: float = 0.0


class LissajousTrajectory:
    def __init__(self, configuration: LissajousConfiguration):
        self.c = configuration

    def position(self, t):
        c = self.c
        return constant(np.asarray(c.origin, dtype=np.float64), t) + torch.stack(
            [
                c.x_amplitude * torch.sin(c.x_frequency * t),
                c.y_amplitude * torch.sin(c.y_frequency * t + c.y_phase),
                c.z_amplitude * torch.sin(c.z_frequency * t + c.z_phase),
            ],
            dim=-1,
        )


@dataclasses.dataclass
class FigureEightConfiguration:
    origin: tuple = (1.0, 1.0, 1.0)
    x_amplitude: float = 0.5
    y_amplitude: float = 0.25
    frequency: float = 1.0


class FigureEightTrajectory(LissajousTrajectory):
    """Lissajous with y_freq = 2 x_freq and y_phase = pi
    (trajectory.cpp:248-267)."""

    def __init__(self, configuration: FigureEightConfiguration):
        c = configuration
        super().__init__(
            LissajousConfiguration(
                origin=c.origin,
                x_amplitude=c.x_amplitude,
                y_amplitude=c.y_amplitude,
                z_amplitude=0.0,
                x_frequency=c.frequency,
                y_frequency=2 * c.frequency,
                z_frequency=0.0,
                y_phase=float(np.pi),
                z_phase=0.0,
            )
        )


# --- orientation -------------------------------------------------------------


@dataclasses.dataclass
class AxisAngleConfiguration:
    axis: tuple = (0.0, 0.0, 1.0)
    angle: float = 0.0


class AxisAngleTrajectory:
    """Static orientation: Rz(angle) * FromTwoVectors(z, axis)
    (trajectory.cpp:277-291)."""

    def __init__(self, configuration: AxisAngleConfiguration):
        self._orientation = _axis_angle_quat(configuration.axis, configuration.angle)

    def orientation(self, t):
        return constant(self._orientation, t).expand(*t.shape, 4)


@dataclasses.dataclass
class SlerpConfiguration:
    first_axis: tuple = (0.0, 0.0, 1.0)
    first_angle: float = 0.0
    second_axis: tuple = (1.0, 0.0, 0.0)
    second_angle: float = 0.0
    frequency: float = 0.5


class SlerpTrajectory:
    """Oscillating slerp with t = (sin(time) + 1) / 2 (trajectory.cpp:318-325)."""

    def __init__(self, configuration: SlerpConfiguration):
        c = configuration
        self._first = _axis_angle_quat(c.first_axis, c.first_angle)
        self._second = _axis_angle_quat(c.second_axis, c.second_angle)

    def orientation(self, time):
        t = (torch.sin(time) + 1.0) / 2.0
        return quat_slerp(constant(self._first, time), constant(self._second, time), t)


# --- factories (trajectory.cpp:23-91) ----------------------------------------


@dataclasses.dataclass
class PositionConfiguration:
    type: str = "circle"
    point: Optional[PointConfiguration] = None
    circle: Optional[CircularConfiguration] = None
    rectangle: Optional[RectangularConfiguration] = None
    lissajous: Optional[LissajousConfiguration] = None
    figure_eight: Optional[FigureEightConfiguration] = None


def create_position(configuration: PositionConfiguration):
    c = configuration
    if c.type == "point":
        return PointTrajectory(c.point or PointConfiguration())
    if c.type == "circle":
        return CircularTrajectory(c.circle or CircularConfiguration())
    if c.type == "rectangle":
        return RectangularTrajectory(c.rectangle or RectangularConfiguration())
    if c.type == "lissajous":
        return LissajousTrajectory(c.lissajous or LissajousConfiguration())
    if c.type == "figure_eight":
        return FigureEightTrajectory(c.figure_eight or FigureEightConfiguration())
    raise ValueError(f"unknown position trajectory type {c.type}")


@dataclasses.dataclass
class OrientationConfiguration:
    type: str = "axis_angle"
    axis_angle: Optional[AxisAngleConfiguration] = None
    slerp: Optional[SlerpConfiguration] = None


def create_orientation(configuration: OrientationConfiguration):
    c = configuration
    if c.type == "axis_angle":
        return AxisAngleTrajectory(c.axis_angle or AxisAngleConfiguration())
    if c.type == "slerp":
        return SlerpTrajectory(c.slerp or SlerpConfiguration())
    raise ValueError(f"unknown orientation trajectory type {c.type}")

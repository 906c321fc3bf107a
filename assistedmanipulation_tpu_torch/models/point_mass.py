"""Point-mass plants (BASELINE configs 1-2; port of
assistedmanipulation_tpu/models/point_mass.py), over a batch of states.

- ``make_point_mass_plant``: the double integrator, state (position,
  velocity) in N dimensions, control = acceleration, semi-implicit Euler
  (the mppi::Dynamics contract, reference src/controller/mppi.hpp:30-85).
  The cheapest plant: the reference-pipeline replay (parity.py,
  scripts/torch_parity_replay.py) runs on it.
- ``make_base_2d_plant``: a velocity-controlled planar (x, y, yaw) base
  with log barriers around disc obstacles; velocity commands track through
  a first-order lag, as the robot base's kd-dominated PD actuation
  (reference raisim_dynamics.cpp:206-224).

``x`` is (..., state_dof) and ``u`` (..., control_dof), as every plant of
the port (``mppi.Plant``). The JAX package makes its constants float32
arrays, so a float64 state sees them rounded to float32 (a 0.3 m radius is
0.30000001192...); the port rounds them the same way, then copies them to
the state's device once (``ops.constant``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mppi import Plant
from ..ops import constant


@dataclasses.dataclass
class PointMassConfig:
    dimensions: int = 2
    target: tuple = None  # defaults to ones(dimensions)
    position_cost: float = 100.0
    velocity_cost: float = 1.0
    control_cost: float = 0.01


def make_point_mass_plant(config: PointMassConfig) -> Plant:
    dims = config.dimensions
    target = np.asarray(config.target if config.target is not None else [1.0] * dims, dtype=np.float32)

    def derive(x, t, ctx=None):
        return None

    def cost(x, u, aux, t, ctx=None):
        position, velocity = x[..., :dims], x[..., dims:]
        return (
            config.position_cost * ((position - constant(target, x)) ** 2).sum(-1)
            + config.velocity_cost * (velocity**2).sum(-1)
            + config.control_cost * (u**2).sum(-1)
        )

    def integrate(x, u, aux, t, dt, ctx=None):
        position, velocity = x[..., :dims], x[..., dims:]
        velocity = velocity + u * dt
        position = position + velocity * dt
        return torch.cat([position, velocity], dim=-1)

    return Plant(derive=derive, cost=cost, integrate=integrate, state_dof=2 * dims, control_dof=dims)


@dataclasses.dataclass
class ObstacleField2DConfig:
    """Ridgeback-style planar plant with obstacle log barriers
    (BASELINE config 2): velocity-controlled (x, y, yaw) base."""

    target: tuple = (2.0, 2.0, 0.0)
    obstacles: tuple = ((1.0, 1.0, 0.3),)  # (x, y, radius)
    position_cost: float = 100.0
    obstacle_scale: float = 10.0
    control_cost: float = 0.1
    velocity_time_constant: float = 0.15


def make_base_2d_plant(config: ObstacleField2DConfig) -> Plant:
    """State (x, y, yaw, vx, vy, vyaw); control = commanded velocities."""
    target = np.asarray(config.target, dtype=np.float32)
    obstacles = np.asarray(config.obstacles, dtype=np.float32)

    def derive(x, t, ctx=None):
        return None

    def cost(x, u, aux, t, ctx=None):
        position = x[..., :3]
        c = config.position_cost * ((position - constant(target, x)) ** 2).sum(-1)
        c = c + config.control_cost * (u**2).sum(-1)
        # Log barrier around each obstacle disc; the inner where keeps the
        # log's argument positive where the outer one discards it.
        discs = constant(obstacles, x)
        offset = position[..., None, :2] - discs[:, :2]
        gap = torch.sqrt((offset * offset).sum(-1)) - discs[:, 2]
        inside = torch.full_like(gap, 1e10)
        barrier = torch.where(
            gap <= 0.0,
            inside,
            torch.minimum(config.obstacle_scale * -torch.log10(torch.where(gap > 0, gap, torch.ones_like(gap))), inside),
        )
        return c + torch.clamp(barrier, min=0.0).sum(-1)

    def integrate(x, u, aux, t, dt, ctx=None):
        position, velocity = x[..., :3], x[..., 3:]
        alpha = dt / (config.velocity_time_constant + dt)
        velocity = velocity + alpha * (u - velocity)
        position = position + velocity * dt
        return torch.cat([position, velocity], dim=-1)

    return Plant(derive=derive, cost=cost, integrate=integrate, state_dof=6, control_dof=3)

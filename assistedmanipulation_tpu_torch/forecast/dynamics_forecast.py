"""DynamicsForecast: open-loop rollout of the robot under the forecast wrench
(port of assistedmanipulation_tpu/forecast/dynamics_forecast.py).

Re-implements FrankaRidgeback::DynamicsForecast (frankaridgeback/dynamics.hpp
:122-408, dynamics.cpp:58-140): before each controller update, a dedicated
dynamics instance rolls the current state forward over the horizon with ZERO
control and the forecast wrench injected each step, caching per-step joint
positions, end-effector states, powers, tank energy and the wrench itself.
The objective's trajectory term reads the cached wrench through a
ForecastContext passed to the planner as ctx.

The JAX version's ``lax.scan`` is a loop of ``steps`` plant steps here; the
time is a tensor throughout, so the rollout runs inside a captured CUDA
graph (sim/episode.py) with the time its host loads per replay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..models import dynamics as dyn
from ..models import frankaridgeback as fr
from ..models.model_data import RobotModel, frankaridgeback_model
from ..objectives.assisted_manipulation import ForecastContext
from ..ops import constant, matvec


@dataclasses.dataclass
class Configuration:
    """Mirror of DynamicsForecast::Configuration (dynamics.hpp:176-196)."""

    time_step: float = 0.01
    horizon: float = 0.3

    @property
    def steps(self) -> int:
        return int(math.ceil(self.horizon / self.time_step))


class ForecastRollout(NamedTuple):
    """Cached horizon (the reference's m_* vectors, dynamics.cpp:96-101)."""

    joint_positions: torch.Tensor  # (steps, 12)
    ee_positions: torch.Tensor  # (steps, 3)
    ee_orientations: torch.Tensor  # (steps, 4)
    ee_linear_velocities: torch.Tensor  # (steps, 3)
    ee_angular_velocities: torch.Tensor  # (steps, 3)
    ee_linear_accelerations: torch.Tensor  # (steps, 3)
    ee_angular_accelerations: torch.Tensor  # (steps, 3)
    joint_power: torch.Tensor  # (steps,)
    external_power: torch.Tensor  # (steps,)
    energy: torch.Tensor  # (steps,)
    wrench: torch.Tensor  # (steps, 6)


class DynamicsForecast:
    """Rolls the plant under zero control + forecast wrench."""

    def __init__(
        self,
        configuration: Configuration = None,
        robot_configuration: fr.Configuration = None,
        model: RobotModel = None,
        gravity=(0.0, 0.0, 9.81),
    ):
        self.configuration = configuration or Configuration()
        self.model = model or frankaridgeback_model()
        self.robot_configuration = robot_configuration or fr.Configuration()
        _, self._kp, self._kd = self.robot_configuration.resolve()
        self._gravity = gravity

    def forecast(self, x: torch.Tensor, time, wrench_at) -> tuple[ForecastRollout, ForecastContext]:
        """Roll out from state ``x`` (31,) at ``time`` (a 0-d tensor on
        ``x``'s device, or a number); ``wrench_at(t) -> (6,)`` queries the
        wrench strategy's cached horizon at a 0-d tensor ``t``
        (dynamics.cpp:104-138).

        joint_power is h(q, v) . v: the generalized force the reference's
        act() installed (gravity/Coriolis compensation; control is zero here)
        dotted with the velocity (raisim_dynamics.cpp:176-179). The external
        power is control^T J^T w = 0 under zero control
        (raisim_dynamics.cpp:226-234), so the tank stays constant."""
        cfg = self.configuration
        model = self.model
        kp, kd = constant(self._kp, x), constant(self._kd, x)
        dt = cfg.time_step
        time = torch.as_tensor(time, dtype=x.dtype, device=x.device)
        u = constant(np.zeros(fr.DoF.CONTROL), x)
        times = time + constant(np.arange(cfg.steps, dtype=np.float64), x) * dt

        outputs = []
        for step in range(cfg.steps):
            aux = fr.derive_aux(model, x)
            wrench = wrench_at(times[step]).to(x.dtype)
            q, v = x[fr.POSITION], x[fr.VELOCITY]
            h = dyn.nonlinear_effects(model, aux.fk, v, self._gravity)
            joint_power = torch.sum(h * v)
            external_power = torch.sum(u * matvec(aux.ee_jacobian.mT, wrench))
            x_next, qdd, _ = fr.integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, dt)
            lin_acc, ang_acc = fr.ee_classical_acceleration(model, q, v, qdd)
            outputs.append((
                q, aux.ee_position, aux.ee_orientation, aux.ee_linear_velocity, aux.ee_angular_velocity,
                lin_acc, ang_acc, joint_power, external_power, x[fr.ENERGY], wrench,
            ))
            x = x_next
        rollout = ForecastRollout(*(torch.stack(field) for field in zip(*outputs)))

        # The objective interpolates into steps+1 nodes; extend with the last
        # wrench (queries are clipped to the horizon anyway).
        ctx = ForecastContext(
            wrench_horizon=torch.cat([rollout.wrench, rollout.wrench[-1:]], dim=0),
            start_time=time,
            time_step=cfg.time_step,
            horizon=cfg.horizon,
        )
        return rollout, ctx

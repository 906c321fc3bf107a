"""Vector PID controller, the human model in the experiment harness (port of
assistedmanipulation_tpu/sim/pid.py).

Functional re-implementation of controller::PID (src/controller/pid.cpp:
34-90): proportional + finite-difference derivative + integral with
saturation and anti-windup (error integrates only where the control is not
saturated, pid.cpp:77-86). Presets HUMAN_POINT_CONTROL (kp 300, kd 10, ki 5,
bounds +/-100 N, pid.hpp:55-63) and HUMAN_ORIENTATION_CONTROL
(pid.hpp:240-247).

Every branch of the update is a ``torch.where`` and the time may be a
tensor, so an update runs inside a captured CUDA graph (sim/episode.py).

The reference's QuaternionPID::update body is empty (pid.cpp:122-125) and
the orientation wrench path is commented out of the harness
(external_wrench.cpp:214-221); a working quaternion error PID is provided
here for completeness but defaults stay unused, matching the experiments.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import constant
from ..ops.rotations import quat_conjugate, quat_multiply


@dataclasses.dataclass
class Configuration:
    n: int = 3
    kp: Optional[np.ndarray] = None
    kd: Optional[np.ndarray] = None
    ki: Optional[np.ndarray] = None
    minimum: Optional[np.ndarray] = None
    maximum: Optional[np.ndarray] = None
    reference: Optional[np.ndarray] = None
    initial_time: float = 0.0


HUMAN_POINT_CONTROL = Configuration(
    n=3,
    kp=np.full(3, 300.0),
    kd=np.full(3, 10.0),
    ki=np.full(3, 5.0),
    minimum=np.full(3, -100.0),
    maximum=np.full(3, 100.0),
    reference=np.zeros(3),
)

HUMAN_ORIENTATION_CONTROL = Configuration(
    n=3,
    kp=np.full(3, 500.0),
    kd=np.full(3, 50.0),
    ki=np.zeros(3),
    minimum=np.full(3, -10000.0),
    maximum=np.full(3, 10000.0),
    reference=np.zeros(3),
)


class PIDState(NamedTuple):
    reference: torch.Tensor  # (n,)
    last_error: torch.Tensor  # (n,)
    cumulative_error: torch.Tensor  # (n,)
    saturation: torch.Tensor  # (n,) 1.0 where saturated last update
    control: torch.Tensor  # (n,)
    last_time: torch.Tensor  # 0-d
    derivative_valid: torch.Tensor  # 0-d bool


def _tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


class PID:
    def __init__(self, configuration: Configuration):
        c = configuration
        n = c.n
        for name in ("kp", "kd", "ki", "minimum", "maximum", "reference"):
            value = getattr(c, name)
            if value is not None and len(np.asarray(value)) != n:
                raise ValueError(f"pid {name} must have dimension {n}")
        self.configuration = c
        self._kp = np.asarray(c.kp if c.kp is not None else np.zeros(n), np.float64)
        self._kd = np.asarray(c.kd if c.kd is not None else np.zeros(n), np.float64)
        self._ki = np.asarray(c.ki if c.ki is not None else np.zeros(n), np.float64)
        self._minimum = np.asarray(c.minimum if c.minimum is not None else np.full(n, -np.inf), np.float64)
        self._maximum = np.asarray(c.maximum if c.maximum is not None else np.full(n, np.inf), np.float64)
        self._reference = np.asarray(c.reference if c.reference is not None else np.zeros(n), np.float64)

    def init(self, dtype=torch.float64, device="cuda") -> PIDState:
        device = resolve_device(device)
        n = self.configuration.n
        return PIDState(
            reference=torch.as_tensor(self._reference, dtype=dtype).to(device),
            last_error=torch.zeros(n, dtype=dtype, device=device),
            cumulative_error=torch.zeros(n, dtype=dtype, device=device),
            saturation=torch.zeros(n, dtype=dtype, device=device),
            control=torch.zeros(n, dtype=dtype, device=device),
            last_time=torch.full((), self.configuration.initial_time, dtype=dtype, device=device),
            derivative_valid=torch.zeros((), dtype=torch.bool, device=device),
        )

    def set_reference(self, state: PIDState, reference) -> PIDState:
        return state._replace(reference=_tensor(reference, state.reference))

    def update(self, state: PIDState, observation, time) -> PIDState:
        """One PID tick (pid.cpp:50-90). Monotonic-time and first-update
        bootstrap semantics preserved."""
        like = state.control
        time = _tensor(time, like)
        observation = _tensor(observation, like)
        kp, kd, ki = constant(self._kp, like), constant(self._kd, like), constant(self._ki, like)
        minimum, maximum = constant(self._minimum, like), constant(self._maximum, like)

        stale = time <= state.last_time
        dt = torch.where(stale, 1.0, time - state.last_time)
        error = state.reference - observation

        raw = kp * error + kd * (error - state.last_error) / dt + ki * state.cumulative_error
        control = torch.clamp(raw, minimum, maximum)
        saturation = ((control >= maximum) | (control <= minimum)).to(like.dtype)
        cumulative = state.cumulative_error + error * (1.0 - saturation) * dt

        hold = stale | ~state.derivative_valid
        return PIDState(
            reference=state.reference,
            last_error=torch.where(stale, state.last_error, error),
            cumulative_error=torch.where(hold, state.cumulative_error, cumulative),
            saturation=torch.where(hold, state.saturation, saturation),
            control=torch.where(hold, state.control, control),
            last_time=torch.where(stale, state.last_time, time),
            derivative_valid=state.derivative_valid | ~stale,
        )


class QuaternionPID(PID):
    """Orientation PID on the rotation-vector error between quaternions —
    the working version of the reference's empty QuaternionPID::update
    (pid.cpp:122-125)."""

    def update_quaternion(self, state: PIDState, observation_quat, reference_quat, time):
        error_quat = quat_multiply(reference_quat, quat_conjugate(observation_quat))
        # Rotation vector (small-angle 2*vec part with sign fix).
        sign = torch.where(error_quat[..., 0] < 0, -1.0, 1.0)
        rotvec = 2.0 * sign[..., None] * error_quat[..., 1:]
        state = state._replace(reference=torch.zeros_like(state.reference))
        return self.update(state, -rotvec, time)

"""Franka-Ridgeback constants and configuration (port of the constant and
configuration half of assistedmanipulation_tpu/models/frankaridgeback.py).

DoF layout (dof.hpp:36-70 of the C++ reference): q(12) + v(12) + external
wrench(6) + tank energy(1) = STATE 31; CONTROL 12 = base velocity
(vx, vy, wyaw) + arm torque(7) + gripper position(2). The rollout dynamics
themselves live in kernels/lane_rollout.py; the full plant (derive_aux,
make_plant) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class DoF:
    BASE = 3
    ARM = 7
    GRIPPER = 2
    JOINTS = 12
    EXTERNAL_WRENCH = 6
    STATE = 31
    CONTROL = 12


POSITION = slice(0, 12)
VELOCITY = slice(12, 24)
WRENCH = slice(24, 30)
ENERGY = 30

# Links used by the self-collision table (assisted_manipulation.cpp:92-125);
# radii index = link enum - 3 (pivot first).
COLLISION_LINKS = [
    "pivot",
    "panda_link1",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link5",
    "panda_link6",
    "panda_link7",
]

# End-effector body: moving link index of the panda_link7 composite, which
# holds the hand and grasp frames.
EE_BODY = 9

DEFAULT_PROPORTIONAL_GAIN = np.array(
    [0.0, 0.0, 0.0, 0, 0, 0, 0, 0, 0, 0, 100.0, 100.0]
)
DEFAULT_DIFFERENTIAL_GAIN = np.array(
    [1000.0, 1000.0, 1000.0, 10, 10, 10, 10, 10, 10, 10, 50.0, 50.0]
)

_PI = np.pi
PRESETS = {
    "zero": np.zeros(12),
    "huddled": np.array(
        [0.2, 0.2, _PI / 4, 0.0, _PI / 5, 0.0, -_PI / 2, 0.0, 2, _PI / 4, 0.025, 0.025]
    ),
    "behind": np.array(
        [0.2, 0.2, _PI / 4, _PI, 1.2, 0.0, -2, 0, _PI / 2, _PI / 4, 0.025, 0.025]
    ),
    "below": np.array(
        [0.2, 0.2, _PI / 4, 0.0, 1.2, 0.0, -2, 0, _PI, _PI / 4, 0.025, 0.025]
    ),
    "reach": np.array(
        [0.2, 0.2, _PI / 4, 0.0, 1.5, 0.0, 0, 0, _PI, _PI / 4, 0.025, 0.025]
    ),
    "joint_limit": np.array(
        [0.2, 0.2, _PI / 4, 0.0, _PI / 5, 0.0, -_PI / 2, 0.0, -0.2, _PI / 4, 0.025, 0.025]
    ),
    "self_collision": np.array(
        [0.2, 0.2, _PI / 4, 0.0, _PI / 3, 0.0, -6 * _PI / 8, 0.0, 2, _PI / 4, 0.025, 0.025]
    ),
}


def make_state(preset: str = "huddled", energy: float = 100.0) -> np.ndarray:
    """31-dim state vector from a named preset. The 'zero' preset zeroes the
    tank too, matching state.cpp:12-14 (which returns before setting 100)."""
    state = np.zeros(DoF.STATE)
    state[POSITION] = PRESETS[preset]
    state[ENERGY] = 0.0 if preset == "zero" else energy
    return state


@dataclasses.dataclass
class Configuration:
    """Mirror of RaisimDynamics::Configuration defaults
    (raisim_dynamics.hpp:56-75)."""

    initial_state: Optional[np.ndarray] = None
    proportional_gain: Optional[np.ndarray] = None
    differential_gain: Optional[np.ndarray] = None
    energy: Optional[float] = 1000.0
    end_effector_frame: str = "panda_grasp_joint"

    def resolve(self):
        initial = (
            np.asarray(self.initial_state)
            if self.initial_state is not None
            else make_state("huddled")
        )
        if self.energy is not None:
            initial = initial.copy()
            initial[ENERGY] = self.energy
        kp = (
            np.asarray(self.proportional_gain)
            if self.proportional_gain is not None
            else DEFAULT_PROPORTIONAL_GAIN
        )
        kd = (
            np.asarray(self.differential_gain)
            if self.differential_gain is not None
            else DEFAULT_DIFFERENTIAL_GAIN
        )
        return initial, kp, kd


# Default MPPI configuration covariance/bounds for this robot
# (base.hpp:79-94).
DEFAULT_COVARIANCE = np.array(
    [0.1, 0.1, 0.2, 7.5, 7.5, 7.5, 7.5, 7.5, 7.5, 7.5, 0.0, 0.0]
)
DEFAULT_CONTROL_MIN = np.array(
    [-0.5, -0.5, -1.0, -100.0, -100.0, -100.0, -100.0, -100.0, -100.0, -100.0, -0.05, -0.05]
)
DEFAULT_CONTROL_MAX = np.array(
    [0.5, 0.5, 1.0, 100.0, 100.0, 100.0, 100.0, 100.0, 100.0, 100.0, 0.05, 0.05]
)

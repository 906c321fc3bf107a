"""Franka-Ridgeback mobile manipulator plant (port of
assistedmanipulation_tpu/models/frankaridgeback.py).

DoF layout (dof.hpp:36-70 of the C++ reference): q(12) + v(12) + external
wrench(6) + tank energy(1) = STATE 31; CONTROL 12 = base velocity
(vx, vy, wyaw) + arm torque(7) + gripper position(2).

The plant (``derive_aux``, ``integrate_with_wrench``, ``make_plant``,
``make_plant_step``) works on a batch of states (..., 31): the planner's
batch rollout (one state per rollout) and its filtered re-rollout (one
state) run the same code. The fused CUDA kernels evaluate the same step in
kernels/csrc/franka_step.cuh, with kernels/lane_rollout.py as their plain
version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mppi import Plant
from ..ops import constant, matvec
from ..ops.energy import energy_tank_step
from ..ops.precision import f32_matmuls
from ..ops.rotations import matrix_to_quat
from . import dynamics as dyn
from . import factory
from . import kinematics as kin
from .model_data import RobotModel, frankaridgeback_model


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
# Point of the hand at which the external wrench acts, in panda_link7's
# frame (raisim_dynamics.cpp:131-148).
EE_FORCE_OFFSET = np.array([0.0, 0.0, 0.2])

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
    # Dynamics backend selection (SimulatorDynamics::Configuration::Type,
    # actor_dynamics.cpp:46-86): "analytic" (CRBA/RNEA) or "lagrangian"
    # (autodiff Euler-Lagrange), models/factory.py.
    dynamics_type: str = "analytic"
    # Backend for the MPPI rollout plant (make_plant) when it should differ
    # from the simulator's. None = same as dynamics_type.
    rollout_dynamics_type: Optional[str] = None

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


# --- derived quantities (aux) ----------------------------------------------


class RobotAux(NamedTuple):
    """Per-step derived quantities (RaisimDynamics::calculate,
    raisim_dynamics.cpp:150-204) shared by cost and integrate, each with
    the state's batch dimensions in front.

    The acceleration/power fields are zero on the MPPI path (derive_aux)
    and filled by the simulation step (make_plant_step), which knows the
    solved qdd and applied torque. The reference never computes its logged
    EE acceleration (setComputeInverseDynamics is commented out,
    raisim_dynamics.cpp:38) and hard-zeroes the angular one
    (raisim_dynamics.cpp:203); here both are real classical accelerations
    d/dt(J v) = J̇ v + J q̈."""

    fk: kin.FK
    mass: torch.Tensor  # (..., 12, 12)
    ee_position: torch.Tensor  # (..., 3)
    ee_orientation: torch.Tensor  # (..., 4) quaternion (w, x, y, z)
    ee_linear_velocity: torch.Tensor  # (..., 3)
    ee_angular_velocity: torch.Tensor  # (..., 3)
    ee_jacobian: torch.Tensor  # (..., 6, 12) with the Rz(yaw) base override
    collision_link_positions: torch.Tensor  # (..., 8, 3)
    arm_mount_position: torch.Tensor  # (..., 3)
    ee_linear_acceleration: torch.Tensor  # (..., 3)
    ee_angular_acceleration: torch.Tensor  # (..., 3)
    joint_power: torch.Tensor  # (...) tau . v


def _ee_jacobians(model: RobotModel, fk: kin.FK):
    """(R_ee, p_ee, J_lin, J_ang) of the end-effector frame."""
    R_ee, p_ee = kin.frame_transform(model, fk, model.end_effector_frame)
    J_lin = kin.point_jacobian(model, fk, p_ee, body=EE_BODY)
    J_ang = kin.angular_jacobian(model, fk, body=EE_BODY)
    return R_ee, p_ee, J_lin, J_ang


@f32_matmuls
def derive_aux(model: RobotModel, x: torch.Tensor, backend=None) -> RobotAux:
    q = x[..., POSITION]
    v = x[..., VELOCITY]
    fk = kin.forward_kinematics(model, q)
    mass = backend.mass_matrix(model, fk, q) if backend is not None else dyn.mass_matrix(model, fk)
    R_ee, p_ee, J_lin, J_ang = _ee_jacobians(model, fk)

    # Base block of the linear rows overridden with Rz(yaw)
    # (raisim_dynamics.cpp:169-174).
    yaw = q[..., 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rz = torch.stack(
        [torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1), torch.stack([zero, zero, one], -1)],
        dim=-2,
    )
    jacobian = torch.cat([torch.cat([rz, J_lin[..., 3:]], dim=-1), J_ang], dim=-2)  # (..., 6, 12)

    zeros3 = torch.zeros_like(p_ee)
    return RobotAux(
        fk=fk,
        mass=mass,
        ee_position=p_ee,
        ee_orientation=matrix_to_quat(R_ee),
        ee_linear_velocity=matvec(J_lin, v),
        ee_angular_velocity=matvec(J_ang, v),
        ee_jacobian=jacobian,
        collision_link_positions=kin.link_positions(model, fk, COLLISION_LINKS),
        arm_mount_position=kin.frame_transform(model, fk, "arm_mount_joint")[1],
        ee_linear_acceleration=zeros3,
        ee_angular_acceleration=zeros3,
        joint_power=torch.zeros_like(yaw),
    )


@f32_matmuls
def ee_classical_acceleration(model: RobotModel, q, v, qdd):
    """Classical end-effector accelerations (a, alpha) = d/dt (J(q) v) =
    J̇ v + J q̈, via one forward-mode derivative through the kinematics
    (``torch.func.jvp``; the JAX version's ``jax.jvp``)."""

    def ee_velocity(q, v):
        _, _, J_lin, J_ang = _ee_jacobians(model, kin.forward_kinematics(model, q))
        return matvec(J_lin, v), matvec(J_ang, v)

    _, (lin_acc, ang_acc) = torch.func.jvp(ee_velocity, (q, v), (v, qdd))
    return lin_acc, ang_acc


# --- actuation + integration ------------------------------------------------


def _pd_and_feedforward(x, u, kp, kd):
    """tau_pd + S_arm u (raisim_dynamics.cpp:206-224).

    Gripper position target = current gripper position; base velocity
    command in world frame; arm torque feedforward."""
    q = x[..., POSITION]
    v = x[..., VELOCITY]
    q_cmd = torch.cat([torch.zeros_like(q[..., :10]), q[..., 10:12]], dim=-1)
    v_cmd = torch.cat([u[..., 0:3], torch.zeros_like(u[..., 3:])], dim=-1)
    tau_pd = kp * (q_cmd - q) + kd * (v_cmd - v)
    tau_ff = torch.cat([torch.zeros_like(u[..., :3]), u[..., 3:10], torch.zeros_like(u[..., 10:])], dim=-1)
    return tau_pd + tau_ff


@f32_matmuls
def wrench_generalized_force(model, aux: RobotAux, wrench: torch.Tensor):
    """Generalized force of a world-frame wrench applied at the hand offset
    point (raisim_dynamics.cpp:131-148)."""
    R7 = aux.fk.rotation[..., EE_BODY, :, :]
    p7 = aux.fk.origin[..., EE_BODY, :]
    point = p7 + matvec(R7, constant(EE_FORCE_OFFSET, p7))
    J_point = kin.point_jacobian(model, aux.fk, point, body=EE_BODY)
    J_ang = kin.angular_jacobian(model, aux.fk, body=EE_BODY)
    return matvec(J_point.mT, wrench[..., :3]) + matvec(J_ang.mT, wrench[..., 3:])


@f32_matmuls
def integrate_with_wrench_extras(model, kp, kd, x, u, aux: RobotAux, wrench, dt):
    """Full plant step with an applied external wrench
    (RaisimDynamics::step = act + integrate + update,
    raisim_dynamics.cpp:255-264). Semi-implicit Euler with implicit PD
    damping (see models/dynamics.py). Returns (x_next, qdd, tau_actuation);
    the last two feed the simulation/logging path (EE accelerations + joint
    power)."""
    tau = _pd_and_feedforward(x, u, kp, kd)
    q_ext = wrench_generalized_force(model, aux, wrench)
    # URDF Coulomb joint friction (base x/y/pivot = 10), implicitly
    # regularized: tau_f = -c v_next = -c v - c dt qdd (models/dynamics.py).
    v = x[..., VELOCITY]
    c = dyn.friction_coefficients(model, v)
    qdd = dyn.forward_dynamics(aux.mass, tau + q_ext - c * v, kd + c, dt)

    v_next = v + dt * qdd
    q_next = x[..., POSITION] + dt * v_next

    # External power u^T (J_ee^T w) -> the tank integrates -power
    # (raisim_dynamics.cpp:226-252).
    external_power = torch.sum(u * matvec(aux.ee_jacobian.mT, wrench), dim=-1)
    energy = energy_tank_step(x[..., ENERGY], -external_power, dt)

    x_next = torch.cat([q_next, v_next, x[..., WRENCH], energy[..., None]], dim=-1).to(x.dtype)
    return x_next, qdd, tau


def integrate_with_wrench(model, kp, kd, x, u, aux: RobotAux, wrench, dt):
    """MPPI step: the state only."""
    return integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, dt)[0]


def make_plant(cost_fn, configuration: Configuration = None, model: RobotModel = None) -> Plant:
    """Build the MPPI Plant. Rollout dynamics apply NO external wrench — the
    reference's MPPI dynamics copies deliberately skip the forecast wrench
    (raisim_dynamics.cpp:236-238); the forecast enters through the objective
    via ctx instead."""
    model = model or frankaridgeback_model()
    configuration = configuration or Configuration()
    _, kp_np, kd_np = configuration.resolve()
    backend = factory.create(configuration.rollout_dynamics_type or configuration.dynamics_type)

    def derive(x, t, ctx=None):
        return derive_aux(model, x, backend=backend)

    def integrate(x, u, aux, t, dt, ctx=None):
        kp, kd = constant(kp_np, x), constant(kd_np, x)
        return integrate_with_wrench(model, kp, kd, x, u, aux, constant(np.zeros(6), x), dt)

    return Plant(derive=derive, cost=cost_fn, integrate=integrate, state_dof=DoF.STATE, control_dof=DoF.CONTROL)


def simulation_extras(model, aux: RobotAux, x, tau, qdd, gravity=(0.0, 0.0, 9.81), backend=None):
    """Fill the aux acceleration/power fields from a solved step.

    joint_power = (tau_pd + S_arm u + h(q, v)) . v — the reference's
    getGeneralizedForce (feedforward nonlinearities + arm torque + PD)
    dotted with the generalized velocity (raisim_dynamics.cpp:176-179).
    The h term cancels against the feedforward in the rollout; it is
    computed here for logging only. Gravity default matches the reference
    world's (0, 0, 9.81) (raisim_dynamics.hpp:58-61)."""
    q, v = x[..., POSITION], x[..., VELOCITY]
    h = (
        backend.nonlinear_effects(model, aux.fk, q, v, gravity)
        if backend is not None
        else dyn.nonlinear_effects(model, aux.fk, v, gravity)
    )
    lin_acc, ang_acc = ee_classical_acceleration(model, q, v, qdd)
    return aux._replace(
        ee_linear_acceleration=lin_acc,
        ee_angular_acceleration=ang_acc,
        joint_power=torch.sum((tau + h) * v, dim=-1),
    )


def make_plant_step(configuration: Configuration = None, model: RobotModel = None):
    """Plant-side step with wrench input, for the simulator loop and the
    dynamics forecast rollout: step(x, u, wrench, dt) -> (x_next, aux).
    The returned aux belongs to the pre-step state, with the accelerations
    and joint power of the step just taken (simulation_extras)."""
    model = model or frankaridgeback_model()
    configuration = configuration or Configuration()
    _, kp_np, kd_np = configuration.resolve()
    backend = factory.create(configuration.dynamics_type)

    def step(x, u, wrench, dt):
        aux = derive_aux(model, x, backend=backend)
        kp, kd = constant(kp_np, x), constant(kd_np, x)
        wrench = torch.as_tensor(wrench, dtype=x.dtype, device=x.device)
        x_next, qdd, tau = integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, dt)
        return x_next, simulation_extras(model, aux, x, tau, qdd, backend=backend)

    return step

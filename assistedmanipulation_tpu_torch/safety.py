"""Trajectory safety filter: per-step QP projection of the MPPI control
(port of assistedmanipulation_tpu/safety.py).

The reference declared this layer but never implemented it — every method of
``FrankaRidgeback::TrajectorySafetyFilter`` is an empty stub and the actor
passes a null filter (src/frankaridgeback/safety.hpp:11-61, safety.cpp:5-22,
actor.cpp:96-101). The JAX package makes it real: the intended constraints
of safety.hpp:15-40 (joint position / velocity / acceleration boxes + reach
sphere) become affine constraints on the control, solved by the batched
ADMM QP (ops/admm_qp.py).

Constraint construction. The plant's implicit-PD forward dynamics with
implicitly-regularized Coulomb friction (models/dynamics.forward_dynamics)
make the next-step acceleration affine in the control. With c = c(v) the
smoothed per-joint friction coefficients:

    (M + dt diag(kd + c)) qdd = Kd (v_cmd(u) - v) + S_arm u - c v
        =>    qdd = G u + d

with K = M + dt diag(kd + c), G = K^{-1} B, B = diag(kd)[:, :3] on the base
block + identity on the arm block, d = -K^{-1} (kd + c) v — the solve the
plant performs. Semi-implicit Euler then gives

    v+  = v + dt (G u + d)                 (velocity rows:      dt G)
    q+  = q + dt v+                        (position rows:      dt^2 G)
    p+ ~= p + dt J v+                      (reach row, linearized about the
                                            current arm-mount->EE direction)

so every enabled limit is a block of rows in one l <= A u <= u QP per step
(37 rows by 12 with the defaults), warm-started at the MPPI control. The
filter runs inside the planner's optimal re-rollout and writes back into the
published control sequence (mppi.cpp:460-466).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import from_json
from .models import dynamics as dyn
from .models import frankaridgeback as fr
from .models import kinematics as kin
from .models.model_data import RobotModel, frankaridgeback_model
from .ops import constant, linalg
from .ops.admm_qp import project_box_affine
from .ops.precision import check_f32_matmuls

# Franka Research 3 joint velocity / acceleration datasheet limits (rad/s,
# rad/s^2), base limits chosen to match the planner's control bounds
# (base.hpp:87-94); gripper from the Franka Hand datasheet.
DEFAULT_VELOCITY_LIMIT = np.array(
    [0.5, 0.5, 1.0, 2.62, 2.62, 2.62, 2.62, 5.25, 4.18, 5.26, 0.1, 0.1]
)
DEFAULT_ACCELERATION_LIMIT = np.array(
    [2.5, 2.5, 5.0, 15.0, 7.5, 10.0, 12.5, 15.0, 20.0, 20.0, 1.0, 1.0]
)
# Joint position limits: the objective's barrier bounds
# (assisted_manipulation.hpp:139-170 via objectives/assisted_manipulation.py).
DEFAULT_POSITION_MINIMUM = np.array(
    [-2.0, -2.0, -6.28, -2.8, -1.745, -2.8, -3.0718, -2.7925, 0.349, -2.967, 0.0, 0.0]
)
DEFAULT_POSITION_MAXIMUM = np.array(
    [2.0, 2.0, 6.28, 2.8, 1.745, 2.8, 0.0, 2.7925, 4.53785, 2.967, 0.5, 0.5]
)


@dataclasses.dataclass
class Configuration:
    """Mirror of TrajectorySafetyFilter::Configuration (safety.hpp:15-40)
    plus the ADMM solver knobs the reference's OSQP wrapper carried."""

    position_minimum: Optional[np.ndarray] = None
    position_maximum: Optional[np.ndarray] = None
    velocity_minimum: Optional[np.ndarray] = None
    velocity_maximum: Optional[np.ndarray] = None
    acceleration_minimum: Optional[np.ndarray] = None
    acceleration_maximum: Optional[np.ndarray] = None
    reach_maximum: float = 0.8
    reach_minimum: float = 0.15
    limit_joints: bool = True
    limit_velocity: bool = True
    limit_acceleration: bool = True
    limit_reach: bool = True
    # Solver (no reference equivalent — qp.cpp was a stub):
    iterations: int = 40
    rho: float = 1.0
    time_step: float = 0.01

    def resolve(self):
        def pick(value, default):
            return np.asarray(value if value is not None else default, float)

        return (
            pick(self.position_minimum, DEFAULT_POSITION_MINIMUM),
            pick(self.position_maximum, DEFAULT_POSITION_MAXIMUM),
            pick(self.velocity_minimum, -DEFAULT_VELOCITY_LIMIT),
            pick(self.velocity_maximum, DEFAULT_VELOCITY_LIMIT),
            pick(self.acceleration_minimum, -DEFAULT_ACCELERATION_LIMIT),
            pick(self.acceleration_maximum, DEFAULT_ACCELERATION_LIMIT),
        )


def configuration_from_json(tree: dict) -> Configuration:
    return from_json(Configuration, tree)


def make_safety_filter(
    configuration: Configuration = None,
    robot_configuration: fr.Configuration = None,
    model: RobotModel = None,
):
    """Build ``filter(x, u, t) -> u_safe`` (mppi::Filter::filter,
    mppi.hpp:150-176) over a batch: x (..., 31), u (..., 12)."""
    cfg = configuration or Configuration()
    robot_cfg = robot_configuration or fr.Configuration()
    model = model or frankaridgeback_model()
    _, kp_np, kd_np = robot_cfg.resolve()
    pos_min, pos_max, vel_min, vel_max, acc_min, acc_max = cfg.resolve()
    dt = float(cfg.time_step)

    # dtau/du: base velocity commands enter through Kd, arm torques directly,
    # gripper position commands not at all (the PD target is the current
    # position — raisim_dynamics.cpp:208-217).
    B_np = np.zeros((12, 12))
    B_np[:3, :3] = np.diag(kd_np[:3])
    B_np[3:10, 3:10] = np.eye(7)

    def filter_fn(x: torch.Tensor, u: torch.Tensor, t) -> torch.Tensor:
        check_f32_matmuls("the safety filter")
        q = x[..., fr.POSITION]
        v = x[..., fr.VELOCITY]
        fk = kin.forward_kinematics(model, q)
        mass = dyn.mass_matrix(model, fk)

        kd = constant(kd_np, u)
        # Same implicit-PD + implicitly-regularized Coulomb friction solve as
        # the plant (models/dynamics.forward_dynamics with
        # friction_coefficients): (M + dt diag(kd + c)) qdd = tau - c v, so
        # the affine model stays exact against integrate_with_wrench.
        c = dyn.friction_coefficients(model, v)
        L = linalg.cholesky_factor(mass + dt * torch.diag_embed(kd + c))
        # G = K^{-1} B and d = K^{-1} (-(kd + c) v) in one solve.
        Gd = linalg.solve_matrix(L, torch.cat([constant(B_np, u).expand(*v.shape, 12), (-(kd + c) * v)[..., None]], dim=-1))
        G, d = Gd[..., :12], Gd[..., 12]

        rows, lows, highs = [], [], []
        if cfg.limit_velocity:
            rows.append(dt * G)
            base = v + dt * d
            lows.append(constant(vel_min, u) - base)
            highs.append(constant(vel_max, u) - base)
        if cfg.limit_joints:
            rows.append(dt * dt * G)
            base = q + dt * v + dt * dt * d
            lows.append(constant(pos_min, u) - base)
            highs.append(constant(pos_max, u) - base)
        if cfg.limit_acceleration:
            rows.append(G)
            lows.append(constant(acc_min, u) - d)
            highs.append(constant(acc_max, u) - d)
        if cfg.limit_reach:
            _, p_ee = kin.frame_transform(model, fk, model.end_effector_frame)
            _, mount = kin.frame_transform(model, fk, "arm_mount_joint")
            J = kin.point_jacobian(model, fk, p_ee, body=fr.EE_BODY)
            to_ee = p_ee - mount
            distance = torch.linalg.vector_norm(to_ee, dim=-1)
            normal = to_ee / torch.clamp(distance, min=1e-9)[..., None]
            # n^T p+ = |p - mount| + dt n^T J (v + dt d) + dt^2 n^T J G u.
            nJ = (normal[..., None, :] @ J)[..., 0, :]  # (..., 12)
            row = (dt * dt) * (nJ[..., None, :] @ G)  # (..., 1, 12)
            base = distance + dt * torch.sum(nJ * (v + dt * d), dim=-1)
            rows.append(row)
            lows.append((cfg.reach_minimum - base)[..., None])
            highs.append((cfg.reach_maximum - base)[..., None])
        if not rows:
            return u

        A = torch.cat(rows, dim=-2)
        l = torch.cat(lows, dim=-1)
        h = torch.cat(highs, dim=-1)
        return project_box_affine(u, A, l, h, iterations=cfg.iterations, rho=cfg.rho).x.to(u.dtype)

    return filter_fn

"""Fixed-topology forward kinematics and Jacobians, batched over leading
dimensions (port of assistedmanipulation_tpu/models/kinematics.py).

Replaces the reference's RaiSim/Pinocchio kinematic queries
(raisim_dynamics.cpp:150-204: frame positions/orientations, dense frame
Jacobians, end-effector state) with straight-line code over the static
12-joint topology: the per-joint loop unrolls in Python, each step a few
batched tensor operations over every state at once.

Conventions:
- world transforms per moving link: rotation R (..., J, 3, 3), origin p
  (..., J, 3); the link frame equals its parent joint's frame (URDF child
  frame convention), matching raisim body frames after fixed-joint merging.
- Jacobians map joint velocities to world-frame twists; columns are masked by
  the static ancestor matrix.

Every constant is a host array copied to the device once (``ops.constant``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import constant, matvec
from ..ops.precision import f32_matmuls
from .model_data import PRISMATIC, REVOLUTE, RobotModel


class FK(NamedTuple):
    rotation: torch.Tensor  # (..., J, 3, 3) world rotation of each link frame
    origin: torch.Tensor  # (..., J, 3) world origin of each link frame
    axis_world: torch.Tensor  # (..., J, 3) world joint axis direction


def _unit(axis) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    return axis / np.linalg.norm(axis)


def _axis_rotation(axis: np.ndarray, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a static host axis (3,) by ``angle`` (...)."""
    k = _unit(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return constant(np.eye(3), angle) + s * constant(K, angle) + (1.0 - c) * constant(K @ K, angle)


@f32_matmuls
def forward_kinematics(model: RobotModel, q: torch.Tensor) -> FK:
    """World transforms of all moving link frames for joint positions q
    (..., J)."""
    batch = q.shape[:-1]
    rotations, origins, axes = [], [], []
    for i in range(model.n_joints):
        R_off = constant(model.rotation[i], q)
        p_off = constant(model.translation[i], q)
        parent = int(model.parent[i])
        if parent < 0:
            # The root's parent is the world: identity rotation, zero origin.
            R_joint = R_off.expand(*batch, 3, 3)
            p_joint = p_off.expand(*batch, 3)
        else:
            R_parent, p_parent = rotations[parent], origins[parent]
            R_joint = R_parent @ R_off
            p_joint = matvec(R_parent, p_off) + p_parent

        a = constant(_unit(model.axis[i]), q)
        qi = q[..., i]
        if int(model.joint_type[i]) == REVOLUTE:
            R_world = R_joint @ _axis_rotation(model.axis[i], qi)
            p_world = p_joint
        else:  # prismatic
            R_world = R_joint
            p_world = p_joint + qi[..., None] * (R_joint @ a)

        rotations.append(R_world)
        origins.append(p_world)
        axes.append(R_joint @ a)

    return FK(
        rotation=torch.stack(rotations, dim=-3),
        origin=torch.stack(origins, dim=-2),
        axis_world=torch.stack(axes, dim=-2),
    )


def _attached_transform(fk: FK, parent: int, R_fix: np.ndarray, p_fix: np.ndarray):
    R_fix = constant(R_fix, fk.origin)
    p_fix = constant(p_fix, fk.origin)
    if parent < 0:
        batch = fk.origin.shape[:-2]
        return R_fix.expand(*batch, 3, 3), p_fix.expand(*batch, 3)
    R_parent = fk.rotation[..., parent, :, :]
    p_parent = fk.origin[..., parent, :]
    return R_parent @ R_fix, matvec(R_parent, p_fix) + p_parent


def frame_transform(model: RobotModel, fk: FK, frame: str):
    """World (R, p) of a named fixed frame (reference Frame enum;
    raisim getFramePosition/getFrameOrientation)."""
    parent, R_fix, p_fix = model.frames[frame]
    return _attached_transform(fk, parent, R_fix, p_fix)


def link_transform(model: RobotModel, fk: FK, link: str):
    """World (R, p) of a named link frame (reference Link enum;
    dynamics->get_link_position, assisted_manipulation.cpp:136-140)."""
    parent, R_fix, p_fix = model.link_frames[link]
    return _attached_transform(fk, parent, R_fix, p_fix)


@f32_matmuls
def link_positions(model: RobotModel, fk: FK, links) -> torch.Tensor:
    """World positions of a list of named links, stacked (..., L, 3): one
    gather and one batched product for all of them."""
    entries = [model.link_frames[link] for link in links]
    parents = [parent for parent, _, _ in entries]
    if min(parents) < 0:
        return torch.stack([link_transform(model, fk, link)[1] for link in links], dim=-2)
    index = constant(parents, fk.origin, torch.int64)
    offsets = constant(np.stack([p for _, _, p in entries]), fk.origin)
    return matvec(fk.rotation[..., index, :, :], offsets) + fk.origin[..., index, :]


@f32_matmuls
def point_jacobian(model: RobotModel, fk: FK, point: torch.Tensor, body: int) -> torch.Tensor:
    """Linear Jacobian (..., 3, J) of a world ``point`` rigidly attached to
    moving link ``body`` (the corrected version of the reference's linear
    frame Jacobian — raisim_dynamics.cpp:154-158 erroneously filled it from
    the rotational Jacobian; this is the intended true linear map)."""
    like = fk.origin
    mask = constant(model.ancestor[:, body].astype(np.float64), like)  # (J,)
    is_prismatic = constant((model.joint_type == PRISMATIC).astype(np.float64), like)

    r = point[..., None, :] - fk.origin  # (..., J, 3)
    rotational = torch.linalg.cross(fk.axis_world, r, dim=-1)  # (..., J, 3)
    columns = is_prismatic[:, None] * fk.axis_world + (1.0 - is_prismatic)[:, None] * rotational
    columns = columns * mask[:, None]
    return columns.mT  # (..., 3, J)


@f32_matmuls
def angular_jacobian(model: RobotModel, fk: FK, body: int) -> torch.Tensor:
    """Angular Jacobian (..., 3, J) of moving link ``body``."""
    weights = model.ancestor[:, body] & (model.joint_type == REVOLUTE)
    return (fk.axis_world * constant(weights.astype(np.float64), fk.origin)[:, None]).mT


@f32_matmuls
def com_positions(model: RobotModel, fk: FK) -> torch.Tensor:
    """World COM position of every composite link (..., J, 3)."""
    return matvec(fk.rotation, constant(model.com, fk.origin)) + fk.origin

"""Batched rigid-body dynamics: CRBA mass matrix + RNEA, common-origin
spatial algebra, fixed topology unrolled in Python (port of
assistedmanipulation_tpu/models/dynamics.py).

Replaces the reference's per-thread RaiSim worlds (raisim_dynamics.cpp) and
the Pinocchio ABA path (pinocchio_dynamics.cpp:153-260) with batched tensor
code:

- The mass matrix comes from the composite-rigid-body identity expressed at a
  single common origin (the world origin): with per-joint motion subspaces
  S_i = [a; o x a] (revolute) / [0; a] (prismatic) and per-body 6x6 spatial
  inertias I_k about the origin, M = sum_k S~_k I_k S~_k^T where S~_k masks
  columns by ancestry.
- Nonlinear effects h(q, v) (gravity + Coriolis) come from an RNEA pass in
  the same coordinates. The reference's actuation feeds getNonlinearities
  back as feedforward (raisim_dynamics.cpp:220-224), so h cancels exactly in
  the rollout dynamics and is only needed for joint-power logging.
- Forward dynamics uses RaiSim-style *implicitly damped* PD: solving
  (M + dt*Kd) qdd = kp (q* - q) + kd (v* - v) + tau_ff + J^T f keeps the
  stiff base (kd=1000) and gripper (kp=100, kd=50 on 0.1 kg fingers) gains
  stable at dt = 0.005-0.01 s, matching RaiSim's stable PD integrator.

Spatial vector convention: [angular; linear] measured at the world origin.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import constant
from .linalg import cholesky_factor, solve_factored
from .precision import f32_matmuls
from .kinematics import FK, com_positions
from .model_data import PRISMATIC, RobotModel


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (..., 3, 3) of vectors (..., 3)."""
    x, y, z = torch.unbind(v, -1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )


def motion_subspaces(model: RobotModel, fk: FK) -> torch.Tensor:
    """Per-joint spatial motion subspace S (..., J, 6) at the world origin."""
    is_prismatic = constant((model.joint_type == PRISMATIC).astype(np.float64), fk.origin)[:, None]
    angular = fk.axis_world * (1.0 - is_prismatic)
    linear = (
        torch.linalg.cross(fk.origin, fk.axis_world, dim=-1) * (1.0 - is_prismatic)
        + fk.axis_world * is_prismatic
    )
    return torch.cat([angular, linear], dim=-1)


@f32_matmuls
def spatial_inertias(model: RobotModel, fk: FK) -> torch.Tensor:
    """Per-body 6x6 spatial inertia about the world origin (..., J, 6, 6)."""
    mass = constant(model.mass, fk.origin)[:, None, None]  # (J, 1, 1)
    inertia_local = constant(model.inertia, fk.origin)  # (J, 3, 3)
    R = fk.rotation
    I_com = R @ inertia_local @ R.mT
    cx = _skew(com_positions(model, fk))
    upper_left = I_com + mass * (cx @ cx.mT)
    upper_right = mass * cx
    lower_left = mass * cx.mT
    lower_right = (mass * constant(np.eye(3), fk.origin)).expand_as(upper_left)
    top = torch.cat([upper_left, upper_right], dim=-1)
    bottom = torch.cat([lower_left, lower_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


@f32_matmuls
def mass_matrix(model: RobotModel, fk: FK) -> torch.Tensor:
    """Joint-space mass matrix M(q) (..., J, J) via common-origin CRBA."""
    S = motion_subspaces(model, fk)  # (..., J, 6)
    I = spatial_inertias(model, fk)  # (..., K, 6, 6)
    mask = constant(model.ancestor.astype(np.float64), fk.origin)  # (J joints, K bodies)
    # S~[k, i, :] = ancestor[i, k] * S[i]: masked subspaces per body k.
    S_masked = mask.T[:, :, None] * S[..., None, :, :]  # (..., K, J, 6)
    # M = sum_k S~_k I_k S~_k^T
    IS = S_masked @ I.mT  # (..., K, J, 6): [k, j, a] = sum_b I[k, a, b] S~[k, j, b]
    return torch.einsum("...kia,...kja->...ij", S_masked, IS)


# Velocity regularization of the Coulomb joint friction model. RaiSim
# enforces URDF <dynamics friction> as a dry-friction constraint (exact
# stiction); the plant uses the standard implicit regularization
# tau_f = -c(v) v_next with c(v) = f / (|v| + eps), which reaches the
# kinetic value f sign(v) within 1% for |v| >= 0.1 and limits stiction
# creep to |v| <= eps F / (f - F) under constant applied force F < f.
# Entering the implicit (M + dt C) solve keeps the near-rest stiffness
# c ~ f/eps unconditionally stable.
FRICTION_EPS = 1e-3


def friction_coefficients(model: RobotModel, v: torch.Tensor) -> torch.Tensor:
    """Implicit Coulomb friction damping c(v) = f/(|v|+eps) (..., J).

    Models the URDF joint friction (robot.urdf:41-75: 10 on the base
    x/y/pivot joints) that RaiSim's solver applies. Zeros when the model
    declares no friction."""
    return constant(model.friction, v) / (torch.abs(v) + FRICTION_EPS) + constant(model.damping, v)


@f32_matmuls
def forward_dynamics(M: torch.Tensor, tau: torch.Tensor, kd: torch.Tensor, dt: float) -> torch.Tensor:
    """qdd = (M + dt*diag(kd))^{-1} tau — implicitly damped forward dynamics
    (RaiSim-style stable PD; see module docstring). The JAX version's
    Cholesky and two triangular solves (jax.scipy.linalg.solve_triangular):
    ``torch.linalg.cholesky_ex`` and ``torch.linalg.solve_triangular``."""
    A = M + torch.diag_embed(dt * kd)
    return solve_factored(cholesky_factor(A), tau)

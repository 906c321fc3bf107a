"""Alternative dynamics backend: autodiff Lagrangian mechanics (port of
assistedmanipulation_tpu/models/lagrangian.py).

The reference ships a second, selectable dynamics implementation next to
RaiSim (SimulatorDynamics::create -> RAISIM | PINOCCHIO,
simulation/frankaridgeback/actor_dynamics.cpp:46-86), whose Pinocchio path
is self-documented broken (pinocchio_dynamics.hpp:26-29). This backend
derives the same plant quantities by a different algorithm:

- kinetic energy T(q, v) from the per-body world COM velocities and angular
  velocities, obtained with one forward-mode derivative through the forward
  kinematics (``torch.func.jvp``);
- M(q) = d^2 T / dv^2 by ``torch.func.hessian`` (T is quadratic in v, so
  this is exact);
- h(q, v) = (dp/dq) v - dT/dq + dU/dq from the Euler-Lagrange equations,
  with the generalized momentum p = dT/dv and the gravitational potential
  U = sum_k m_k a_g . c_k for the base acceleration a_g = -gravity (the
  convention of models/dynamics.rnea).

Each function takes one state or a batch (..., 12): the derivatives are
taken per state and ``torch.func.vmap`` maps them over the leading
dimensions, as the plant's other functions take batches. It does more work
than the CRBA/RNEA pair, so the analytic backend stays the planner's
default; this one is the simulator's selectable alternative
(models/factory.py).
"""

from __future__ import annotations

import torch

from ..ops import constant, matvec
from ..ops.precision import f32_matmuls
from . import kinematics as kin
from .model_data import RobotModel


def _over_batch(fn, *args):
    """``fn`` of single states (12,) applied to (..., 12) arguments of one
    batch shape, through ``torch.func.vmap`` over the flattened batch."""
    batch = args[0].shape[:-1]
    if not batch:
        return fn(*args)
    flat = [arg.reshape(-1, arg.shape[-1]) for arg in args]
    out = torch.func.vmap(fn)(*flat)
    return out.reshape(*batch, *out.shape[1:])


def _body_states(model: RobotModel, q: torch.Tensor):
    """(world COM positions (J, 3), world rotations (J, 3, 3))."""
    fk = kin.forward_kinematics(model, q)
    return kin.com_positions(model, fk), fk.rotation


def _kinetic_energy(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    (_, R), (dcoms, dR) = torch.func.jvp(lambda q: _body_states(model, q), (q,), (v,))
    # The angular velocity from the rotation's derivative: skew(w) = dR R^T.
    W = dR @ R.mT
    omega = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)
    mass = constant(model.mass, q)
    I_world = R @ constant(model.inertia, q) @ R.mT
    translational = torch.sum(mass * torch.sum(dcoms * dcoms, dim=-1))
    rotational = torch.sum(omega * matvec(I_world, omega))
    return 0.5 * (translational + rotational)


def _potential_energy(model: RobotModel, q: torch.Tensor, gravity) -> torch.Tensor:
    coms, _ = _body_states(model, q)
    a_g = -constant(gravity, q)
    return torch.sum(constant(model.mass, q) * matvec(coms, a_g))


@f32_matmuls
def kinetic_energy(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T(q, v) = 1/2 sum_k [ m_k |c_k'|^2 + w_k . (R_k I_k R_k^T) w_k ], (...)."""
    return _over_batch(lambda q, v: _kinetic_energy(model, q, v), q, v)


@f32_matmuls
def potential_energy(model: RobotModel, q: torch.Tensor, gravity) -> torch.Tensor:
    """U(q) = sum_k m_k a_g . c_k with a_g = -gravity (rnea's convention), (...)."""
    return _over_batch(lambda q: _potential_energy(model, q, gravity), q)


@f32_matmuls
def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """M(q) = d^2 T / dv^2, (..., 12, 12): exact, T being quadratic in v."""

    def single(q):
        return torch.func.hessian(lambda v: _kinetic_energy(model, q, v))(torch.zeros_like(q))

    return _over_batch(single, q)


@f32_matmuls
def nonlinear_effects(model: RobotModel, q: torch.Tensor, v: torch.Tensor, gravity) -> torch.Tensor:
    """h(q, v) = (dp/dq) v - dT/dq + dU/dq, p = dT/dv (Euler-Lagrange), (..., 12)."""

    def single(q, v):
        def momentum(q):
            return torch.func.grad(lambda v: _kinetic_energy(model, q, v))(v)

        _, dp_dq_v = torch.func.jvp(momentum, (q,), (v,))
        dT_dq = torch.func.grad(lambda q: _kinetic_energy(model, q, v))(q)
        dU_dq = torch.func.grad(lambda q: _potential_energy(model, q, gravity))(q)
        return dp_dq_v - dT_dq + dU_dq

    return _over_batch(single, q, v)

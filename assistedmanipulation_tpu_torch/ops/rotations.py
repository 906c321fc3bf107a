"""Quaternion / rotation utilities, batched over leading dimensions (port of
assistedmanipulation_tpu/ops/rotations.py).

Conventions: quaternions are (w, x, y, z) unit tensors of shape (..., 4).
Covers the reference's angle helpers (src/controller/eigen.hpp:18-33: ZXZ
euler <-> quaternion) plus the rotation machinery the kinematics layer needs
(axis-angle application, quaternion from rotation matrix, slerp for the
orientation trajectories at src/controller/trajectory.cpp:289-325).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constant


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = torch.unbind(q1, -1)
    w2, x2, y2, z2 = torch.unbind(q2, -1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return q * constant([1.0, -1.0, -1.0, -1.0], q)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_axis_angle(axis, angle):
    """Unit quaternion for a rotation of ``angle`` about (unnormalized)
    ``axis``; a host axis takes the angle's dtype and device."""
    angle = torch.as_tensor(angle)
    if not angle.is_floating_point():
        angle = angle.to(torch.get_default_dtype())
    axis = torch.as_tensor(axis, dtype=angle.dtype, device=angle.device)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle[..., None] / 2.0
    vector = axis * torch.sin(half)
    return torch.cat([torch.cos(half).expand(*vector.shape[:-1], 1), vector], dim=-1)


def quat_to_matrix(q):
    """Rotation matrix (..., 3, 3) from quaternion (..., 4)."""
    w, x, y, z = torch.unbind(q, -1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(m):
    """Quaternion (w, x, y, z) from rotation matrix (..., 3, 3).

    Branch-free Shepperd-style selection of the numerically best row."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    # Per-branch scale factors t_k; the numerically stable branch maximizes t.
    t0 = 1.0 + tr
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    scales = torch.stack([t0, t1, t2, t3], dim=-1)

    # Candidate quaternions (w, x, y, z), each valid when its t_k > 0.
    c0 = torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1)
    c1 = torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1)
    c2 = torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1)
    c3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, t3], -1)
    candidates = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4 branch, 4 comp)

    # The first maximum, as jnp.argmax picks it (torch.argmax does not
    # promise which of tied maxima it returns).
    best_t = torch.amax(scales, dim=-1, keepdim=True)
    is_max = scales == best_t
    first = (is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)).to(torch.int32)
    choice = torch.argmax(first, dim=-1, keepdim=True)
    q = torch.gather(candidates, -2, choice[..., None].expand(*choice.shape[:-1], 1, 4))[..., 0, :]
    q = q * (0.5 / torch.sqrt(torch.clamp(best_t, min=1e-12)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # Canonicalize sign (w >= 0).
    return torch.where(q[..., :1] < 0, -q, q)


def euler_zxz_to_quat(euler):
    """ZXZ euler angles -> quaternion (reference eigen.hpp:26-33)."""
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    qz1 = quat_from_axis_angle(np.array([0.0, 0.0, 1.0]), a)
    qx = quat_from_axis_angle(np.array([1.0, 0.0, 0.0]), b)
    qz2 = quat_from_axis_angle(np.array([0.0, 0.0, 1.0]), c)
    return quat_multiply(quat_multiply(qz1, qx), qz2)


def quat_to_euler_zxz(q):
    """Quaternion -> ZXZ euler angles, matching Eigen's eulerAngles(2, 0, 2)
    range conventions (first angle in [0, pi]) used at reference
    eigen.hpp:18-21."""
    m = quat_to_matrix(q)
    # Eigen eulerAngles(2,0,2): R = Rz(a) * Rx(b) * Rz(c), a in [0, pi].
    b = torch.arccos(torch.clamp(m[..., 2, 2], -1.0, 1.0))
    sin_b = torch.sin(b)
    degenerate = torch.abs(sin_b) < 1e-9
    a = torch.where(
        degenerate,
        torch.atan2(m[..., 1, 0], m[..., 0, 0]),
        torch.atan2(m[..., 0, 2], -m[..., 1, 2]),
    )
    c = torch.where(degenerate, torch.zeros_like(b), torch.atan2(m[..., 2, 0], m[..., 2, 1]))
    # Eigen maps the leading angle into [0, pi] by flipping all three.
    flip = a < 0
    a = torch.where(flip, a + math.pi, a)
    b = torch.where(flip, -b, b)
    c = torch.where(flip, c + math.pi, c)
    # Degenerate case: rotation purely about z, split angle into a only.
    a = torch.where(degenerate & (a < 0), a + 2 * math.pi, a)
    return torch.stack([a, b, c], dim=-1)


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation (trajectory.cpp:318-325).

    ``t`` broadcasts against the quaternions' batch shape: a (...,) time
    batch with single (4,) endpoints yields (..., 4) (trajectory playback).
    A ``t`` that already carries the component axis, (..., 1), is taken as
    it is: no axis is added to it (the JAX version adds one and returns a
    result with an extra dimension)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim == 0 or t.shape[-1] != 1:
        t = t[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def quat_from_two_vectors(a, b):
    """Quaternion rotating unit direction of ``a`` onto ``b`` (Eigen
    FromTwoVectors, used by trajectory.cpp:178-181, 283-285)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    cross = _cross(a, b)
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + dot
    # Antiparallel fallback: rotate pi about any orthogonal axis.
    orthogonal = torch.where(
        torch.abs(a[..., :1]) < 0.9,
        _cross(a, constant([1.0, 0.0, 0.0], a)),
        _cross(a, constant([0.0, 1.0, 0.0], a)),
    )
    antiparallel = w[..., 0] < 1e-8
    q = torch.cat([w, cross], dim=-1)
    q_anti = torch.cat([torch.zeros_like(w), orthogonal], dim=-1)
    q = torch.where(antiparallel[..., None], q_anti, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def euler_difference(a, b):
    """Per-axis wrapped angular difference b - a in (-pi, pi] — the working
    version of the reference's empty euler_difference (eigen.hpp:35-37)."""
    d = torch.as_tensor(b) - torch.as_tensor(a)
    return d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))

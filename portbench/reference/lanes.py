"""Batch-last ("lanes") rigid-body math with build-time sparsity elimination
(port of assistedmanipulation_tpu/kernels/lanes.py).

The dynamics step is a *scalar graph over lane vectors*: each physical
scalar (a rotation matrix entry, a mass-matrix entry) is one (T,) tensor
over the rollout batch. Values in the graph are one of

- ``None``              — structural zero (eliminated while the graph is built),
- a Python float        — a constant (folded),
- a (T,) torch tensor   — live lanes.

Joint frames and axes are static model constants, so most FK matrix entries
multiply by exact 0/±1 and fold away. The functions follow the JAX module
line for line, so the operation order (and with it float64 rounding) stays
close to the reference. This is the plain PyTorch version of the fused CUDA
rollout's per-step body.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model_data import PRISMATIC, REVOLUTE, RobotModel

# --- scalar-graph primitives -------------------------------------------------

EPS = 1e-12


def is_zero(a) -> bool:
    return a is None or (isinstance(a, (int, float)) and abs(a) < EPS)


def add(a, b):
    if is_zero(a):
        return None if is_zero(b) else b
    if is_zero(b):
        return a
    return a + b


def sub(a, b):
    if is_zero(b):
        return None if is_zero(a) else a
    if is_zero(a):
        return -b
    return a - b


def mul(a, b):
    if is_zero(a) or is_zero(b):
        return None
    if isinstance(a, (int, float)) and abs(a - 1.0) < EPS:
        return b
    if isinstance(b, (int, float)) and abs(b - 1.0) < EPS:
        return a
    return a * b


def fma(acc, a, b):
    return add(acc, mul(a, b))


def dot3(a, b):
    return fma(fma(mul(a[0], b[0]), a[1], b[1]), a[2], b[2])


def cross3(a, b):
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


def mat3_mul(A, B):
    """3x3 scalar-graph matrix product."""
    return [
        [fma(fma(mul(A[i][0], B[0][j]), A[i][1], B[1][j]), A[i][2], B[2][j])
         for j in range(3)]
        for i in range(3)
    ]


def mat3_vec(A, v):
    return [dot3(A[i], v) for i in range(3)]


def mat3_T(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def acos(x: torch.Tensor) -> torch.Tensor:
    """f32-accurate arccos from elementwise ops only, as the TPU kernel
    computes it (and the CUDA kernel after it): the Cephes asinf polynomial
    (~1 ulp) on |x| <= 0.5, the half-angle identity outside."""
    half_pi = math.pi / 2
    ax = torch.abs(x)

    def asin_poly(v):  # |v| <= ~0.7071; v = sin(theta)
        z = v * v
        p = 4.2163199048e-2
        p = p * z + 2.4181311049e-2
        p = p * z + 4.5470025998e-2
        p = p * z + 7.4953002686e-2
        p = p * z + 1.6666752422e-1
        return v + v * z * p

    # |x| > 0.5: acos(|x|) = 2 asin(sqrt((1 - |x|) / 2)).
    s = torch.sqrt(torch.clamp(0.5 * (1.0 - ax), min=0.0))
    acos_big = 2.0 * asin_poly(s)
    acos_small = half_pi - asin_poly(x)  # signed, |x| <= 0.5
    big = ax > 0.5
    # Reflect for negative x in the big branch: acos(-x) = pi - acos(x).
    return torch.where(
        big, torch.where(x < 0, math.pi - acos_big, acos_big), acos_small
    )


def materialize(value, like: torch.Tensor) -> torch.Tensor:
    """Turn a graph value into a concrete (T,) tensor."""
    if value is None:
        return torch.zeros_like(like)
    if isinstance(value, (int, float)):
        return torch.full_like(like, value)
    return value


def static_mat(M: np.ndarray):
    """3x3 numpy matrix -> scalar graph of floats/zeros."""
    return [
        [None if abs(M[i, j]) < EPS else float(M[i, j]) for j in range(3)]
        for i in range(3)
    ]


def static_vec(v: np.ndarray):
    return [None if abs(x) < EPS else float(x) for x in np.asarray(v)]


# --- forward kinematics ------------------------------------------------------


class LaneFK:
    """Per-link world transforms as scalar graphs.

    rotation[i]: 3x3 graph; origin[i]: 3 graph; axis_world[i]: 3 graph.
    """

    __slots__ = ("rotation", "origin", "axis_world")

    def __init__(self, rotation, origin, axis_world):
        self.rotation = rotation
        self.origin = origin
        self.axis_world = axis_world


def lane_fk(model: RobotModel, q) -> LaneFK:
    """Forward kinematics over lanes. ``q``: list of 12 (T,) tensors (or a
    (12, T) tensor)."""
    if isinstance(q, torch.Tensor):
        q = [q[i] for i in range(model.n_joints)]

    rotations, origins, axes = [], [], []
    for i in range(model.n_joints):
        R_off = static_mat(model.rotation[i])
        p_off = static_vec(model.translation[i])
        parent = int(model.parent[i])
        if parent < 0:
            R_parent = static_mat(np.eye(3))
            p_parent = [None, None, None]
        else:
            R_parent, p_parent = rotations[parent], origins[parent]

        # Joint frame before motion.
        R_joint = mat3_mul(R_parent, R_off)
        p_joint = [add(mat3_vec(R_parent, p_off)[k], p_parent[k]) for k in range(3)]

        axis = np.asarray(model.axis[i], dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        qi = q[i]

        if int(model.joint_type[i]) == REVOLUTE:
            # Rodrigues with the static skew matrix K of the joint axis.
            c, s = torch.cos(qi), torch.sin(qi)
            K = np.array(
                [
                    [0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0],
                ]
            )
            K2 = K @ K
            R_motion = [
                [
                    add(
                        add(1.0 if a == b else None, mul(s, None if abs(K[a, b]) < EPS else float(K[a, b]))),
                        mul(sub(1.0, c), None if abs(K2[a, b]) < EPS else float(K2[a, b])),
                    )
                    for b in range(3)
                ]
                for a in range(3)
            ]
            R_world = mat3_mul(R_joint, R_motion)
            p_world = p_joint
        else:  # prismatic
            R_world = R_joint
            step = mat3_vec(R_joint, static_vec(axis))
            p_world = [add(p_joint[k], mul(qi, step[k])) for k in range(3)]

        a_world = mat3_vec(R_joint, static_vec(axis))
        rotations.append(R_world)
        origins.append(p_world)
        axes.append(a_world)

    return LaneFK(rotations, origins, axes)


def lane_frame(model: RobotModel, fk: LaneFK, table: dict, name: str):
    """World (R graph, p graph) of a named frame from ``model.frames`` or
    ``model.link_frames``."""
    parent, R_fix, p_fix = table[name]
    if parent < 0:
        return static_mat(R_fix), static_vec(p_fix)
    R_parent = fk.rotation[parent]
    p_parent = fk.origin[parent]
    R = mat3_mul(R_parent, static_mat(R_fix))
    p = [add(mat3_vec(R_parent, static_vec(p_fix))[k], p_parent[k]) for k in range(3)]
    return R, p


def lane_point_jacobian(model: RobotModel, fk: LaneFK, point, body: int):
    """Linear point Jacobian columns (12 entries of 3-graphs); joints that do
    not move ``body`` give structural-zero columns."""
    columns = []
    for i in range(model.n_joints):
        if not model.ancestor[i, body]:
            columns.append([None, None, None])
            continue
        if int(model.joint_type[i]) == PRISMATIC:
            columns.append(fk.axis_world[i])
        else:
            r = [sub(point[k], fk.origin[i][k]) for k in range(3)]
            columns.append(cross3(fk.axis_world[i], r))
    return columns  # [joint][xyz]


# --- mass matrix (CRBA with composite inertias at the world origin) ----------


def _spatial_inertia(model: RobotModel, fk: LaneFK, k: int):
    """Body k's 6x6 spatial inertia about the world origin as a scalar graph."""
    m = float(model.mass[k])
    R = fk.rotation[k]
    com_local = static_vec(model.com[k])
    com = [add(mat3_vec(R, com_local)[a], fk.origin[k][a]) for a in range(3)]

    # I_com world = R I_local R^T (I_local static symmetric).
    I_local = static_mat(model.inertia[k])
    I_world = mat3_mul(mat3_mul(R, I_local), mat3_T(R))

    cx = [
        [None, mul(-1.0, com[2]), com[1]],
        [com[2], None, mul(-1.0, com[0])],
        [mul(-1.0, com[1]), com[0], None],
    ]
    cxT = mat3_T(cx)
    # upper-left: I_com + m cx cx^T; upper-right: m cx; lower-right: m I.
    cx_cxT = mat3_mul(cx, cxT)
    UL = [[add(I_world[a][b], mul(m, cx_cxT[a][b])) for b in range(3)] for a in range(3)]
    UR = [[mul(m, cx[a][b]) for b in range(3)] for a in range(3)]
    LL = [[mul(m, cxT[a][b]) for b in range(3)] for a in range(3)]
    LR = [[m if a == b else None for b in range(3)] for a in range(3)]

    inertia = [[None] * 6 for _ in range(6)]
    for a in range(3):
        for b in range(3):
            inertia[a][b] = UL[a][b]
            inertia[a][b + 3] = UR[a][b]
            inertia[a + 3][b] = LL[a][b]
            inertia[a + 3][b + 3] = LR[a][b]
    return inertia


def _motion_subspace(model: RobotModel, fk: LaneFK, i: int):
    """S_i = [axis; origin x axis] (revolute) or [0; axis] (prismatic)."""
    if int(model.joint_type[i]) == PRISMATIC:
        return [None, None, None] + fk.axis_world[i]
    lin = cross3(fk.origin[i], fk.axis_world[i])
    return fk.axis_world[i] + lin


def lane_mass_matrix(model: RobotModel, fk: LaneFK):
    """M(q) as a 12x12 scalar graph via CRBA: composite inertias accumulate
    leaf-to-root (no transforms needed at a common origin), then
    M[i, j] = S_j^T (I^c_i S_i) for j an ancestor-or-self of i."""
    n = model.n_joints
    composites = [_spatial_inertia(model, fk, k) for k in range(n)]
    for k in reversed(range(n)):
        parent = int(model.parent[k])
        if parent >= 0:
            for a in range(6):
                for b in range(6):
                    composites[parent][a][b] = add(
                        composites[parent][a][b], composites[k][a][b]
                    )

    subspaces = [_motion_subspace(model, fk, i) for i in range(n)]

    M = [[None] * n for _ in range(n)]
    for i in range(n):
        Ic = composites[i]
        Si = subspaces[i]
        F = [None] * 6
        for a in range(6):
            acc = None
            for b in range(6):
                acc = fma(acc, Ic[a][b], Si[b])
            F[a] = acc
        # Diagonal + ancestor entries.
        j = i
        while j >= 0:
            Sj = subspaces[j]
            acc = None
            for a in range(6):
                acc = fma(acc, Sj[a], F[a])
            M[i][j] = acc
            M[j][i] = acc
            j = int(model.parent[j])
    return M


# --- linear algebra over lanes ----------------------------------------------


def lane_cholesky_solve(M, rhs, like: torch.Tensor):
    """Solve M x = rhs for a symmetric positive-definite 12x12 scalar-graph
    matrix, unrolled Cholesky over lanes. ``rhs``: 12-graph. Returns a list
    of 12 (T,) tensors."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = materialize(M[j][j], like)
        for k in range(j):
            if L[j][k] is not None:
                acc = acc - L[j][k] * L[j][k]
        diag = torch.sqrt(acc)
        inv_diag = 1.0 / diag
        L[j][j] = diag
        for i in range(j + 1, n):
            acc = M[i][j]
            s = None
            for k in range(j):
                s = fma(s, L[i][k], L[j][k])
            value = sub(acc, s)
            if value is None:
                L[i][j] = None
            else:
                L[i][j] = materialize(value, like) * inv_diag

    # Forward substitution L y = rhs.
    y = [None] * n
    for i in range(n):
        acc = rhs[i]
        s = None
        for k in range(i):
            s = fma(s, L[i][k], y[k])
        value = sub(acc, s)
        y[i] = materialize(value, like) / L[i][i]

    # Back substitution L^T x = y.
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        s = None
        for k in range(i + 1, n):
            s = fma(s, L[k][i], x[k])
        value = sub(acc, s)
        x[i] = materialize(value, like) / L[i][i]
    return x

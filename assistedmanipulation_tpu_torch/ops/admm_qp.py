"""Batched ADMM solver for small dense QPs (port of
assistedmanipulation_tpu/ops/admm_qp.py).

The reference vendored OSQP behind a ``QuadraticProgram`` wrapper whose
``solve()`` was never implemented (src/controller/qp.hpp:9-142,
qp.cpp:100-103). This is the OSQP ADMM iteration specialised to small dense
problems, batched over leading dimensions, with a fixed iteration count and
no data-dependent stop, so it runs inside a captured CUDA graph.

Problem form (as OSQP): minimise 1/2 x^T P x + q^T x subject to
l <= A x <= u; equality constraints are rows with l == u.

The JAX iteration (OSQP, Stellato et al. 2020, fixed step):

    x~ = K^{-1} (sigma x - q + A^T (rho z - y)),  K = P + sigma I + rho A^T A
    x+ = alpha x~ + (1 - alpha) x
    zh = alpha A x~ + (1 - alpha) z
    z+ = clip(zh + y / rho, l, u)
    y+ = y + rho (zh - z+)

Here it runs on the pair s = (x, w) with w = zh + y / rho, from which
z = clip(w, l, u) and y = rho (w - z): then (x+, w+) is one affine map of
(x, w) and of z, so an iteration is three device operations (the clip, a
batched product and an in-place product-add) in place of the JAX
version's twenty. The maps are built once per block from K^{-1} (one
factorisation and one inverse).
The arithmetic is the same iteration in another order: it agrees with the
JAX version to rounding.

That is the plain version, ``solve_qp_plain``. ``solve_qp`` takes it for
CPU tensors; for CUDA tensors it launches the hand-written kernel of
kernels/csrc/admm_qp.cu, which runs the same solve (equilibration, every
block's factorisation and maps, every iteration, the rho updates and the
residuals) as one launch per call (kernels/admm_qp.py), and raises on any
other device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import admm_qp as admm_qp_kernel
from .linalg import cholesky_factor, cholesky_inverse
from .precision import f32_matmuls


class QPSolution(NamedTuple):
    x: torch.Tensor  # (..., n) primal solution
    z: torch.Tensor  # (..., m) constraint values (projected)
    y: torch.Tensor  # (..., m) dual solution
    primal_residual: torch.Tensor  # (...,) max |A x - z|
    dual_residual: torch.Tensor  # (...,) max |P x + q + A^T y|


def _amax_abs(value: torch.Tensor) -> torch.Tensor:
    """max |value| over the last dimension of (N, k, 1), as (N,)."""
    return torch.amax(torch.abs(value[..., 0]), dim=-1)


def _flatten(P, q, A, l, u, x0):
    """The problems broadcast over their leading dimensions and flattened to
    one: (batch shape, P (N, n, n), q (N, n), A (N, m, n), l, u (N, m), x0
    (N, n) or None)."""
    n, m = q.shape[-1], A.shape[-2]
    batch = torch.broadcast_shapes(P.shape[:-2], q.shape[:-1], A.shape[:-2], l.shape[:-1], u.shape[:-1])

    def flat(value, *tail):
        return value.expand(*batch, *tail).reshape(-1, *tail)

    x0 = None if x0 is None else flat(x0, n)
    return batch, flat(P, n, n), flat(q, n), flat(A, m, n), flat(l, m), flat(u, m), x0


@f32_matmuls
def solve_qp(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    iterations: int = 50,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    x0: Optional[torch.Tensor] = None,
    adaptive_blocks: int = 4,
) -> QPSolution:
    """Solve dense QPs. ``P``: (..., n, n) positive semidefinite, ``q``:
    (..., n), ``A``: (..., m, n), ``l``/``u``: (..., m); leading dimensions
    broadcast.

    Runs ``adaptive_blocks`` blocks of ``iterations`` ADMM steps; between
    blocks rho is rescaled by the OSQP residual-balancing rule
    rho *= sqrt(r_primal_rel / r_dual_rel) (Stellato et al. 2020, §5.2) and
    K is refactorised. CPU tensors take ``solve_qp_plain``; CUDA tensors
    one launch of the kernel (float32 or float64, n <= 16, m <= 64); any
    other device raises."""
    if q.device.type == "cpu":
        return solve_qp_plain(P, q, A, l, u, iterations, rho, sigma, alpha, x0, adaptive_blocks)
    batch, *problems = _flatten(P, q, A, l, u, x0)
    x, z, y, primal, dual = admm_qp_kernel.solve(*problems, iterations, rho, sigma, alpha, adaptive_blocks)
    n, m = x.shape[-1], z.shape[-1]
    return QPSolution(
        x=x.reshape(*batch, n),
        z=z.reshape(*batch, m),
        y=y.reshape(*batch, m),
        primal_residual=primal.reshape(batch),
        dual_residual=dual.reshape(batch),
    )


@f32_matmuls
def solve_qp_plain(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    iterations: int = 50,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    x0: Optional[torch.Tensor] = None,
    adaptive_blocks: int = 4,
) -> QPSolution:
    """``solve_qp`` in plain PyTorch, on any device: three device
    operations per iteration."""
    n, m = q.shape[-1], A.shape[-2]
    dtype, device = q.dtype, q.device
    batch, P, q, A, l, u, x0 = _flatten(P, q, A, l, u, x0)
    q, l, u = q[..., None], l[..., None], u[..., None]
    N = P.shape[0]

    # Row equilibration (diagonal Ruiz scaling of the constraints): without
    # it a uniform rho stalls on rows whose norms differ by orders of
    # magnitude. Same feasible set; only the duals are rescaled.
    scale = 1.0 / torch.clamp(torch.amax(torch.abs(A), dim=-1, keepdim=True), min=1e-8)
    A, l, u = A * scale, l * scale, u * scale
    At = A.mT
    AtA = At @ A
    eye_n = torch.eye(n, dtype=dtype, device=device)
    P_sigma = P + sigma * eye_n
    D = torch.cat([eye_n.expand(N, n, n), A], dim=1)  # (N, n + m, n): x and A x
    sigma_eye = (sigma * eye_n).expand(N, n, n)
    # The parts of the maps that do not depend on K: x+ keeps (1 - alpha) x
    # and w+ keeps w; w+ also takes -alpha z.
    keep = torch.diag(torch.cat([
        torch.full((n,), 1.0 - alpha, dtype=dtype, device=device),
        torch.ones(m, dtype=dtype, device=device),
    ]))
    z_offset = -alpha * torch.cat([torch.zeros((n, m), dtype=dtype, device=device),
                                   torch.eye(m, dtype=dtype, device=device)])

    x = torch.zeros((N, n, 1), dtype=dtype, device=device) if x0 is None else x0[..., None]
    z = torch.clamp(A @ x, l, u)
    y = torch.zeros_like(z)
    rho_k = torch.full((N, 1, 1), rho, dtype=dtype, device=device)
    blocks = max(1, int(adaptive_blocks))
    one = torch.ones((N, 1, 1), dtype=dtype, device=device)
    last_row = torch.cat([torch.zeros(n + m, dtype=dtype, device=device),
                          torch.ones(1, dtype=dtype, device=device)]).expand(N, 1, n + m + 1)
    for block in range(blocks):
        K_inverse = cholesky_inverse(cholesky_factor(P_sigma + rho_k * AtA))
        E = D @ K_inverse  # (N, n + m, n)
        rho_At = rho_k * At
        # (x+, w+, 1) = T1 (x, w, 1) + T2 z: the constant term rides in T1's
        # last column, so a step is a product and an in-place product-add.
        T1 = torch.baddbmm(keep, E, torch.cat([sigma_eye, -rho_At], dim=2), alpha=alpha)
        c = (E @ q) * -alpha
        T1 = torch.cat([torch.cat([T1, c], dim=2), last_row], dim=1)
        T2 = torch.baddbmm(z_offset, E, rho_At, alpha=2.0 * alpha)
        T2 = torch.cat([T2, torch.zeros((N, 1, m), dtype=dtype, device=device)], dim=1)
        s = torch.cat([x, z + y / rho_k, one], dim=1)
        for _ in range(iterations):
            z = torch.clamp(s[:, n:n + m], l, u)
            s = torch.bmm(T1, s).baddbmm_(T2, z)
        x, w = s[:, :n], s[:, n:n + m]
        z = torch.clamp(w, l, u)
        y = rho_k * (w - z)
        if block == blocks - 1:
            break
        # Residual-balanced rho update on relative residuals (OSQP eq. 28).
        Ax, Px = A @ x, P @ x
        r_prim = _amax_abs(Ax - z)
        r_dual = _amax_abs(Px + q + At @ y)
        prim_ref = torch.clamp(torch.maximum(_amax_abs(Ax), _amax_abs(z)), min=1e-12)
        dual_ref = torch.clamp(torch.maximum(_amax_abs(Px), _amax_abs(q)), min=1e-12)
        ratio = torch.sqrt((r_prim / prim_ref) / torch.clamp(r_dual / dual_ref, min=1e-12))
        rho_k = torch.clamp(rho_k * torch.clamp(ratio, 1e-3, 1e3)[:, None, None], 1e-6, 1e6)

    primal = _amax_abs(A @ x - z) if m else torch.zeros(N, dtype=dtype, device=device)
    dual = _amax_abs(P @ x + q + At @ y)
    # z and y in the caller's (unscaled) constraint coordinates.
    return QPSolution(
        x=x[..., 0].reshape(*batch, n),
        z=(z / scale)[..., 0].reshape(*batch, m),
        y=(y * scale)[..., 0].reshape(*batch, m),
        primal_residual=primal.reshape(batch),
        dual_residual=dual.reshape(batch),
    )


def project_box_affine(
    u_target: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    iterations: int = 50,
    rho: float = 1.0,
    adaptive_blocks: int = 4,
) -> QPSolution:
    """Least-change projection: min ||W^(1/2) (x - u_target)||^2 s.t.
    l <= A x <= u — the safety-filter QP (P = W diagonal, q = -W u_target)."""
    w = torch.ones_like(u_target) if weights is None else weights
    return solve_qp(
        torch.diag_embed(w), -w * u_target, A, l, u,
        iterations=iterations, rho=rho, x0=u_target, adaptive_blocks=adaptive_blocks,
    )

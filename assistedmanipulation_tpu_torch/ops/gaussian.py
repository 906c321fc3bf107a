"""Multivariate Gaussian sampling for MPPI control perturbations (port of
assistedmanipulation_tpu/ops/gaussian.py).

The reference factorises the (static, per-config) covariance with a
self-adjoint eigendecomposition and draws noise = mean + (V*sqrt(L)) z
(gaussian.hpp:48-75). Here the factorisation happens once on the host in
float64 (``covariance_transform``); a draw is standard normals from an
explicit ``torch.Generator`` mapped through it. A diagonal covariance (the
robot's, base.hpp:79-94) needs no matmul: its draws are the standard normals
scaled per dof (``diagonal_scale``). Torch's bits differ from JAX's, so
tests feed the same draws to both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def covariance_transform(covariance) -> np.ndarray:
    """Host-side eigendecomposition of the sampling covariance.

    Returns T such that samples = z @ T.T with z ~ N(0, I) have covariance
    ``covariance``; T = V * sqrt(clamp(L, 0)) as in gaussian.hpp:48-55."""
    covariance = np.asarray(covariance, dtype=np.float64)
    if covariance.ndim == 1:
        covariance = np.diag(covariance)
    eigenvalues, eigenvectors = np.linalg.eigh(covariance)
    scale = np.sqrt(np.maximum(eigenvalues, 0.0))
    return eigenvectors * scale[None, :]


def is_diagonal(covariance) -> bool:
    """Whether a (dof,) vector or (dof, dof) covariance has no off-diagonal
    terms."""
    covariance = np.asarray(covariance, dtype=np.float64)
    return covariance.ndim == 1 or not np.count_nonzero(covariance - np.diag(np.diag(covariance)))


def diagonal_scale(covariance) -> np.ndarray:
    """Per-dof standard deviations of a diagonal covariance (a (dof,) vector
    or a (dof, dof) matrix). Raises for a covariance with off-diagonal terms."""
    covariance = np.asarray(covariance, dtype=np.float64)
    if covariance.ndim == 1:
        covariance = np.diag(covariance)
    if not is_diagonal(covariance):
        raise ValueError("only diagonal covariances are supported")
    return np.sqrt(np.diag(covariance))


def noise_factor(covariance) -> np.ndarray:
    """What a draw applies to standard normals: the (dof,) standard
    deviations of a diagonal covariance, else the (dof, dof)
    ``covariance_transform``."""
    return diagonal_scale(covariance) if is_diagonal(covariance) else covariance_transform(covariance)


def correlate(z: torch.Tensor, factor: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Standard normals ``z`` as N(0, cov) draws along ``dim``: scaled
    elementwise by a (dof,) ``factor``, or mapped through a (dof, dof)
    transform T (z @ T.T over that axis)."""
    if factor.dim() == 1:
        view = [1] * z.dim()
        view[dim] = factor.shape[0]
        return z * factor.reshape(view)
    return torch.movedim(torch.movedim(z, dim, -1) @ factor.mT, -1, dim)


def sample_noise(
    generator: torch.Generator, factor: torch.Tensor, shape: tuple, dim: int = -1
) -> torch.Tensor:
    """N(0, cov) draws of ``shape``, the dof along ``dim``; ``factor`` as in
    ``correlate``."""
    z = torch.randn(
        shape, generator=generator, dtype=factor.dtype, device=factor.device
    )
    return correlate(z, factor, dim)

"""Diagonal-covariance Gaussian sampling for MPPI control perturbations (port
of the diagonal path of assistedmanipulation_tpu/ops/gaussian.py).

The robot's covariance is diagonal (base.hpp:79-94), so a draw is standard
normals scaled per dof: no factorisation and no matmul. The draws come from
an explicit ``torch.Generator``; their bits differ from JAX's, so tests feed
the same draws to both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def diagonal_scale(covariance) -> np.ndarray:
    """Per-dof standard deviations of a diagonal covariance (a (dof,) vector
    or a (dof, dof) matrix). Raises for a covariance with off-diagonal terms."""
    covariance = np.asarray(covariance, dtype=np.float64)
    if covariance.ndim == 1:
        covariance = np.diag(covariance)
    if np.count_nonzero(covariance - np.diag(np.diag(covariance))):
        raise ValueError("only diagonal covariances are supported")
    return np.sqrt(np.diag(covariance))


def sample_noise(
    generator: torch.Generator, scale: torch.Tensor, shape: tuple, dim: int = -1
) -> torch.Tensor:
    """N(0, diag(scale^2)) draws of ``shape``; ``scale`` runs along ``dim``."""
    z = torch.randn(
        shape, generator=generator, dtype=scale.dtype, device=scale.device
    )
    view = [1] * len(shape)
    view[dim] = scale.shape[0]
    return z * scale.reshape(view)

"""Dense linear algebra for small systems batched over leading dimensions
(port of assistedmanipulation_tpu/ops/linalg.py).

The JAX package unrolls a Cholesky factorisation at trace time, because a
TPU has no small-matrix factorisation. On the GPU one library call
factors a whole batch: ``torch.linalg.cholesky_ex`` (cuSOLVER), never
``torch.linalg.cholesky``, whose error check reads the result back to the
host and so waits for the device (and breaks a CUDA-graph capture). The
solves are triangular solves (cuBLAS). A matrix that is not positive
definite gives a factor of NaN, as JAX's Cholesky does, so the NaN poisons
what is computed from it.

Used by the safety filter and the ADMM QP, where one factor serves many
solves, and by the plant's forward dynamics.
"""

from __future__ import annotations

import functools

import torch

# Precisions that cuSOLVER's factorisation and cuBLAS's triangular solves do
# not take: the benchmark's lower-precision control runs the reference in
# bfloat16, and its small factorisations go through float32, each result
# rounded back to bfloat16.
_UPCAST = (torch.bfloat16, torch.float16)


def _in_float32(fn):
    @functools.wraps(fn)
    def wrapped(*args):
        dtype = args[0].dtype
        if dtype not in _UPCAST:
            return fn(*args)
        return fn(*(arg.float() for arg in args)).to(dtype)

    return wrapped


@_in_float32
def cholesky_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular factor L of a positive definite (..., n, n) matrix;
    NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


@_in_float32
def solve_matrix(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L L^T X = B for a matrix right-hand side B (..., n, m)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def solve_factored(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for b (..., n) given ``cholesky_factor``'s L."""
    return solve_matrix(L, b[..., None])[..., 0]


@_in_float32
def cholesky_inverse(L: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} from ``cholesky_factor``'s L: L^-T L^-1, one triangular
    solve and one product."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    L_inverse = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L_inverse.mT @ L_inverse

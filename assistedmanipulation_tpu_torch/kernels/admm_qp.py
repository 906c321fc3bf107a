"""The ADMM QP solve as one launch: the driver of csrc/admm_qp.cu.

``solve`` takes problems flattened to one batch dimension
(ops/admm_qp.solve_qp broadcasts and flattens them and dispatches here for
CUDA tensors) and launches one block of threads per problem on the current
stream, without synchronising, so a CUDA graph capture records the whole
solve as one node. The library is built and loaded at the first call
(kernels/build.py), so a process that never solves a QP on the card builds
nothing. It raises for a device other than CUDA, a dtype other than
float32 and float64, and a problem beyond MAX_N variables or MAX_M
constraint rows (the sizes the kernel's shared memory holds). The plain
version it is held to is ops/admm_qp.solve_qp_plain.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

MAX_N, MAX_M = 16, 64  # csrc/admm_qp.cu's NMAX and MMAX
DTYPES = {torch.float32: 0, torch.float64: 1}


def _library():
    lib = build.load("admm_qp")
    if not getattr(lib, "_checked", False):
        lib.aq_launch.restype = ctypes.c_int
        lib.aq_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_double] * 3 + [ctypes.c_void_p]
        )
        limits = (lib.aq_max_n(), lib.aq_max_m())
        if limits != (MAX_N, MAX_M):
            raise RuntimeError(f"admm_qp library compiled for n, m <= {limits}, the driver expects {(MAX_N, MAX_M)}")
        lib._checked = True
    return lib


def solve(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor, l: torch.Tensor, u: torch.Tensor,
          x0: Optional[torch.Tensor], iterations: int, rho: float, sigma: float, alpha: float,
          blocks: int) -> tuple:
    """Solve N QPs, P (N, n, n), q (N, n), A (N, m, n), l and u (N, m), x0
    (N, n) or None (zeros), by ``blocks`` blocks of ``iterations`` ADMM
    steps, as ops/admm_qp.solve_qp_plain does. Returns (x (N, n), z (N, m),
    y (N, m), primal residual (N,), dual residual (N,)), z and y in the
    caller's unscaled rows."""
    N, n, m = q.shape[0], q.shape[-1], A.shape[-2]
    tensors = (P, q, A, l, u) + (() if x0 is None else (x0,))
    if q.dtype not in DTYPES:
        raise TypeError(f"no ADMM QP kernel for {q.dtype}: float32 and float64 only")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"the QP's tensors must share one dtype, got {[t.dtype for t in tensors]}")
    if not (1 <= n <= MAX_N and m <= MAX_M):
        raise ValueError(f"the ADMM QP kernel takes 1 <= n <= {MAX_N} variables and m <= {MAX_M} rows, got {n} x {m}")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"no ADMM QP kernel for device {q.device}: CUDA tensors on one device only")
    out = torch.empty((N, n + 2 * m + 2), dtype=q.dtype, device=q.device)
    if N:
        P, q, A, l, u = (t.contiguous() for t in (P, q, A, l, u))
        x0 = None if x0 is None else x0.contiguous()
        with torch.cuda.device(q.device):
            err = _library().aq_launch(
                DTYPES[q.dtype], P.data_ptr(), q.data_ptr(), A.data_ptr(), l.data_ptr(), u.data_ptr(),
                None if x0 is None else x0.data_ptr(), out.data_ptr(), N, n, m, max(0, int(iterations)),
                max(1, int(blocks)), float(rho), float(sigma), float(alpha),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"admm_qp launch failed: CUDA error {err}")
        build.count_launch("admm_qp")
    return out[:, :n], out[:, n:n + m], out[:, n + m:n + 2 * m], out[:, n + 2 * m], out[:, n + 2 * m + 1]

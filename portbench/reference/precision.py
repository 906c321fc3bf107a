"""Matmul precision of the port's small float32 products (counterpart of
assistedmanipulation_tpu/ops/precision.py).

The Kalman covariances (~1e-8), the 3x3 rotation chains of the forward
kinematics, the 12x12 mass matrix and the safety filter's QP amplify a
rounded product: the JAX package pins those matmuls to full float32
(``f32_matmuls``, whose absence NaNs the plant within ~40 steps on the
TPU). PyTorch's counterpart of the TPU's bf16 passes is TF32 on the card,
which keeps about three decimal digits. It is off by default; these
functions raise when it is on instead of returning a rounded result.
"""

from __future__ import annotations

import functools

import torch


def check_f32_matmuls(what: str = "this computation") -> None:
    """Raise when float32 matmuls may run in TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"torch.backends.cuda.matmul.allow_tf32 is True: {what} needs full "
            "float32 matmuls"
        )


def f32_matmuls(fn):
    """Decorator: ``check_f32_matmuls`` before every call of ``fn``."""
    what = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        check_f32_matmuls(what)
        return fn(*args, **kwargs)

    return wrapped

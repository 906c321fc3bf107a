import numpy as np
import torch


def true_divide(numerator: torch.Tensor, denominator: float) -> torch.Tensor:
    """``numerator / denominator`` as a correctly rounded division.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can round differently from a true division (e.g.
    (0.2 - 0.15) / 0.01). The planner derives integer slot counts from such
    quotients, so it divides by a tensor instead."""
    return numerator / torch.full_like(numerator, denominator)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (..., m, n) applied to vectors v (..., n): (..., m), broadcasting."""
    return (M @ v[..., None])[..., 0]


# (bytes, shape, numpy dtype, torch dtype, device) -> tensor: every host
# constant is copied to a device once, so the functions that read them make
# no host-to-device copy after their first call (a captured CUDA graph could
# not take one).
_constants: dict = {}


def constant(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The host array (or number) ``values`` as a tensor of ``like``'s dtype
    (or ``dtype``) on ``like``'s device, made at the first call for these
    values and reused after. The tensor is shared: never write to it."""
    array = np.asarray(values)
    dtype = dtype or like.dtype
    key = (array.tobytes(), array.shape, array.dtype.str, dtype, like.device)
    tensor = _constants.get(key)
    if tensor is None:
        tensor = torch.as_tensor(array).to(dtype=dtype, device=like.device)
        _constants[key] = tensor
    return tensor

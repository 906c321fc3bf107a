import numpy as np
import torch


def true_divide(numerator: torch.Tensor, denominator: float) -> torch.Tensor:
    """``numerator / denominator`` as a correctly rounded division.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can round differently from a true division (e.g.
    (0.2 - 0.15) / 0.01). The planner derives integer slot counts from such
    quotients, so it divides by a tensor instead."""
    return numerator / torch.full_like(numerator, denominator)


def take_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for an integer tensor ``index`` of any shape, 0-d
    included: (*index.shape, *table.shape[1:]). Indexing with a 0-d tensor
    reads it back to the host as a number, which a captured CUDA graph
    cannot do; this gathers on the device."""
    return table[index.reshape(-1)].reshape(*index.shape, *table.shape[1:])


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
        # Made outside any torch.func transform the caller runs in: a
        # tensor made inside one is wrapped at its level and would escape
        # it through the cache.
        guard = torch._C._DisableFuncTorch()  # noqa: F841
        tensor = torch.as_tensor(array).to(dtype=dtype, device=like.device)
        del guard
        _constants[key] = tensor
    return tensor

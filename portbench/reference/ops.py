import numpy as np
import torch


def true_divide(numerator: torch.Tensor, denominator: float) -> torch.Tensor:
    """``numerator / denominator`` as a correctly rounded division.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can round differently from a true division (e.g.
    (0.2 - 0.15) / 0.01). The planner derives integer slot counts from such
    quotients, so it divides by a tensor instead."""
    return numerator / torch.full_like(numerator, denominator)


def per_step(elapsed: torch.Tensor, dt: float) -> torch.Tensor:
    """``elapsed / dt``: a time span in steps of ``dt``, as the JAX package
    computes it. In float32 that is the product with float32(1 / dt): XLA
    compiles the JAX package's ``(t - t0) / dt`` into it, and the two round
    differently at whole steps ((0.59 - 0.10) / 0.01 is 49.0 divided and
    48.999996 as the product), so an index truncated from the quotient lands
    one step apart. In float64 it is a correctly rounded division, as the
    reference's."""
    if elapsed.dtype == torch.float64:
        return true_divide(elapsed, dt)
    return elapsed * constant(np.float32(1.0) / np.float32(dt), elapsed)


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

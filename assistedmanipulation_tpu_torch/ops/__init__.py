import torch


def true_divide(numerator: torch.Tensor, denominator: float) -> torch.Tensor:
    """``numerator / denominator`` as a correctly rounded division.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can round differently from a true division (e.g.
    (0.2 - 0.15) / 0.01). The planner derives integer slot counts from such
    quotients, so it divides by a tensor instead."""
    return numerator / torch.full_like(numerator, denominator)

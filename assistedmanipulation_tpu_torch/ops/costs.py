"""Scalar cost primitives as branch-free, batched tensor expressions (port of
assistedmanipulation_tpu/ops/costs.py).

Re-implements the reference's functor cost family
(reference: src/controller/cost.hpp:10-167):

- ``QuadraticCost``:          c0 + c1*|v| + c2*v^2
- ``RightInverseBarrier``:    scale/(upper-v) clamped to max; quadratic past bound
- ``LeftInverseBarrier``:     scale/(v-lower) clamped to max; quadratic past bound
- ``UpperLogBarrier``:        min(scale*(-log10(upper-v)+offset), 0); max past bound
- ``LowerLogBarrier``:        min(scale*(-log10(v-lower)+offset), 0); max past bound

Everything is written with ``torch.where`` (never a branch on a value), so
the same expression runs on any batch and inside a captured CUDA graph, and
NaN inputs give NaN costs (the MPPI weighting relies on NaN poisoning,
reference src/controller/mppi.cpp:331-334). A bound or scale may be a
number or a host array that broadcasts against the value (one barrier for
all twelve joints).

Two-channel decomposition: in float32 a 1e10 saturation swamps the smooth
cost, so each barrier also exposes ``decomposed(value) -> (saturations,
smooth)``: a count of maximum_cost saturations and the residual smooth
cost. The planner accumulates the channels apart and composes them
lexicographically (mppi.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constant

# Barrier saturation cost: a saturated barrier counts one violation, and the
# planner composes violations * MAXIMUM_COST_DEFAULT + smooth.
MAXIMUM_COST_DEFAULT = 1e10


def _param(value, like: torch.Tensor):
    """A number stays a number; a host array becomes a cached tensor of
    ``like``'s dtype and device."""
    return float(value) if np.ndim(value) == 0 else constant(value, like)


def _nan_where(value, result):
    return torch.where(torch.isnan(value), float("nan"), result)


@dataclasses.dataclass
class QuadraticCost:
    """c0 + c1*|v| + c2*v^2 (reference cost.hpp:10-37)."""

    constant_cost: float = 0.0
    linear_cost: float = 0.0
    quadratic_cost: float = 0.0

    def __call__(self, value):
        return (
            self.constant_cost
            + self.linear_cost * torch.abs(value)
            + self.quadratic_cost * value * value
        )


@dataclasses.dataclass
class RightInverseBarrier:
    """Inverse barrier against an upper bound (reference cost.hpp:43-68).

    value <  upper: min(scale / (upper - value), maximum_cost)
    value >= upper: maximum_cost + scale * (value - upper)^2
    """

    upper_bound: float = 0.0
    scale: float = 0.0
    maximum_cost: float = MAXIMUM_COST_DEFAULT

    def __call__(self, value):
        upper, scale = _param(self.upper_bound, value), _param(self.scale, value)
        gap = upper - value
        # Guard the division so the inside branch never produces inf/NaN for
        # out-of-bound inputs; torch.where evaluates both branches.
        safe_gap = torch.where(gap > 0, gap, 1.0)
        inside = torch.clamp(scale / safe_gap, max=self.maximum_cost)
        outside = self.maximum_cost + scale * (value - upper) ** 2
        return _nan_where(value, torch.where(value >= upper, outside, inside))

    def decomposed(self, value):
        """(saturations, smooth): value >= bound -> (1, scale*excess^2);
        inside with the 1/gap clamp hit -> (1, 0); else (0, scale/gap)."""
        upper, scale = _param(self.upper_bound, value), _param(self.scale, value)
        gap = upper - value
        safe_gap = torch.where(gap > 0, gap, 1.0)
        raw = scale / safe_gap
        outside = value >= upper
        clamped = raw >= self.maximum_cost
        saturations = (outside | clamped).to(value.dtype)
        smooth = torch.where(
            outside, scale * (value - upper) ** 2, torch.where(clamped, 0.0, raw)
        )
        return _nan_where(value, saturations), _nan_where(value, smooth)


@dataclasses.dataclass
class LeftInverseBarrier:
    """Inverse barrier against a lower bound (reference cost.hpp:74-98)."""

    lower_bound: float = 0.0
    scale: float = 0.0
    maximum_cost: float = MAXIMUM_COST_DEFAULT

    def __call__(self, value):
        lower, scale = _param(self.lower_bound, value), _param(self.scale, value)
        gap = value - lower
        safe_gap = torch.where(gap > 0, gap, 1.0)
        inside = torch.clamp(scale / safe_gap, max=self.maximum_cost)
        outside = self.maximum_cost + scale * (lower - value) ** 2
        return _nan_where(value, torch.where(value <= lower, outside, inside))

    def decomposed(self, value):
        """(saturations, smooth) — see RightInverseBarrier.decomposed."""
        lower, scale = _param(self.lower_bound, value), _param(self.scale, value)
        gap = value - lower
        safe_gap = torch.where(gap > 0, gap, 1.0)
        raw = scale / safe_gap
        outside = value <= lower
        clamped = raw >= self.maximum_cost
        saturations = (outside | clamped).to(value.dtype)
        smooth = torch.where(
            outside, scale * (lower - value) ** 2, torch.where(clamped, 0.0, raw)
        )
        return _nan_where(value, saturations), _nan_where(value, smooth)


@dataclasses.dataclass
class UpperLogBarrier:
    """Logarithmic barrier against an upper bound (reference cost.hpp:105-133).

    value <  upper: min(scale * (-log10(upper - value) + offset), 0)
    value >= upper: maximum_cost
    """

    upper_bound: float = 0.0
    scale: float = 0.0
    offset: float = 0.0
    maximum_cost: float = MAXIMUM_COST_DEFAULT

    def _inside(self, value):
        upper = _param(self.upper_bound, value)
        gap = upper - value
        safe_gap = torch.where(gap > 0, gap, 1.0)
        inside = _param(self.scale, value) * (-torch.log10(safe_gap) + _param(self.offset, value))
        return torch.clamp(inside, max=0.0), value >= upper

    def __call__(self, value):
        inside, outside = self._inside(value)
        return _nan_where(value, torch.where(outside, self.maximum_cost, inside))

    def decomposed(self, value):
        inside, outside = self._inside(value)
        saturations = outside.to(value.dtype)
        smooth = torch.where(outside, 0.0, inside)
        return _nan_where(value, saturations), _nan_where(value, smooth)


@dataclasses.dataclass
class LowerLogBarrier:
    """Logarithmic barrier against a lower bound (reference cost.hpp:139-166)."""

    lower_bound: float = 0.0
    scale: float = 0.0
    offset: float = 0.0
    maximum_cost: float = MAXIMUM_COST_DEFAULT

    def _inside(self, value):
        lower = _param(self.lower_bound, value)
        gap = value - lower
        safe_gap = torch.where(gap > 0, gap, 1.0)
        inside = _param(self.scale, value) * (-torch.log10(safe_gap) + _param(self.offset, value))
        return torch.clamp(inside, max=0.0), value <= lower

    def __call__(self, value):
        inside, outside = self._inside(value)
        return _nan_where(value, torch.where(outside, self.maximum_cost, inside))

    def decomposed(self, value):
        inside, outside = self._inside(value)
        saturations = outside.to(value.dtype)
        smooth = torch.where(outside, 0.0, inside)
        return _nan_where(value, saturations), _nan_where(value, smooth)

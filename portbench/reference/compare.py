"""The numbers that decide whether one update's outputs are correct: the
program's state after an update against the reference's, from the same
state before it.

- ``control_gap``: the widest gap between the published sequences, and
  between the smoothing histories, each as a share of its dof's control
  range (what the robot is sent, and what the next update smooths with);
- ``cost_gap_p99``: over the rollouts whose saturation counts agree, the
  99th percentile of the gaps of the smooth cost channel, each as a share
  of the reference's value or of the median rollout's, whichever is larger
  (the rollout kernel's scores, which set every weight). Not the widest
  gap: that one sits on a rollout whose cost an inverse barrier dominates
  (3 to 140 times the median), where float32's cancellation in the
  barrier's gap moves it by up to 5 times its value from seed to seed;
- ``cost_mismatch``: the share of rollouts whose saturation count, or
  whether the cost is a number at all, differs from the reference's;
- ``exact_mismatch``: the elements that must agree bit for bit and do not:
  the assembled noise (a select of stored and fresh float32 draws), the
  horizon and smoothing times and the update count.

A gap that is not a number counts as infinite, so it fails every limit."""

from __future__ import annotations

import math

import torch

EXACT_FIELDS = ("noise", "last_shift_time", "last_update_time", "sg_time", "update_count")


def _finite(value: float) -> float:
    return math.inf if math.isnan(value) else value


def _range(setup, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(setup.control_max - setup.control_min, dtype=torch.float64, device=like.device)


def _same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise bit-for-bit agreement, NaN agreeing with NaN."""
    a, b = a.to(b.device), b
    if a.dtype != b.dtype:
        return torch.zeros(a.shape, dtype=torch.bool, device=b.device)
    if a.is_floating_point():
        return (a == b) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def exact_mismatch(program: dict, reference: dict, fields=EXACT_FIELDS) -> int:
    return int(sum((~_same(program[name], reference[name])).sum().item() for name in fields))


def numbers(setup, program: dict, reference: dict) -> dict:
    """The compared numbers of one update."""
    scale = _range(setup, reference["optimal_control"])
    published = (program["optimal_control"].double().to(scale.device) - reference["optimal_control"].double()).abs() / scale
    history = (program["sg_buffer"].double().to(scale.device) - reference["sg_buffer"].double()).abs() / scale[:, None]
    control_gap = max(published.max().item(), history.max().item())

    p = program["costs"].double().to(scale.device)
    r = reference["costs"].double()
    p_nan, r_nan = torch.isnan(p).any(dim=1), torch.isnan(r).any(dim=1)
    agree = (p_nan == r_nan) & (p_nan | (p[:, 0] == r[:, 0]))
    both = agree & ~p_nan
    if both.any():
        smooth_scale = torch.clamp(r[:, 1].abs(), min=torch.median(r[both, 1].abs()).item())
        cost_gap = torch.quantile(((p[:, 1] - r[:, 1]).abs() / smooth_scale)[both], 0.99).item()
    else:
        cost_gap = math.inf
    return {
        "control_gap": _finite(control_gap),
        "cost_gap_p99": _finite(cost_gap),
        "cost_mismatch": 1.0 - agree.double().mean().item(),
        "exact_mismatch": exact_mismatch(program, reference),
    }


def worst(readings: list) -> dict:
    """Each number's worst reading over the updates compared."""
    keys = readings[0].keys()
    return {key: max(reading[key] for reading in readings) for key in keys}

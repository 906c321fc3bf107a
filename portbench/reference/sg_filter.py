"""Savitzky-Golay smoothing of the optimal control sequence (port of
assistedmanipulation_tpu/ops/sg_filter.py).

Reference behaviour (src/controller/filter.cpp and the vendored
gram_savitzky_golay, called from src/controller/mppi.cpp:424-440):

- Gram-polynomial least-squares convolution weights for a centred window of
  half-width ``w`` and polynomial order ``n`` (Gorry 1990 recurrences).
- A per-channel buffer of length steps + 2w + 1 that carries ``w`` values of
  history before the current horizon start and extends the horizon end by
  replicating the last control.
- Per update: ``trim`` aligns the buffer with the new horizon start, the
  horizon controls are written in, then ``apply`` filters step by step,
  writing each filtered value back *one slot before* the step it was taken
  at (filter.cpp:104-110), so later steps see a mix of raw and smoothed
  values. The write-back makes the filter sequential in time.

The write-back is linear in the filled buffer, so ``sg_apply`` runs it as
two matrix products with maps worked out once on the host
(``sg_apply_maps``): two launches in place of the ~150 of the step-by-step
loop, which stays as ``sg_apply_sequential``, the plain version the tests
hold the maps to.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


# --- Gram polynomial convolution weights (host) ------------------------------


def _gram_poly(i: int, m: int, k: int, s: int) -> float:
    """Gram polynomial recurrence (Gorry 1990)."""
    if k > 0:
        return (4.0 * k - 2.0) / (k * (2.0 * m - k + 1.0)) * (
            i * _gram_poly(i, m, k - 1, s) + s * _gram_poly(i, m, k - 1, s - 1)
        ) - ((k - 1.0) * (2.0 * m + k)) / (k * (2.0 * m - k + 1.0)) * _gram_poly(
            i, m, k - 2, s
        )
    return 1.0 if (k == 0 and s == 0) else 0.0


def _gen_fact(a: int, b: int) -> float:
    result = 1.0
    for j in range(a - b + 1, a + 1):
        result *= j
    return result


def gram_weights(m: int, t: int = 0, n: int = 2, s: int = 0) -> np.ndarray:
    """Least-squares convolution weights over window [-m, m] evaluated at
    point ``t`` for the ``s``-th derivative of an order-``n`` polynomial fit."""
    weights = np.zeros(2 * m + 1)
    for idx, i in enumerate(range(-m, m + 1)):
        w = 0.0
        for k in range(n + 1):
            w += (
                (2 * k + 1)
                * (_gen_fact(2 * m, k) / _gen_fact(2 * m + k + 1, k + 1))
                * _gram_poly(i, m, k, 0)
                * _gram_poly(t, m, k, s)
            )
        weights[idx] = w
    return weights


# --- Functional smoother ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SGSmoother:
    """Static smoother spec: horizon steps, window half-width, poly order."""

    steps: int
    window: int
    order: int

    @property
    def buffer_length(self) -> int:
        return self.steps + 2 * self.window + 1

    def weights(self, dtype=np.float64) -> np.ndarray:
        return gram_weights(self.window, 0, self.order, 0).astype(dtype)

    def init_buffer(self, control_dof: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """The zero history buffer on ``device`` (the card unless the
        caller asks for the CPU)."""
        return torch.zeros((control_dof, self.buffer_length), dtype=dtype, device=torch.device(device))


@lru_cache(maxsize=None)
def _weights_tensor(smoother: SGSmoother, dtype, device) -> torch.Tensor:
    return torch.as_tensor(smoother.weights(), dtype=dtype).to(device)


def sg_trim(smoother: SGSmoother, buffer: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Align the history buffer with a horizon start ``shift`` steps ahead
    (MovingExtendedWindow::trim, filter.cpp:35-70): rotate the buffer left by
    ``shift`` slots and extend the tail with the last retained value.
    ``shift`` is an integer tensor in [0, steps]."""
    length = smoother.buffer_length
    shift = torch.clamp(shift, 0, smoother.steps)
    source = torch.clamp(torch.arange(length, device=buffer.device) + shift, max=length - 1)
    return buffer[:, source]


def sg_fill_horizon(
    smoother: SGSmoother, buffer: torch.Tensor, controls: torch.Tensor
) -> torch.Tensor:
    """Write the horizon controls into slots [w, w+steps) and extend the tail
    with the last control (add_measurement + extend, filter.cpp:72-116).

    controls: (steps, dof); buffer: (dof, L). Returns the filled buffer."""
    w = smoother.window
    horizon = controls.T  # (dof, steps)
    tail = horizon[:, -1:].expand(-1, w + 1)
    return torch.cat([buffer[:, :w], horizon, tail], dim=1)


def sg_apply_sequential(smoother: SGSmoother, buffer: torch.Tensor):
    """Filter the horizon slots in order. For step i the window [i, i+2w] is
    convolved with the Gram weights and the result is written back at slot
    w+i-1 (the reference's lower_bound-1 write-back, filter.cpp:104-110), so
    step i+1's window includes it: the plain version of ``sg_apply``.

    Returns (filtered (steps, dof), final buffer (dof, L))."""
    w = smoother.window
    weights = _weights_tensor(smoother, buffer.dtype, buffer.device)
    buffer = buffer.clone()
    filtered_steps = []
    for i in range(smoother.steps):
        filtered = buffer[:, i:i + 2 * w + 1] @ weights  # (dof,)
        buffer[:, max(w + i - 1, 0)] = filtered
        filtered_steps.append(filtered)
    return torch.stack(filtered_steps), buffer



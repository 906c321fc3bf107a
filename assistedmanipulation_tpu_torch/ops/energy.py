"""Energy-tank passivity primitive (port of
assistedmanipulation_tpu/ops/energy.py).

Reference: src/controller/energy.hpp:19-42. The tank integrates power, is
clamped non-negative, and exposes a tank "state" x = sqrt(2*E). The energy
is a value carried in the rollout state vector (State[30]); every function
is elementwise over any batch shape.
"""

from __future__ import annotations

import torch


def energy_tank_step(energy, power, dt):
    """E <- max(0, E + P*dt)."""
    return torch.clamp(energy + power * dt, min=0.0)


def energy_to_tank_state(energy):
    """x = sqrt(2*E) (reference energy.hpp:21)."""
    return torch.sqrt(2.0 * torch.clamp(energy, min=0.0))


def tank_state_to_energy(state):
    """E = x^2/2 (reference energy.hpp:40)."""
    return 0.5 * state * state

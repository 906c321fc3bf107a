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



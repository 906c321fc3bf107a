"""Dynamics backend factory (port of assistedmanipulation_tpu/models/factory.py;
SimulatorDynamics / ActorDynamics analog).

The reference selects the plant implementation at configuration time
(SimulatorDynamics::Configuration::Type, actor_dynamics.cpp:46-86). The JAX
package keeps two backends: ``analytic`` (CRBA mass matrix + RNEA,
models/dynamics.py) and ``lagrangian`` (autodiff Euler-Lagrange,
models/lagrangian.py). The port has the analytic one; asking for the
lagrangian one raises, and nothing falls back to the analytic one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import dynamics as dyn


class DynamicsBackend(NamedTuple):
    """Uniform plant-quantity interface over (model, fk, q, v)."""

    name: str
    # (model, fk, q) -> (..., 12, 12)
    mass_matrix: Callable
    # (model, fk, q, v, gravity) -> (..., 12)
    nonlinear_effects: Callable


ANALYTIC = DynamicsBackend(
    name="analytic",
    mass_matrix=lambda model, fk, q: dyn.mass_matrix(model, fk),
    nonlinear_effects=lambda model, fk, q, v, gravity: dyn.nonlinear_effects(model, fk, v, gravity),
)

_BACKENDS = {ANALYTIC.name: ANALYTIC}
# Backends of the JAX package that the port does not have yet.
_NOT_PORTED = {"lagrangian": "models/lagrangian.py"}


def create(dynamics_type: str) -> DynamicsBackend:
    """Select a dynamics backend by name (ActorDynamics::create,
    actor_dynamics.cpp:46-86 — unknown types are a configuration error)."""
    if dynamics_type in _NOT_PORTED:
        raise ValueError(
            f"dynamics model type {dynamics_type!r} needs {_NOT_PORTED[dynamics_type]}, "
            "which is not ported yet; the port has 'analytic'"
        )
    try:
        return _BACKENDS[dynamics_type]
    except KeyError:
        raise ValueError(
            f"unknown dynamics model type {dynamics_type!r}; expected one of {sorted(_BACKENDS)}"
        ) from None

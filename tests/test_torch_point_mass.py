"""The port's point-mass plants (assistedmanipulation_tpu_torch/models/
point_mass.py) against the JAX package's, at float64 on the CPU.

Both plants' ``derive``, ``cost`` and ``integrate`` on the same batch of
numpy-seeded states and controls: the port's over the batch at once, the
JAX package's vmapped over it; within 1e-12 x max(|jax|, 1). The obstacle
field's states include some inside the obstacle (the barrier's 1e10), on
its rim and beyond it, so both ``where`` guards of the barrier are taken.
The port's plant over one state (no batch dimension) gives the batch's row.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.models import point_mass as jax_point_mass
from assistedmanipulation_tpu_torch.models import point_mass
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-12
BATCH = 64


def close(port, want):
    port, want = port.numpy(), np.asarray(want)
    assert port.shape == want.shape, (port.shape, want.shape)
    assert (np.abs(port - want) <= TOL * np.maximum(np.abs(want), 1.0)).all(), float(np.abs(port - want).max())


def _states(plant_name, rng):
    if plant_name == "point_mass":
        return rng.standard_normal((BATCH, 4)) * 2.0, rng.standard_normal((BATCH, 2))
    x = rng.standard_normal((BATCH, 6))
    x[:8, :2] = 1.0 + rng.uniform(-0.2, 0.2, (8, 2))  # inside the r = 0.3 disc
    x[8, :2] = (1.0 + np.float32(0.3), 1.0)  # on its rim
    return x, rng.standard_normal((BATCH, 3))


PLANTS = {
    "point_mass": (
        lambda: point_mass.make_point_mass_plant(point_mass.PointMassConfig(dimensions=2, target=(0.5, -1.0))),
        lambda: jax_point_mass.make_point_mass_plant(jax_point_mass.PointMassConfig(dimensions=2, target=(0.5, -1.0))),
    ),
    "base_2d": (
        lambda: point_mass.make_base_2d_plant(point_mass.ObstacleField2DConfig()),
        lambda: jax_point_mass.make_base_2d_plant(jax_point_mass.ObstacleField2DConfig()),
    ),
}


@pytest.mark.parametrize("name", list(PLANTS))
def test_plant_matches_jax(name):
    port_plant, jax_plant = (make() for make in PLANTS[name])
    assert (port_plant.state_dof, port_plant.control_dof) == (jax_plant.state_dof, jax_plant.control_dof)
    x, u = _states(name, np.random.default_rng(11))
    t, dt = 0.25, 0.01
    xt, ut, tt = torch.tensor(x), torch.tensor(u), torch.tensor(t, dtype=torch.float64)

    aux = port_plant.derive(xt, tt)
    assert aux is None and jax_plant.derive(jnp.asarray(x[0]), t) is None
    cost = port_plant.cost(xt, ut, aux, tt)
    want_cost = jax.vmap(lambda a, b: jax_plant.cost(a, b, None, t))(jnp.asarray(x), jnp.asarray(u))
    close(cost, want_cost)
    close(port_plant.integrate(xt, ut, aux, tt, dt),
          jax.vmap(lambda a, b: jax_plant.integrate(a, b, None, t, dt))(jnp.asarray(x), jnp.asarray(u)))
    # One state without a batch dimension: the batch's row.
    assert torch.equal(port_plant.cost(xt[3], ut[3], None, tt), cost[3])
    if name == "base_2d":
        assert (cost[:8] >= 1e10).all() and (cost[9:] < 1e10).any()

"""The port's Lagrangian dynamics backend (models/lagrangian.py: autodiff
Euler-Lagrange through ``torch.func``) against the JAX package's, at
float64 on the CPU, and against the port's analytic CRBA/RNEA backend.

Seeded (q, v) as tests/test_lagrangian.py draws them. The JAX reference is
one jitted vmap over 4 states; the port is called on the batch of 4
(``torch.func.vmap`` inside) and on one state alone.

Tolerances, |port - ref| <= tol * max(|ref|, 1): 1e-10 against the JAX
backend (the same derivation), 1e-10 for M and 1e-9 for h against the
analytic backend (another algorithm: tests/test_lagrangian.py's bounds),
and for a plant step through each backend 1e-9 on the next state and 1e-8
on the joint power.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu.models import lagrangian as jax_lagrangian
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu_torch.models import dynamics as dyn
from assistedmanipulation_tpu_torch.models import factory
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models import kinematics as kin
from assistedmanipulation_tpu_torch.models import lagrangian
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model

GRAVITY = (0.0, 0.0, 9.81)
MODEL = frankaridgeback_model()


def states(count=4, seed=42):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, size=(count, 12))
    q[:, 10:] = rng.uniform(0.0, 0.04, size=(count, 2))
    v = rng.uniform(-1.0, 1.0, size=(count, 12))
    return q, v


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert (err <= tol * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


@pytest.fixture(scope="module")
def jax_reference():
    model = jax_model()
    q, v = states()

    def single(q, v):
        return (
            jax_lagrangian.mass_matrix(model, q),
            jax_lagrangian.nonlinear_effects(model, q, v, GRAVITY),
            jax_lagrangian.kinetic_energy(model, q, v),
            jax_lagrangian.potential_energy(model, q, GRAVITY),
        )

    return jax.device_get(jax.jit(jax.vmap(single))(jnp.asarray(q), jnp.asarray(v)))


@pytest.mark.parametrize("batch", [1, 4])
def test_lagrangian_matches_jax(jax_reference, batch):
    q, v = (torch.tensor(a) for a in states())
    if batch == 1:
        q, v = q[0], v[0]
        want = [field[0] for field in jax_reference]
    else:
        want = jax_reference
    got = (
        lagrangian.mass_matrix(MODEL, q),
        lagrangian.nonlinear_effects(MODEL, q, v, GRAVITY),
        lagrangian.kinetic_energy(MODEL, q, v),
        lagrangian.potential_energy(MODEL, q, GRAVITY),
    )
    for name, g, w in zip(("mass_matrix", "nonlinear_effects", "kinetic_energy", "potential_energy"), got, want):
        close(g, w, 1e-10, name)


def test_lagrangian_matches_the_analytic_backend():
    q, v = (torch.tensor(a) for a in states(5, seed=7))
    fk = kin.forward_kinematics(MODEL, q)
    close(lagrangian.mass_matrix(MODEL, q), dyn.mass_matrix(MODEL, fk), 1e-10, "mass_matrix")
    close(lagrangian.nonlinear_effects(MODEL, q, v, GRAVITY), dyn.nonlinear_effects(MODEL, fk, v, GRAVITY), 1e-9,
          "nonlinear_effects")
    assert float(lagrangian.kinetic_energy(MODEL, q[0], torch.zeros(12, dtype=torch.float64))) == 0.0


def test_factory_creates_the_lagrangian_backend():
    backend = factory.create("lagrangian")
    assert backend is factory.LAGRANGIAN and backend.name == "lagrangian"
    q, v = (torch.tensor(a) for a in states(2, seed=3))
    fk = kin.forward_kinematics(MODEL, q)
    analytic = factory.create("analytic")
    close(backend.mass_matrix(MODEL, fk, q), analytic.mass_matrix(MODEL, fk, q), 1e-10, "mass_matrix")
    close(backend.nonlinear_effects(MODEL, fk, q, v, GRAVITY), analytic.nonlinear_effects(MODEL, fk, q, v, GRAVITY),
          1e-9, "nonlinear_effects")
    with pytest.raises(ValueError, match="unknown dynamics model type"):
        factory.create("pinocchio")


def test_plant_step_through_either_backend():
    """One simulator step through make_plant_step is backend-invariant, and
    the mixed case (lagrangian plant, analytic rollouts) builds a plant."""
    rng = np.random.default_rng(11)
    step_a = fr.make_plant_step(fr.Configuration(dynamics_type="analytic"))
    step_b = fr.make_plant_step(fr.Configuration(dynamics_type="lagrangian"))
    x = torch.tensor(fr.make_state("reach"))
    u = torch.tensor(rng.uniform(-1.0, 1.0, size=12))
    wrench = torch.tensor(rng.uniform(-5.0, 5.0, size=6))
    xa, auxa = step_a(x, u, wrench, 0.005)
    xb, auxb = step_b(x, u, wrench, 0.005)
    close(xb, xa, 1e-9, "x_next")
    close(auxb.joint_power, auxa.joint_power, 1e-8, "joint_power")
    close(auxb.mass, auxa.mass, 1e-10, "aux.mass")
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation

    plant = fr.make_plant(
        AssistedManipulation(), fr.Configuration(dynamics_type="lagrangian", rollout_dynamics_type="analytic")
    )
    batch = x.expand(3, 31)
    close(plant.derive(batch, None).mass, step_a(x, u, wrench, 0.005)[1].mass.expand(3, 12, 12), 1e-12, "mixed")

"""The port's QP safety filter and what it stands on against the JAX
package, at float64 on the CPU: ops/linalg, ops/admm_qp, safety and the
planner's filtered re-rollout with write-back.

Tolerances (|port - jax| <= tol * max(|jax|, 1)): linalg 1e-12; the QP
solutions (x, z, y and both residuals) and the filter's controls 1e-8 —
the port runs the same ADMM iteration in another order (the pair (x, w)
through one affine map per step, ops/admm_qp.py), so the two agree to
rounding carried through 160 iterations; the planner's published control,
optimal cost and optimal rollout states 1e-8.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu import mppi as jax_mppi
from assistedmanipulation_tpu import safety as jax_safety
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.objectives.assisted_manipulation import AssistedManipulation as JaxObjective
from assistedmanipulation_tpu.ops import admm_qp as jax_qp
from assistedmanipulation_tpu.ops import linalg as jax_linalg
from assistedmanipulation_tpu_torch import mppi, safety
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import AssistedManipulation
from assistedmanipulation_tpu_torch.ops import admm_qp, linalg
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def close(port, want, tol, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want, dtype=np.float64)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    err = np.abs(port - want)
    assert (err <= tol * np.maximum(np.abs(want), 1.0)).all(), (what, float(err.max()))


def t(array):
    return torch.tensor(np.array(array, dtype=np.float64))


def _spd(rng, batch, n):
    W = rng.normal(size=(batch, n, n))
    return W @ W.transpose(0, 2, 1) + n * np.eye(n)


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    A, b, B = _spd(rng, 5, 12), rng.normal(size=(5, 12)), rng.normal(size=(5, 12, 7))
    L = linalg.cholesky_factor(t(A))
    jax_L = jax.vmap(jax_linalg.cholesky_factor)(jnp.asarray(A))
    want = np.zeros_like(A)
    for i in range(12):
        for j in range(i + 1):
            want[:, i, j] = np.asarray(jax_L[i][j])
    close(L, want, 1e-12, "cholesky_factor")
    want_x = jax.vmap(jax_linalg.cholesky_solve)(A, b)
    close(linalg.solve_factored(L, t(b)), want_x, 1e-12)
    close(linalg.cholesky_solve(t(A), t(b)), want_x, 1e-12)
    close(linalg.solve_matrix(L, t(B)),
          jax.vmap(lambda A, B: jax_linalg.solve_matrix(jax_linalg.cholesky_factor(A), B))(A, B), 1e-12)
    close(linalg.cholesky_inverse(L), np.linalg.inv(A), 1e-12)
    # Not positive definite: NaN, as JAX's factor gives.
    assert torch.isnan(linalg.cholesky_factor(-t(A[0]))).all()


def _qps(rng, batch, n=6, m=10, equalities=2):
    """Random convex QPs whose constraint set is feasible: two-sided rows
    around A x* with some boxes narrow enough to bind, and equality rows."""
    W = rng.normal(size=(batch, n, n))
    P = W @ W.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = 3.0 * rng.normal(size=(batch, n))
    A = rng.normal(size=(batch, m, n)) * rng.uniform(0.01, 10.0, size=(batch, m, 1))
    center = np.einsum("bmn,bn->bm", A, rng.normal(size=(batch, n)))
    l = center - rng.uniform(0.01, 0.5, size=(batch, m))
    u = center + rng.uniform(0.01, 0.5, size=(batch, m))
    l[:, :equalities] = u[:, :equalities] = center[:, :equalities]
    return P, q, A, l, u


def _check_solution(got, want, tol=1e-8):
    for name in admm_qp.QPSolution._fields:
        close(getattr(got, name), getattr(want, name), tol, name)


def test_solve_qp_matches_jax():
    rng = np.random.default_rng(1)
    P, q, A, l, u = _qps(rng, 4)
    x0 = rng.normal(size=q.shape)
    for kwargs in ({"iterations": 40}, {"iterations": 25, "rho": 0.1, "adaptive_blocks": 2}):
        got = admm_qp.solve_qp(t(P), t(q), t(A), t(l), t(u), x0=t(x0), **kwargs)
        want = jax.jit(jax.vmap(lambda *a: jax_qp.solve_qp(*a[:5], x0=a[5], **kwargs)))(P, q, A, l, u, x0)
        _check_solution(got, want)
        # Some box binds, and the equality rows hold.
        z = got.z.numpy()
        assert (np.isclose(z, l, atol=1e-6) | np.isclose(z, u, atol=1e-6))[:, 2:].any()
        np.testing.assert_allclose(z[:, :2], l[:, :2], atol=1e-5)


def test_project_box_affine_matches_jax():
    rng = np.random.default_rng(2)
    _, _, A, l, u = _qps(rng, 3, n=12, m=15, equalities=1)
    target = 5.0 * rng.normal(size=(3, 12))
    weights = rng.uniform(0.5, 2.0, size=(3, 12))
    got = admm_qp.project_box_affine(t(target), t(A), t(l), t(u), weights=t(weights), iterations=40)
    want = jax.jit(jax.vmap(lambda *a: jax_qp.project_box_affine(*a, iterations=40)))(target, A, l, u, weights)
    _check_solution(got, want)
    # Unbatched with the default (unit) weights: the batched solve's first row.
    single = admm_qp.project_box_affine(t(target[0]), t(A[0]), t(l[0]), t(u[0]), iterations=40)
    batched = admm_qp.project_box_affine(t(target), t(A), t(l), t(u), weights=torch.ones(3, 12, dtype=torch.float64),
                                         iterations=40)
    for name in admm_qp.QPSolution._fields:
        close(getattr(single, name), getattr(batched, name)[0].numpy(), 1e-8, f"unbatched {name}")


def _binding_cases():
    """(safety configuration, state, control) where the named limit binds:
    the filter moves the control. The default filter, all four limits at
    once, runs in the planner tests here and in
    tests/test_torch_plant_planner.py."""
    slam = np.array([0.5, 0.5, 1.0, 87, 87, 87, 87, 12, 12, 12, 0, 0], dtype=np.float64)
    huddled = fr.make_state("huddled")
    near_joint = huddled.copy()
    near_joint[6] = -0.001  # panda joint 4 just under its 0.0 upper bound...
    near_joint[18] = 0.5  # ...and moving towards it
    reach = fr.make_state("reach")
    only = {name: False for name in ("limit_joints", "limit_velocity", "limit_acceleration", "limit_reach")}
    return {
        "velocity": ({**only, "limit_velocity": True}, huddled, slam),
        "acceleration": ({**only, "limit_acceleration": True}, huddled, slam),
        "joints": ({**only, "limit_joints": True}, near_joint, np.zeros(12)),
        "reach": ({**only, "limit_reach": True}, reach, np.zeros(12)),
    }


@pytest.mark.parametrize("case", list(_binding_cases()))
def test_safety_filter_matches_jax(case):
    options, x, u = _binding_cases()[case]
    port_filter = safety.make_safety_filter(safety.Configuration(**options))
    jax_filter = jax_safety.make_safety_filter(jax_safety.Configuration(**options))
    got = port_filter(t(x), t(u), 0.0)
    close(got, jax.jit(jax_filter)(jnp.asarray(x), jnp.asarray(u), 0.0), 1e-8, case)
    assert np.abs(got.numpy() - u).max() > 1e-4, "the limit does not bind"
    # A batch of states gives each state's filtered control.
    batch = port_filter(t(np.stack([x, fr.make_state("huddled")])), t(np.stack([u, u])), 0.0)
    close(batch[0], got.numpy(), 1e-12, f"{case} batched")


def test_planner_writeback_matches_jax():
    """A plant planner with the filter attached (the counterpart of JAX
    tests/test_safety.py::test_planner_writeback): 3 updates fed the same
    noise_override; the published (filtered) control, the optimal cost and
    the optimal rollout states agree, and the first control's next velocity
    respects the velocity limit."""
    steps = 5
    configuration = dict(
        rollouts=6, keep_best_rollouts=2, time_step=0.01, horizon=steps * 0.01,
        covariance=fr.DEFAULT_COVARIANCE, control_min=fr.DEFAULT_CONTROL_MIN,
        control_max=fr.DEFAULT_CONTROL_MAX, control_default=np.zeros(12), dtype="float64",
    )
    filter_cfg = dict(iterations=60)
    jax_planner = jax_mppi.Planner(
        jax_mppi.Configuration(**configuration), jax_fr.make_plant(JaxObjective(), jax_fr.Configuration()),
        filter_fn=jax_safety.make_safety_filter(jax_safety.Configuration(**filter_cfg)),
    )
    planner = mppi.Planner(
        mppi.Configuration(**configuration), fr.make_plant(AssistedManipulation(), fr.Configuration()),
        device="cpu", filter_fn=safety.make_safety_filter(safety.Configuration(**filter_cfg)),
    )
    x0 = fr.make_state("huddled")
    rng = np.random.default_rng(4)
    jax_state, state = jax_planner.init(seed=0), planner.init(seed=0)
    for time in (0.0, 0.01, 0.03):
        override = rng.standard_normal((6, steps, 12)) * np.sqrt(fr.DEFAULT_COVARIANCE)
        jax_state, jax_info = jax_planner.update(jax_state, x0, time, noise_override=override)
        state, info = planner.update(state, x0, time, noise_override=override)
        close(state.optimal_control, jax_state.optimal_control, 1e-8, "optimal_control")
        close(state.optimal_cost, jax_state.optimal_cost, 1e-8, "optimal_cost")
        close(info.optimal_rollout_states, jax_info.optimal_rollout_states, 1e-8, "optimal states")
        np.testing.assert_array_equal(state.costs.numpy()[:, 0], np.asarray(jax_state.costs)[:, 0])
    step = fr.make_plant_step()
    x1, _ = step(t(x0), state.optimal_control[0], torch.zeros(6, dtype=torch.float64), 0.01)
    assert (np.abs(x1[fr.VELOCITY].numpy()) <= safety.DEFAULT_VELOCITY_LIMIT + 5e-3).all()


def test_planner_refuses_a_filter_without_a_plant():
    from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

    flagship = build_flagship(rollouts=6, steps=3, device="cpu")
    with pytest.raises(ValueError, match="pass plant="):
        mppi.Planner(flagship.planner.configuration, flagship.planner.sampler, 12, device="cpu",
                     filter_fn=safety.make_safety_filter())
    with pytest.raises(ValueError, match="noise_override"):
        flagship.update(flagship.init(), flagship.x0, 0.0, noise_override=np.zeros((6, 3, 12)))

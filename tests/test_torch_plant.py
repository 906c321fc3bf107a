"""The port's robot plant, objectives and their building blocks against the
JAX package, at float64 on the CPU: ops/rotations, ops/energy, ops/costs,
models/kinematics, models/dynamics, models/factory, models/frankaridgeback
(RobotAux, the integrate step with its extras, make_plant and
make_plant_step with the jvp accelerations), objectives/assisted_manipulation
and objectives/track_point.

The port's functions take a batch of states at once; the JAX ones take one
state and are vmapped here. States: the huddled, joint_limit and
self_collision presets, seeded random states inside and outside the joint
limits, and a state with a NaN joint (its costs are NaN). Tolerance:
|port - jax| <= 1e-10 * max(|jax|, 1) elementwise, NaN where JAX has NaN.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.models import dynamics as jax_dyn
from assistedmanipulation_tpu.models import factory as jax_factory
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models import kinematics as jax_kin
from assistedmanipulation_tpu.models.model_data import frankaridgeback_model as jax_model
from assistedmanipulation_tpu.objectives import assisted_manipulation as jax_am
from assistedmanipulation_tpu.objectives import track_point as jax_tp
from assistedmanipulation_tpu.ops import costs as jax_costs
from assistedmanipulation_tpu.ops import energy as jax_energy
from assistedmanipulation_tpu.ops import rotations as jax_rot
from assistedmanipulation_tpu_torch.forecast import kalman
from assistedmanipulation_tpu_torch.models import dynamics as dyn
from assistedmanipulation_tpu_torch.models import factory
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models import kinematics as kin
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives import assisted_manipulation as am
from assistedmanipulation_tpu_torch.objectives import track_point as tp
from assistedmanipulation_tpu_torch.ops import costs, energy, precision
from assistedmanipulation_tpu_torch.ops import rotations as rot
from assistedmanipulation_tpu_torch.safety import make_safety_filter
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TOL = 1e-10
MODEL = frankaridgeback_model()
JAX_MODEL = jax_model()


def close(port, want, tol=TOL, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(want, dtype=np.float64)
    assert port.shape == want.shape, (what, port.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(port), nan, err_msg=f"{what}: NaN positions")
    bound = tol * np.maximum(np.abs(want[~nan]), 1.0)
    err = np.abs(port[~nan] - want[~nan])
    assert (err <= bound).all(), (what, float(err.max()) if err.size else 0.0)


def t(array):
    return torch.tensor(np.array(array, dtype=np.float64))


def _states():
    """(N, 31) states: three presets, random ones inside and outside the
    joint limits with velocities and energy, and one with a NaN joint."""
    rng = np.random.default_rng(8)
    lower = np.array([-2.0, -2.0, -3.0, -2.8, -1.7, -2.8, -3.0, -2.7, 0.4, -2.9, 0.0, 0.0])
    upper = np.array([2.0, 2.0, 3.0, 2.8, 1.7, 2.8, -0.1, 2.7, 4.5, 2.9, 0.04, 0.04])
    states = [fr.make_state(name) for name in ("huddled", "joint_limit", "self_collision")]
    for k in range(5):
        x = np.zeros(31)
        x[:12] = rng.uniform(lower, upper)
        x[12:24] = rng.normal(0.0, 0.5, 12)
        x[24:30] = rng.normal(0.0, 3.0, 6)
        x[30] = rng.uniform(0.0, 30.0)
        states.append(x)
    outside = states[3].copy()
    outside[:12] = upper + rng.uniform(0.05, 0.5, 12)
    states.append(outside)
    poisoned = fr.make_state("huddled")
    poisoned[5] = np.nan
    states.append(poisoned)
    return np.stack(states)


STATES = _states()
CONTROLS = np.random.default_rng(9).normal(0.0, 1.0, (len(STATES), 12)) * np.sqrt(
    fr.DEFAULT_COVARIANCE + 1e-3
)
WRENCHES = np.random.default_rng(10).normal(0.0, 5.0, (len(STATES), 6))


def jvmap(fn, *args):
    return jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args))


# --- ops --------------------------------------------------------------------


def _rotation_calls(r, axis, q, q2, v, v_reversed, angles, tt, matrices, euler, euler_reversed, asarray):
    """Every rotation function of module ``r`` on the same inputs."""
    q, q2, v, v_reversed, angles, tt, matrices, euler, euler_reversed = map(
        asarray, (q, q2, v, v_reversed, angles, tt, matrices, euler, euler_reversed)
    )
    return (
        r.quat_multiply(q, q2), r.quat_conjugate(q), r.quat_rotate(q, v),
        r.quat_from_axis_angle(axis, angles), r.quat_to_matrix(q), r.matrix_to_quat(matrices),
        r.euler_zxz_to_quat(euler), r.quat_to_euler_zxz(q), r.quat_slerp(q, q2, tt),
        r.quat_slerp(q[0], q[1], tt), r.quat_slerp(q, q, 0.3), r.quat_from_two_vectors(v, v_reversed),
        r.quat_from_two_vectors(v, -v), r.euler_difference(euler, euler_reversed * 3),
    )


def test_rotations_match_jax():
    rng = np.random.default_rng(1)
    q, q2 = (rng.normal(size=(9, 4)) for _ in range(2))
    q, q2 = (a / np.linalg.norm(a, axis=-1, keepdims=True) for a in (q, q2))
    v = rng.normal(size=(9, 3))
    angles, axis, tt = rng.uniform(-3, 3, 9), rng.normal(size=3), rng.uniform(0, 1, 9)
    # Rotation matrices, and one for each Shepperd branch: the identity and
    # rotations by pi about x, y, z.
    matrices = np.concatenate([
        np.asarray(jax_rot.quat_to_matrix(jnp.asarray(q))),
        np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]),
    ])
    euler = rng.uniform(-3, 3, (9, 3))
    args = (q, q2, v, v[::-1].copy(), angles, tt, matrices, euler, euler[::-1].copy())
    port = _rotation_calls(rot, axis, *args, asarray=t)
    want = jax.jit(lambda *a: _rotation_calls(jax_rot, axis, *a, asarray=jnp.asarray))(*args)
    for k, (got, ref) in enumerate(zip(port, want)):
        close(got, ref, what=f"call {k}")


def test_slerp_takes_a_pre_broadcast_t():
    """A t that already carries the component axis, (N, 1), gives the same
    (N, 4) as the (N,) batch; the JAX version returns (N, N, 4) there."""
    rng = np.random.default_rng(2)
    q0, q1 = (rng.normal(size=(5, 4)) for _ in range(2))
    q0, q1 = (q / np.linalg.norm(q, axis=-1, keepdims=True) for q in (q0, q1))
    tt = rng.uniform(0, 1, 5)
    flat = rot.quat_slerp(t(q0), t(q1), t(tt))
    assert flat.shape == (5, 4)
    torch.testing.assert_close(rot.quat_slerp(t(q0), t(q1), t(tt[:, None])), flat, rtol=0, atol=0)
    # Single endpoints, a pre-broadcast time batch.
    single = rot.quat_slerp(t(q0[0]), t(q1[0]), t(tt[:, None]))
    assert single.shape == (5, 4)
    torch.testing.assert_close(single, rot.quat_slerp(t(q0[0]), t(q1[0]), t(tt)), rtol=0, atol=0)
    assert jax_rot.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(tt[:, None])).shape == (5, 5, 4)


def test_energy_matches_jax():
    e = np.array([-1.0, 0.0, 2.5, 40.0, np.nan])
    p = np.array([3.0, -2.0, -400.0, 1.0, 0.0])
    close(energy.energy_tank_step(t(e), t(p), 0.01), jax_energy.energy_tank_step(e, p, 0.01))
    close(energy.energy_to_tank_state(t(e)), jax_energy.energy_to_tank_state(jnp.asarray(e)))
    close(energy.tank_state_to_energy(t(e)), jax_energy.tank_state_to_energy(jnp.asarray(e)))


@pytest.mark.parametrize("name", ["RightInverseBarrier", "LeftInverseBarrier", "UpperLogBarrier", "LowerLogBarrier"])
def test_barriers_match_jax(name):
    """Scalar and per-element (array) bounds; values inside, on, past the
    bound, where the 1/gap clamp bites, and NaN."""
    values = np.array([-3.0, -1.0, -1e-11, 0.0, 1e-11, 0.3, 1.0, 2.0, np.nan, 5.0])
    arrays = (np.linspace(-1.0, 1.0, 10), np.linspace(0.5, 3.0, 10))
    for args in ((0.0, 2.0), (1.0, 0.0), arrays):
        kwargs = {"offset": 0.5} if "Log" in name else {}
        port = getattr(costs, name)(*args, **kwargs)
        want = getattr(jax_costs, name)(*args, **kwargs)
        close(port(t(values)), want(jnp.asarray(values)), what=name)
        for got, ref in zip(port.decomposed(t(values)), want.decomposed(jnp.asarray(values))):
            close(got, ref, what=f"{name}.decomposed")


def test_quadratic_cost_matches_jax():
    values = np.array([-3.0, 0.0, 0.5, np.nan])
    close(costs.QuadraticCost(1.0, 2.0, 3.0)(t(values)), jax_costs.QuadraticCost(1.0, 2.0, 3.0)(values))
    assert costs.MAXIMUM_COST_DEFAULT == jax_costs.MAXIMUM_COST_DEFAULT


def test_precision_check_raises_under_tf32():
    """Every user of the shared check — the Kalman filter, the plant, the
    safety filter — raises when float32 matmuls may run in TF32."""
    spec = kalman.KalmanSpec(np.eye(2), 1e-8 * np.eye(2), np.eye(2), 1e-8 * np.eye(2))
    ks = kalman.kalman_init(spec, torch.zeros(2, dtype=torch.float64), torch.eye(2, dtype=torch.float64))
    x = t(STATES[:2])
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for call in (
            precision.check_f32_matmuls,
            lambda: kalman.kalman_update(spec, ks, torch.zeros(2, dtype=torch.float64)),
            lambda: fr.derive_aux(MODEL, x),
            lambda: make_safety_filter()(x, t(CONTROLS[:2]), 0.0),
        ):
            with pytest.raises(RuntimeError, match="allow_tf32"):
                call()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    precision.check_f32_matmuls()


# --- kinematics and dynamics ------------------------------------------------


def _jax_fk(q):
    return jvmap(lambda q: jax_kin.forward_kinematics(JAX_MODEL, q), q)


def test_kinematics_match_jax():
    q = STATES[:, :12]
    fk, want = kin.forward_kinematics(MODEL, t(q)), _jax_fk(q)
    for name in fk._fields:
        close(getattr(fk, name), getattr(want, name), what=name)

    def jax_queries(q):
        fk = jax_kin.forward_kinematics(JAX_MODEL, q)
        R, p = jax_kin.frame_transform(JAX_MODEL, fk, "panda_grasp_joint")
        Rl, pl = jax_kin.link_transform(JAX_MODEL, fk, "panda_link4")
        return (R, p, Rl, pl, jax_kin.link_positions(JAX_MODEL, fk, fr.COLLISION_LINKS),
                jax_kin.point_jacobian(JAX_MODEL, fk, p, body=9),
                jax_kin.angular_jacobian(JAX_MODEL, fk, body=9), jax_kin.com_positions(JAX_MODEL, fk),
                jax_kin.frame_transform(JAX_MODEL, fk, "world_joint")[1])

    R, p = kin.frame_transform(MODEL, fk, "panda_grasp_joint")
    Rl, pl = kin.link_transform(MODEL, fk, "panda_link4")
    port = (R, p, Rl, pl, kin.link_positions(MODEL, fk, fr.COLLISION_LINKS),
            kin.point_jacobian(MODEL, fk, p, body=9), kin.angular_jacobian(MODEL, fk, body=9),
            kin.com_positions(MODEL, fk), kin.frame_transform(MODEL, fk, "world_joint")[1])
    for k, (got, ref) in enumerate(zip(port, jvmap(jax_queries, q))):
        close(got, ref, what=f"query {k}")


def test_dynamics_match_jax():
    q, v = STATES[:, :12], STATES[:, 12:24]
    qdd = np.random.default_rng(3).normal(size=q.shape)
    gravity = (0.0, 0.0, 9.81)
    fk = kin.forward_kinematics(MODEL, t(q))

    def jax_all(q, v, qdd):
        fk = jax_kin.forward_kinematics(JAX_MODEL, q)
        M = jax_dyn.mass_matrix(JAX_MODEL, fk)
        kd = jnp.asarray(fr.DEFAULT_DIFFERENTIAL_GAIN) + jax_dyn.friction_coefficients(JAX_MODEL, v)
        return (jax_dyn.motion_subspaces(JAX_MODEL, fk), jax_dyn.spatial_inertias(JAX_MODEL, fk), M,
                jax_dyn.rnea(JAX_MODEL, fk, v, qdd, gravity), jax_dyn.nonlinear_effects(JAX_MODEL, fk, v, gravity),
                jax_dyn.kinetic_energy(JAX_MODEL, fk, v), jax_dyn.friction_coefficients(JAX_MODEL, v),
                jax_dyn.forward_dynamics(M, qdd, kd, 0.01))

    M = dyn.mass_matrix(MODEL, fk)
    kd = t(fr.DEFAULT_DIFFERENTIAL_GAIN) + dyn.friction_coefficients(MODEL, t(v))
    port = (dyn.motion_subspaces(MODEL, fk), dyn.spatial_inertias(MODEL, fk), M,
            dyn.rnea(MODEL, fk, t(v), t(qdd), gravity), dyn.nonlinear_effects(MODEL, fk, t(v), gravity),
            dyn.kinetic_energy(MODEL, fk, t(v)), dyn.friction_coefficients(MODEL, t(v)),
            dyn.forward_dynamics(M, t(qdd), kd, 0.01))
    names = ("motion_subspaces", "spatial_inertias", "mass_matrix", "rnea", "nonlinear_effects",
             "kinetic_energy", "friction_coefficients", "forward_dynamics")
    for name, got, ref in zip(names, port, jvmap(jax_all, q, v, qdd)):
        close(got, ref, what=name)


def test_factory_has_the_analytic_backend_only():
    backend = factory.create("analytic")
    fk = kin.forward_kinematics(MODEL, t(STATES[:3, :12]))
    torch.testing.assert_close(backend.mass_matrix(MODEL, fk, None), dyn.mass_matrix(MODEL, fk), rtol=0, atol=0)
    assert jax_factory.create("analytic").name == backend.name
    # The lagrangian backend is ported too (tests/test_torch_lagrangian.py
    # holds it to the JAX one); unknown names still raise.
    assert factory.create("lagrangian").name == jax_factory.create("lagrangian").name
    with pytest.raises(ValueError, match="unknown dynamics model type"):
        factory.create("pinocchio")
    with pytest.raises(ValueError, match="unknown dynamics model type"):
        fr.make_plant(am.AssistedManipulation(), fr.Configuration(dynamics_type="pinocchio"))


# --- the plant --------------------------------------------------------------


def test_derive_aux_matches_jax():
    aux = fr.derive_aux(MODEL, t(STATES))
    want = jvmap(lambda x: jax_fr.derive_aux(JAX_MODEL, x), STATES)
    for name in aux._fields:
        if name == "fk":
            for field in aux.fk._fields:
                close(getattr(aux.fk, field), getattr(want.fk, field), what=f"fk.{field}")
        else:
            close(getattr(aux, name), getattr(want, name), what=name)


def test_integrate_and_plant_step_match_jax():
    kp, kd = fr.DEFAULT_PROPORTIONAL_GAIN, fr.DEFAULT_DIFFERENTIAL_GAIN
    x, u, w = t(STATES), t(CONTROLS), t(WRENCHES)
    aux = fr.derive_aux(MODEL, x)
    port = fr.integrate_with_wrench_extras(MODEL, t(kp), t(kd), x, u, aux, w, 0.01)

    def jax_extras(x, u, w):
        aux = jax_fr.derive_aux(JAX_MODEL, x)
        return jax_fr.integrate_with_wrench_extras(JAX_MODEL, jnp.asarray(kp), jnp.asarray(kd), x, u, aux, w, 0.01)

    for name, got, ref in zip(("x_next", "qdd", "tau"), port, jvmap(jax_extras, STATES, CONTROLS, WRENCHES)):
        close(got, ref, what=name)
    close(fr.wrench_generalized_force(MODEL, aux, w),
          jvmap(lambda x, w: jax_fr.wrench_generalized_force(JAX_MODEL, jax_fr.derive_aux(JAX_MODEL, x), w),
                STATES, WRENCHES))

    # make_plant_step: the next state and the pre-step aux with the jvp
    # accelerations and the joint power of the step.
    x_next, step_aux = fr.make_plant_step()(x, u, w, 0.005)
    jax_step = jax_fr.make_plant_step()
    want_next, want_aux = jvmap(lambda x, u, w: jax_step(x, u, w, 0.005), STATES, CONTROLS, WRENCHES)
    close(x_next, want_next, what="plant step x_next")
    for name in ("ee_linear_acceleration", "ee_angular_acceleration", "joint_power", "ee_position", "mass"):
        close(getattr(step_aux, name), getattr(want_aux, name), what=name)

    # make_plant: the rollout plant (no wrench acts).
    plant, jax_plant = fr.make_plant(am.AssistedManipulation()), jax_fr.make_plant(jax_am.AssistedManipulation())
    got = plant.integrate(x, u, plant.derive(x, 0.0), 0.0, 0.01)
    want = jvmap(lambda x, u: jax_plant.integrate(x, u, jax_plant.derive(x, 0.0), 0.0, 0.01), STATES, CONTROLS)
    close(got, want, what="make_plant integrate")


def _contexts():
    wrench = np.zeros((11, 6))
    wrench[:, 0] = 20.0
    wrench[:, 1] = np.linspace(-4.0, 6.0, 11)
    wrench[:, 2] = np.linspace(0.0, -6.0, 11)
    port = am.ForecastContext(t(wrench), torch.tensor(0.0, dtype=torch.float64), 0.01, 0.095)
    want = jax_am.ForecastContext(jnp.asarray(wrench), jnp.asarray(0.0), 0.01, 0.095)
    return port, want


@pytest.mark.parametrize("configuration", [{}, {"enable_energy_limit": True}])
def test_assisted_manipulation_matches_jax(configuration):
    """Every term's two channels, the composed terms and the (2,) total,
    with a forecast wrench read inside and beyond its horizon (each state
    at the times 0, 0.037 and 0.2 s), and without a forecast; the default
    terms and every term (the energy barriers are off by default)."""
    ctx, jax_ctx = _contexts()
    times = np.repeat([0.0, 0.037, 0.2], len(STATES))
    states, controls = np.tile(STATES, (3, 1)), np.tile(CONTROLS, (3, 1))
    x, u = t(states), t(controls)
    aux = fr.derive_aux(MODEL, x)
    objective = am.AssistedManipulation(am.Configuration(**configuration))
    jax_objective = jax_am.AssistedManipulation(jax_am.Configuration(**configuration))
    for c, jc in ((ctx, jax_ctx), (None, None)):
        def jax_terms(x, u, time):
            aux = jax_fr.derive_aux(JAX_MODEL, x)
            return (jax_objective.channel_terms(x, u, aux, time, jc), jax_objective.terms(x, u, aux, time, jc),
                    jax_objective(x, u, aux, time, jc))

        want_channels, want_terms, want_total = jvmap(jax_terms, states, controls, times)
        channels = objective.channel_terms(x, u, aux, t(times), c)
        terms = objective.terms(x, u, aux, t(times), c)
        assert list(channels) == list(am.AssistedManipulation.TERM_NAMES)
        assert sorted(channels) == sorted(want_channels)
        for name in channels:
            for k in range(2):
                close(channels[name][k], want_channels[name][k], what=f"{name}[{k}]")
            close(terms[name], want_terms[name], what=f"terms {name}")
        total = objective(x, u, aux, t(times), c)
        close(total, want_total, what="total")
        # The state with a NaN joint poisons its cost.
        assert np.isnan(total[len(STATES) - 1].numpy()).all()


def test_assisted_manipulation_reads_an_ensemble_at_its_nominal_scenario():
    ctx, jax_ctx = _contexts()
    ensemble = ctx._replace(wrench_horizon=torch.stack([ctx.wrench_horizon, 2 * ctx.wrench_horizon]))
    x, u = t(STATES[:4]), t(CONTROLS[:4])
    aux = fr.derive_aux(MODEL, x)
    objective = am.AssistedManipulation()
    torch.testing.assert_close(objective(x, u, aux, 0.03, ensemble), objective(x, u, aux, 0.03, ctx), rtol=0, atol=0)


def test_track_point_matches_jax():
    x, u = t(STATES), t(CONTROLS)
    aux = fr.derive_aux(MODEL, x)
    objective, jax_objective = tp.TrackPoint(), jax_tp.TrackPoint()

    def jax_terms(x, u):
        aux = jax_fr.derive_aux(JAX_MODEL, x)
        return jax_objective.channel_terms(x, u, aux, 0.0), jax_objective.terms(x, u, aux, 0.0), jax_objective(x, u, aux, 0.0)

    want_channels, want_terms, want_total = jvmap(jax_terms, STATES, CONTROLS)
    channels, terms = objective.channel_terms(x, u, aux, 0.0), objective.terms(x, u, aux, 0.0)
    for name in want_channels:
        for k in range(2):
            close(channels[name][k], want_channels[name][k], what=f"{name}[{k}]")
        close(terms[name], want_terms[name], what=f"terms {name}")
    close(objective(x, u, aux, 0.0), want_total, what="total")

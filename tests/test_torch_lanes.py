"""The port's per-step rollout body against the JAX lanes path at float64.

Same inputs, made from a numpy seed, go through
assistedmanipulation_tpu.kernels.lane_rollout / lanes and their PyTorch
ports. Both follow one operation order, so at float64 violations agree
exactly and everything else to rtol 1e-9 (libm sin/cos/exp may differ in
the last ulp between XLA and PyTorch).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu.kernels import lane_rollout as jax_lane_rollout
from assistedmanipulation_tpu.kernels import lanes as jax_lanes
from assistedmanipulation_tpu.models import frankaridgeback as jax_fr
from assistedmanipulation_tpu.models.model_data import (
    frankaridgeback_model as jax_model,
)
from assistedmanipulation_tpu.objectives.assisted_manipulation import (
    Configuration as JaxObjectiveConfiguration,
    ForecastContext as JaxForecastContext,
)
from assistedmanipulation_tpu_torch.kernels import lane_rollout, lanes
from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import (
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)

T = 48
DT = 0.01
RTOL = 1e-9


def _rows(case: str, seed: int = 0):
    """(q, v, u) (12, T) float64 lanes for a named family of rows."""
    rng = np.random.default_rng(seed)
    cfg = ObjectiveConfiguration()
    preset = {"random": "huddled", "self_collision": "self_collision",
              "joint_limit": "joint_limit", "outside": "huddled",
              "saturated": "huddled"}[case]
    q = fr.PRESETS[preset][:, None] + rng.normal(0.0, 0.05, (12, T))
    if case == "random":
        q = fr.PRESETS["huddled"][:, None] + rng.normal(0.0, 0.6, (12, T))
    lower = np.array([b for b, _ in cfg.lower_joint_limit])
    upper = np.array([b for b, _ in cfg.upper_joint_limit])
    if case == "outside":
        # Half the rows pushed past a lower limit, half past an upper one.
        j = rng.integers(0, 12, T)
        past = rng.uniform(0.01, 0.5, T)
        half = np.arange(T) < T // 2
        q[j[half], np.arange(T)[half]] = lower[j[half]] - past[half]
        q[j[~half], np.arange(T)[~half]] = upper[j[~half]] + past[~half]
    if case == "saturated":
        # Gaps so small that scale / gap passes the 1e10 barrier maximum.
        j = 3 + np.arange(T) % 7
        gap = rng.uniform(1e-13, 5e-10, T)
        side = np.arange(T) % 2 == 0
        q[j[side], np.arange(T)[side]] = lower[j[side]] + gap[side]
        q[j[~side], np.arange(T)[~side]] = upper[j[~side]] - gap[~side]
    v = rng.normal(0.0, 0.4, (12, T))
    u = rng.normal(0.0, 2.5, (12, T))
    return q, v, u


def _jax_step(q, v, u, energy, traj):
    _, kp, kd = jax_fr.Configuration().resolve()
    return jax_lane_rollout.step_cost_and_dynamics(
        jax_model(), JaxObjectiveConfiguration(), kp, kd,
        [jnp.asarray(x) for x in q], [jnp.asarray(x) for x in v],
        [jnp.asarray(x) for x in u], jnp.asarray(energy),
        [jnp.asarray(x) for x in traj[0]], *[jnp.asarray(x) for x in traj[1:]], DT,
    )


def _torch_step(q, v, u, energy, traj):
    _, kp, kd = fr.Configuration().resolve()
    return lane_rollout.step_cost_and_dynamics(
        frankaridgeback_model(), ObjectiveConfiguration(), kp, kd,
        [torch.tensor(x) for x in q], [torch.tensor(x) for x in v],
        [torch.tensor(x) for x in u], torch.tensor(energy),
        [torch.tensor(x) for x in traj[0]], *[torch.tensor(x) for x in traj[1:]], DT,
    )


@pytest.mark.parametrize("case", ["random", "outside", "saturated", "self_collision", "joint_limit"])
def test_step_cost_and_dynamics_matches_jax_f64(case):
    q, v, u = _rows(case)
    energy = np.full(T, 100.0)
    traj = (np.array([0.2, -0.05, 0.0]), 0.04 / 1.0525, 120.0, 0.5)
    got = _torch_step(q, v, u, energy, traj)
    want = _jax_step(q, v, u, energy, traj)

    viol, smooth = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(viol, np.asarray(want[0]))
    np.testing.assert_allclose(smooth, np.asarray(want[1]), rtol=RTOL)
    np.testing.assert_allclose(
        torch.stack(got[2]).numpy(), np.stack([np.asarray(x) for x in want[2]]),
        rtol=RTOL, atol=1e-12,
    )
    np.testing.assert_allclose(
        torch.stack(got[3]).numpy(), np.stack([np.asarray(x) for x in want[3]]),
        rtol=RTOL, atol=1e-12,
    )
    if case == "outside":
        assert (viol >= 1).all()  # every row is past a limit
    if case == "saturated":
        assert (viol >= 1).all()  # the tiny gaps saturate their barrier
    assert np.isfinite(smooth).all()


def test_barrier_rows_cover_every_branch():
    """The rows above reach each barrier branch: inside (smooth scale/gap),
    outside (quadratic), and saturated (violation, no smooth)."""
    gap = torch.tensor([0.5, -0.2, 1e-12, 0.0], dtype=torch.float64)
    violations, smooth = lane_rollout._barrier(gap, 10.0)
    np.testing.assert_array_equal(violations.numpy(), [0.0, 1.0, 1.0, 1.0])
    np.testing.assert_array_equal(smooth.numpy(), [20.0, 10.0 * 0.04, 0.0, 0.0])
    want_v, want_s = jax_lane_rollout._barrier_left(jnp.asarray(gap.numpy()), 0.0, 10.0)
    np.testing.assert_array_equal(violations.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(smooth.numpy(), np.asarray(want_s))


def test_acos_matches_jax_over_domain():
    x = np.concatenate([np.linspace(-1.0, 1.0, 2001), [-0.5, 0.5, -1.0, 1.0, 0.0]])
    got = lanes.acos(torch.tensor(x)).numpy()
    want = np.asarray(jax_lanes.acos(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
    # The Cephes polynomial is a float32-accurate arccos.
    np.testing.assert_allclose(got, np.arccos(x), atol=2e-7)


def test_lane_helpers_match_jax_f64():
    """lane_fk, lane_frame, lane_point_jacobian, lane_mass_matrix and
    lane_cholesky_solve one by one."""
    q, v, _ = _rows("random", seed=3)
    tq = [torch.tensor(x) for x in q]
    jq = [jnp.asarray(x) for x in q]
    model, jmodel = frankaridgeback_model(), jax_model()
    fk, jfk = lanes.lane_fk(model, tq), jax_lanes.lane_fk(jmodel, jq)
    like, jlike = tq[0], jq[0]

    def torch_values(graph):
        return np.stack([lanes.materialize(c, like).numpy() for c in graph])

    def jax_values(graph):
        return np.stack([np.asarray(jax_lanes.materialize(c, jlike)) for c in graph])

    for i in range(12):
        for a in range(3):
            np.testing.assert_allclose(
                torch_values(fk.rotation[i][a]), jax_values(jfk.rotation[i][a]), rtol=RTOL, atol=1e-14
            )
        np.testing.assert_allclose(torch_values(fk.origin[i]), jax_values(jfk.origin[i]), rtol=RTOL, atol=1e-14)
    _, p_ee = lanes.lane_frame(model, fk, model.frames, model.end_effector_frame)
    _, jp_ee = jax_lanes.lane_frame(jmodel, jfk, jmodel.frames, jmodel.end_effector_frame)
    np.testing.assert_allclose(torch_values(p_ee), jax_values(jp_ee), rtol=RTOL)
    J = lanes.lane_point_jacobian(model, fk, [lanes.materialize(c, like) for c in p_ee], fr.EE_BODY)
    jJ = jax_lanes.lane_point_jacobian(jmodel, jfk, [jax_lanes.materialize(c, jlike) for c in jp_ee], fr.EE_BODY)
    for i in range(12):
        np.testing.assert_allclose(torch_values(J[i]), jax_values(jJ[i]), rtol=RTOL, atol=1e-14)
    M = lanes.lane_mass_matrix(model, fk)
    jM = jax_lanes.lane_mass_matrix(jmodel, jfk)
    for i in range(12):
        np.testing.assert_allclose(torch_values(M[i]), jax_values(jM[i]), rtol=RTOL, atol=1e-12)
    for i in range(12):
        M[i][i] = lanes.add(M[i][i], 10.0)
        jM[i][i] = jax_lanes.add(jM[i][i], 10.0)
    x = lanes.lane_cholesky_solve(M, [torch.tensor(r) for r in v], like)
    jx = jax_lanes.lane_cholesky_solve(jM, [jnp.asarray(r) for r in v], jlike)
    np.testing.assert_allclose(torch.stack(x).numpy(), np.stack([np.asarray(c) for c in jx]), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("t0", [0.0, 0.013, 0.07])
def test_trajectory_step_data_with_ctx_matches_jax(t0):
    """Forecast wrench interpolation, int32 truncation, clip and the
    beyond-horizon zero (t0 = 0.07 runs past the 0.06 s horizon)."""
    steps = 6
    rng = np.random.default_rng(5)
    horizon = rng.normal(0.0, 40.0, (steps + 1, 6))
    cfg = ObjectiveConfiguration()
    ctx = ForecastContext(torch.tensor(horizon), torch.tensor(0.0, dtype=torch.float64), DT, steps * DT)
    jctx = JaxForecastContext(jnp.asarray(horizon), jnp.asarray(0.0, jnp.float64), DT, steps * DT)
    got = lane_rollout.trajectory_step_data(cfg, ctx, torch.tensor(t0, dtype=torch.float64), steps, DT)
    want = jax_lane_rollout.trajectory_step_data(
        JaxObjectiveConfiguration(), jctx, jnp.asarray(t0, jnp.float64), steps, DT
    )
    for name in ("target", "inv_norm2", "position_cost", "velocity_target"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=RTOL, atol=1e-15)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    if t0 > steps * DT:
        np.testing.assert_array_equal(got.target.numpy(), 0.0)


def test_trajectory_step_data_without_ctx_adds_nothing():
    """No forecast: the idle per-step data zeroes the trajectory term, as the
    JAX rollout functions' ctx=None branch does."""
    idle = lane_rollout.idle_trajectory_step_data(4, torch.float64, "cpu")
    for name in ("target", "inv_norm2", "position_cost", "velocity_target"):
        assert not getattr(idle, name).any()
    assert not idle.active.any()
    q, v, u = _rows("random", seed=7)
    energy = np.full(T, 100.0)
    zero = (np.zeros(3), 0.0, 0.0, 0.0)
    got = _torch_step(q, v, u, energy, zero)
    want = _jax_step(q, v, u, energy, zero)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL)


def test_make_lane_rollout_matches_jax_f64():
    """The horizon loop with a discount: two cost channels and lane 0's
    pre-step (q, v), against the JAX make_lane_rollout."""
    steps, discount = 4, 0.9
    rng = np.random.default_rng(13)
    noise = rng.normal(0.0, 1.0, (steps, 12, T)) * np.sqrt(fr.DEFAULT_COVARIANCE)[None, :, None]
    optimal = 0.3 * rng.normal(size=(steps, 12))
    x0 = fr.make_state("huddled")
    horizon = np.zeros((steps + 1, 6))
    horizon[:, 0] = 25.0
    ctx = ForecastContext(torch.tensor(horizon), torch.tensor(0.0, dtype=torch.float64), DT, steps * DT)
    jctx = JaxForecastContext(jnp.asarray(horizon), jnp.asarray(0.0, jnp.float64), DT, steps * DT)
    traj = lane_rollout.trajectory_step_data(
        ObjectiveConfiguration(), ctx, torch.tensor(0.005, dtype=torch.float64), steps, DT
    )
    jtraj = jax_lane_rollout.trajectory_step_data(
        JaxObjectiveConfiguration(), jctx, jnp.asarray(0.005, jnp.float64), steps, DT
    )
    rollout = lane_rollout.make_lane_rollout(
        frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(), steps, DT, discount
    )
    jrollout = jax_lane_rollout.make_lane_rollout(
        jax_model(), JaxObjectiveConfiguration(), jax_fr.Configuration(), steps, DT, discount
    )
    costs, states = rollout(torch.tensor(noise), torch.tensor(optimal), torch.tensor(x0), traj)
    jcosts, jqv0 = jrollout(jnp.asarray(noise), jnp.asarray(optimal), jnp.asarray(x0), jtraj)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=RTOL)
    jqv0 = np.asarray(jqv0)
    np.testing.assert_allclose(
        states.numpy(), np.concatenate([jqv0[..., 0], jqv0[..., 1]], axis=1), rtol=RTOL, atol=1e-12
    )

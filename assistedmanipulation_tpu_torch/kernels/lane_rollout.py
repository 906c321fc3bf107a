"""Fused Franka-Ridgeback MPPI rollout over rollout-minor tensors (port of
assistedmanipulation_tpu/kernels/lane_rollout.py).

The complete per-step pipeline — FK, assisted-manipulation cost, CRBA mass
matrix, implicit-PD forward dynamics, semi-implicit Euler — written with the
scalar-graph lane math of kernels/lanes.py. It is the plain PyTorch version
of the per-step body that the CUDA kernel (kernels/csrc/fused_sample_rollout.cu)
runs per thread.

Structural folds, all exact:
- the gripper PD position term vanishes (the command *is* the current
  position, raisim_dynamics.cpp:208-211) and base kp = 0, so
  tau_pd = kd * (v_cmd - v);
- MPPI rollouts carry no external wrench (raisim_dynamics.cpp:236-238), so
  external power is zero and the tank energy stays at x0[30] throughout,
  and the rollout dynamics carry no gravity or Coriolis term (the
  feedforward compensation cancels them);
- the trajectory cost's target vector depends only on the forecast wrench,
  so its position term and velocity target are computed once per *step*
  (not per rollout) before the rollout.

Around it, the JAX package's lanes backend: ``make_lanes_rollout_fn`` (the
batch rollout as mppi.Planner's ``rollout_fn``), ``make_lanes_planner``
(``parallel/flagship.build_flagship(backend="lanes")``) and
``make_lane_filter_rollout`` (the one-sequence re-rollout). They are plain
PyTorch on whatever device their tensors are on: no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import frankaridgeback as fr
from ..models.dynamics import FRICTION_EPS
from ..models.model_data import RobotModel
from ..objectives.assisted_manipulation import (
    COLLISION_PAIRS,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from . import lanes as L


class TrajectoryStepData(NamedTuple):
    """Per-step rollout-independent pieces of the trajectory cost
    (assisted_manipulation.cpp:237-290)."""

    target: torch.Tensor  # (S, 3) clamped target vectors
    inv_norm2: torch.Tensor  # (S,) 1 / |target|^2 (0 when inactive)
    position_cost: torch.Tensor  # (S,) constant part incl. threshold gating
    velocity_target: torch.Tensor  # (S,)
    active: torch.Tensor  # (S,) bool


def trajectory_step_data(
    cfg: ObjectiveConfiguration, ctx: ForecastContext, t0: torch.Tensor,
    steps: int, dt: float,
) -> TrajectoryStepData:
    times = t0 + torch.arange(steps, dtype=t0.dtype, device=t0.device) * dt
    wrench = ctx.wrench(times)  # (S, 6), or (C, S, 6) for an ensemble
    force = wrench[..., :3]
    target = torch.clamp(
        cfg.trajectory_target_scale * force,
        -cfg.trajectory_target_maximum,
        cfg.trajectory_target_maximum,
    )
    norm2 = torch.sum(target * target, dim=-1)
    distance = torch.sqrt(norm2)
    active = distance > cfg.trajectory_position_threshold
    position_cost = torch.where(
        active,
        cfg.trajectory_position_constant
        + cfg.trajectory_position_quadratic * norm2,
        0.0,
    )
    velocity_target = torch.clamp(
        torch.exp(cfg.trajectory_velocity_dropoff * distance) - 1.0,
        cfg.trajectory_velocity_minimum,
        cfg.trajectory_velocity_maximum,
    )
    inv_norm2 = torch.where(active, 1.0 / torch.clamp(norm2, min=1e-30), 0.0)
    return TrajectoryStepData(target, inv_norm2, position_cost, velocity_target, active)


def idle_trajectory_step_data(steps: int, dtype, device) -> TrajectoryStepData:
    """The per-step data when no forecast context is given: no trajectory
    target, so the trajectory term adds nothing."""
    zeros = torch.zeros((steps,), dtype=dtype, device=device)
    return TrajectoryStepData(
        target=torch.zeros((steps, 3), dtype=dtype, device=device),
        inv_norm2=zeros,
        position_cost=zeros,
        velocity_target=zeros,
        active=torch.zeros((steps,), dtype=torch.bool, device=device),
    )


def _divide(numerator: float, denominator: torch.Tensor) -> torch.Tensor:
    """``numerator / denominator`` as one correctly rounded division
    (PyTorch's ``float / tensor`` multiplies by a reciprocal instead)."""
    return torch.full_like(denominator, numerator) / denominator


def _barrier(gap: torch.Tensor, scale: float, maximum: float = 1e10):
    """Inverse barrier on a signed gap (positive inside the bound): one
    violation and a quadratic penalty outside, ``scale / gap`` inside, one
    violation and no smooth cost once ``scale / gap`` saturates."""
    safe = torch.where(gap > 0, gap, 1.0)
    raw = _divide(scale, safe)
    outside = gap <= 0
    clamped = raw >= maximum
    violations = (outside | clamped).to(gap.dtype)
    smooth = torch.where(
        outside, scale * gap * gap, torch.where(clamped, 0.0, raw)
    )
    return violations, smooth


def _barrier_left(value, bound: float, scale: float, maximum: float = 1e10):
    """LeftInverseBarrier.decomposed as a scalar graph on one lane vector."""
    return _barrier(L.materialize(L.sub(value, bound), value), scale, maximum)


def _barrier_right(value, bound: float, scale: float, maximum: float = 1e10):
    return _barrier(L.materialize(L.sub(bound, value), value), scale, maximum)


def step_cost_and_dynamics(
    model: RobotModel,
    cfg: ObjectiveConfiguration,
    kp: np.ndarray,
    kd: np.ndarray,
    q_list,
    v_list,
    u_list,
    energy: torch.Tensor,
    traj_target,
    traj_inv_norm2,
    traj_position_cost,
    traj_velocity_target,
    dt: float,
):
    """One fused rollout step over lanes.

    Inputs: q/v/u as lists of 12 (T,) tensors; energy (T,); traj_* per-step
    scalars (0-d tensors). Returns (violations (T,), smooth (T,), q', v')."""
    like = q_list[0]
    fk = L.lane_fk(model, q_list)

    violations = torch.zeros_like(like)
    smooth = torch.zeros_like(like)

    # --- joint limits (assisted_manipulation.cpp:74-88) ---------------------
    if cfg.enable_joint_limit:
        for i in range(12):
            lb, ls = cfg.lower_joint_limit[i]
            ub, us = cfg.upper_joint_limit[i]
            vl, sl = _barrier_left(q_list[i], lb, ls)
            vr, sr = _barrier_right(q_list[i], ub, us)
            violations = violations + vl + vr
            smooth = smooth + sl + sr

    # --- link positions for collisions + workspace --------------------------
    link_positions = []
    for name in fr.COLLISION_LINKS:
        _, p = L.lane_frame(model, fk, model.link_frames, name)
        link_positions.append([L.materialize(c, like) for c in p])

    if cfg.enable_self_collision_limit:
        radii = np.asarray(cfg.self_collision_radii)
        cb, cs = cfg.self_collision_limit
        for a, b in COLLISION_PAIRS:
            pa, pb = link_positions[a], link_positions[b]
            d2 = (
                (pa[0] - pb[0]) ** 2
                + (pa[1] - pb[1]) ** 2
                + (pa[2] - pb[2]) ** 2
            )
            distance = torch.sqrt(d2)
            gap = distance - float(radii[a] + radii[b])
            vl, sl = _barrier_left(gap, cb, cs)
            violations = violations + vl
            smooth = smooth + sl

    # --- end effector state -------------------------------------------------
    _, p_ee_graph = L.lane_frame(model, fk, model.frames, model.end_effector_frame)
    p_ee = [L.materialize(c, like) for c in p_ee_graph]
    J_lin = L.lane_point_jacobian(model, fk, p_ee, fr.EE_BODY)  # [12][3]

    # ee linear velocity = sum_i J_lin[i] * v_i
    ee_vel = [None, None, None]
    for i in range(12):
        for a in range(3):
            ee_vel[a] = L.fma(ee_vel[a], J_lin[i][a], v_list[i])
    ee_vel = [L.materialize(c, like) for c in ee_vel]

    # --- workspace (assisted_manipulation.cpp:160-209) ----------------------
    if cfg.enable_workspace_limit:
        yaw = q_list[2]
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        _, mount = L.lane_frame(model, fk, model.frames, "arm_mount_joint")
        robot = [
            L.materialize(mount[0], like) + 0.1 * cy,
            L.materialize(mount[1], like) + 0.1 * sy,
            L.materialize(mount[2], like) + 0.15,
        ]
        to_ee = [p_ee[a] - robot[a] for a in range(3)]
        projection = to_ee[0] * cy + to_ee[1] * sy  # forward is unit length
        ib, iscale = cfg.workspace_limit_infront
        vl, sl = _barrier_left(projection, ib, iscale)
        violations, smooth = violations + vl, smooth + sl

        reach = torch.sqrt(to_ee[0] ** 2 + to_ee[1] ** 2 + to_ee[2] ** 2)
        rb, rscale = cfg.workspace_limit_reach
        vr, sr = _barrier_right(reach, rb, rscale)
        violations, smooth = violations + vr, smooth + sr

        denom = torch.sqrt(to_ee[0] ** 2 + to_ee[1] ** 2)  # |forward_xy| = 1
        cos_angle = torch.clamp(
            projection / torch.where(denom > 0, denom, 1.0), -1.0, 1.0
        )
        angle = L.acos(cos_angle)
        smooth = smooth + torch.where(
            denom > 0, cfg.workspace_cost_yaw * angle * angle, 0.0
        )

        height = p_ee[2] - robot[2]
        ab, ascale = cfg.workspace_limit_above
        va, sa = _barrier_left(height, ab, ascale)
        violations, smooth = violations + va, smooth + sa

    # --- energy (constant over the rollout; assisted_manipulation.cpp:211) --
    if cfg.enable_energy_limit:
        eb, es = cfg.energy_limit_below
        ea, esa = cfg.energy_limit_above
        vb, sb = _barrier_left(energy, eb, es)
        va, sa = _barrier_right(energy, ea, esa)
        violations = violations + vb + va
        smooth = smooth + sb + sa

    # --- velocity cost ------------------------------------------------------
    if cfg.enable_velocity_cost:
        for i, gain in enumerate(cfg.velocity_cost):
            if gain:
                smooth = smooth + float(gain) * v_list[i] * v_list[i]

    # --- trajectory cost (per-rollout part: velocity projection) ------------
    if cfg.enable_trajectory_cost:
        dot = (
            ee_vel[0] * traj_target[0]
            + ee_vel[1] * traj_target[1]
            + ee_vel[2] * traj_target[2]
        )
        projection = dot * traj_inv_norm2
        # copysign(1, p) * |target * p| = p * |target| (exact identity).
        target_norm = torch.sqrt(
            traj_target[0] ** 2 + traj_target[1] ** 2 + traj_target[2] ** 2
        )
        signed = projection * target_norm
        velocity_error = torch.abs(traj_velocity_target - signed)
        smooth = smooth + traj_position_cost + torch.where(
            traj_inv_norm2 > 0,
            cfg.trajectory_velocity_quadratic * velocity_error * velocity_error,
            0.0,
        )

    # --- manipulability (assisted_manipulation.cpp:292-319) -----------------
    if cfg.enable_manipulability_cost:
        # Linear rows, arm columns 3..9 of the EE jacobian. The base 3x3
        # yaw-override (raisim_dynamics.cpp:169-174) only touches columns
        # 0-2, so the arm block is the true point jacobian.
        m = [[torch.zeros_like(like) for _ in range(3)] for _ in range(3)]
        for i in range(3, 10):
            col = [L.materialize(J_lin[i][a], like) for a in range(3)]
            for a in range(3):
                for b in range(a, 3):
                    m[a][b] = m[a][b] + col[a] * col[b]
        det = (
            m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[1][2])
            - m[0][1] * (m[0][1] * m[2][2] - m[1][2] * m[0][2])
            + m[0][2] * (m[0][1] * m[1][2] - m[1][1] * m[0][2])
        )
        volume = torch.sqrt(torch.clamp(det, min=0.0))
        volume = torch.where(
            torch.isnan(volume), 1e-5, torch.clamp(volume, 1e-5, 1e5)
        )
        inv = 1.0 / volume
        smooth = smooth + cfg.manipulability_quadratic * inv * inv

    # --- dynamics: tau_pd + arm feedforward, implicit-PD solve --------------
    # tau = kd * (v_cmd - v) + S_arm u (gripper/base kp terms vanish; see
    # module docstring).
    tau = []
    for i in range(12):
        v_cmd = u_list[i] if i < 3 else None
        t = L.mul(float(kd[i]), L.sub(v_cmd, v_list[i]))
        if 3 <= i < 10:
            t = L.add(t, u_list[i])
        tau.append(t)

    M = L.lane_mass_matrix(model, fk)
    for i in range(12):
        M[i][i] = L.add(M[i][i], float(kd[i]) * dt)
    # URDF Coulomb joint friction, implicitly regularized: tau_f = -c v_next
    # with c = f/(|v|+eps); -c v on the rhs, +c dt on the implicit diagonal.
    # Only joints with nonzero URDF friction pay (base x/y/pivot = 10).
    for i in range(12):
        f_i = float(model.friction[i]) if model.friction is not None else 0.0
        d_i = float(model.damping[i]) if model.damping is not None else 0.0
        if f_i == 0.0 and d_i == 0.0:
            continue
        c_i = _divide(f_i, torch.abs(v_list[i]) + FRICTION_EPS) + d_i
        tau[i] = L.sub(tau[i], c_i * v_list[i])
        M[i][i] = L.add(M[i][i], c_i * dt)
    qdd = L.lane_cholesky_solve(M, tau, like)

    v_next = [L.materialize(L.add(v_list[i], L.mul(dt, qdd[i])), like) for i in range(12)]
    q_next = [q_list[i] + dt * v_next[i] for i in range(12)]

    return violations, smooth, q_next, v_next


def make_lane_rollout(
    model: RobotModel,
    objective_cfg: ObjectiveConfiguration,
    robot_cfg: fr.Configuration,
    steps: int,
    dt: float,
    discount: float = 1.0,
):
    """Build rollout_costs(noise (S, 12, T), optimal (S, 12), x0 (31,),
    traj_data) -> ((T, 2) cost channels, (S, 24) lane-0 pre-step q/v).
    Lane 0 is the zero-noise static rollout in the planner's layout; its
    per-step states feed the "batch" optimal_rollout_mode."""
    _, kp, kd = robot_cfg.resolve()

    def rollout_costs(noise, optimal, x0, traj: TrajectoryStepData):
        discounts = discount ** torch.arange(
            steps, dtype=noise.dtype, device=noise.device
        )
        return rollout_steps(
            model, objective_cfg, kp, kd, dt, noise, optimal, x0, traj,
            discounts,
        )

    return rollout_costs


def rollout_steps(
    model, objective_cfg, kp, kd, dt, noise, optimal, x0,
    traj: TrajectoryStepData, discounts,
):
    """The horizon loop shared by make_lane_rollout and the plain versions
    of both CUDA kernels: discounted two-channel costs (NaN poisons a
    rollout's sum) and rollout 0's pre-step (q, v). The controls are
    ``optimal + noise``, or ``noise`` alone when ``optimal`` is None (the
    two-pass kernel's absolute controls)."""
    S, _, T = noise.shape
    like = torch.zeros((T,), dtype=noise.dtype, device=noise.device)
    energy = like + x0[fr.ENERGY]
    q = [like + x0[i] for i in range(12)]
    v = [like + x0[12 + i] for i in range(12)]
    violations = torch.zeros_like(like)
    smooth = torch.zeros_like(like)
    states = []
    for s in range(S):
        states.append(torch.stack([c[0] for c in q + v]))  # lane-0 pre-step
        u = [noise[s, d] if optimal is None else optimal[s, d] + noise[s, d] for d in range(12)]
        step_viol, step_smooth, q, v = step_cost_and_dynamics(
            model,
            objective_cfg,
            kp,
            kd,
            q,
            v,
            u,
            energy,
            [traj.target[s, 0], traj.target[s, 1], traj.target[s, 2]],
            traj.inv_norm2[s],
            traj.position_cost[s],
            traj.velocity_target[s],
            dt,
        )
        violations = violations + discounts[s] * step_viol
        smooth = smooth + discounts[s] * step_smooth
    return torch.stack([violations, smooth], dim=-1), torch.stack(states)


def step_data(objective_cfg: ObjectiveConfiguration, ctx, time, steps: int, dt: float, like: torch.Tensor):
    """The per-step trajectory data of ``ctx`` from ``time`` (a number is
    taken in ``like``'s dtype), or the idle data in ``like``'s dtype and
    device without a ctx."""
    if ctx is None:
        return idle_trajectory_step_data(steps, like.dtype, like.device)
    if not isinstance(time, torch.Tensor):
        time = torch.tensor(time, dtype=like.dtype, device=like.device)
    return trajectory_step_data(objective_cfg, ctx, time, steps, dt)


def states_with_tail(qv: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """(S, 24) pre-step (q, v) -> (S, 31) states: x0's wrench and energy
    appended (a rollout applies no wrench, so the tank stays constant,
    raisim_dynamics.cpp:236-238)."""
    tail = x0[24:].to(qv.dtype).expand(qv.shape[0], x0.shape[0] - 24)
    return torch.cat([qv, tail], dim=1)


def make_lane_filter_rollout(
    model: RobotModel,
    objective_cfg: ObjectiveConfiguration,
    robot_cfg: fr.Configuration,
    steps: int,
    dt: float,
    discount: float = 1.0,
):
    """Single-trajectory optimal re-rollout on the lanes step
    (mppi::Trajectory::filter, mppi.cpp:450-479, without a per-step control
    filter): the batch rollout's step at one lane.

    Returns fn(optimal (S, 12), x0 (31,), time, ctx) -> (cost (2,) channels,
    states (S, 31)), the pre-step state of each step with x0's wrench and
    energy. A scenario-ensemble ctx is scored on its nominal scenario, as
    kernels/cuda_rollout.make_cuda_filter_rollout_fn does. Plain PyTorch on
    ``optimal``'s device; no planner factory wires it (the JAX package's
    neither), mppi.Planner's ``filter_rollout_fn`` takes it."""
    rollout = make_lane_rollout(model, objective_cfg, robot_cfg, steps, dt, discount)

    def fn(optimal, x0, time, ctx):
        x0 = x0.to(device=optimal.device, dtype=optimal.dtype)
        if ctx is not None and ctx.wrench_horizon.ndim == 3:
            ctx = ctx._replace(wrench_horizon=ctx.wrench_horizon[0])
        traj = step_data(objective_cfg, ctx, time, steps, dt, optimal)
        # The controls are absolute: one lane of noise on no optimal.
        costs, qv = rollout(optimal[:, :, None], None, x0, traj)
        return costs[0], states_with_tail(qv, x0)

    return fn


def make_lanes_rollout_fn(
    model: RobotModel,
    objective_cfg: ObjectiveConfiguration,
    robot_cfg: fr.Configuration,
    steps: int,
    dt: float,
    discount: float = 1.0,
):
    """mppi.Planner's ``rollout_fn`` on the lanes step: ``fn(noise (R, S,
    12), optimal_shifted (S, 12), x0 (31,), time, ctx) -> ((R, 2) costs,
    (S, 31) rollout-0 pre-step states)``. The noise goes rollout-minor
    (S, 12, R), the per-step trajectory data is made once from ctx, and the
    horizon loop runs the scalar graph over every rollout at once: plain
    PyTorch on the noise's device, a few thousand small operations per step.
    Rollout 0's wrench and energy slots carry x0's values."""
    rollout = make_lane_rollout(model, objective_cfg, robot_cfg, steps, dt, discount)

    def fn(noise, optimal_shifted, x0, time, ctx):
        x0 = x0.to(device=noise.device, dtype=noise.dtype)
        traj = step_data(objective_cfg, ctx, time, steps, dt, noise)
        costs, qv = rollout(noise.permute(1, 2, 0), optimal_shifted.to(device=noise.device, dtype=noise.dtype),
                            x0, traj)
        return costs, states_with_tail(qv, x0)

    return fn


def make_lanes_planner(
    mppi_configuration,
    objective_cfg: ObjectiveConfiguration = None,
    robot_cfg: fr.Configuration = None,
    filter_fn=None,
    rollout_fn_wrapper=None,
    device="cuda",
    shards=None,
):
    """mppi.Planner with the assisted-manipulation objective on the lanes
    rollout (``make_lanes_rollout_fn``; cost channels as the vmap path's).

    ``filter_fn`` forwards to Planner (the QP safety filter);
    ``rollout_fn_wrapper`` post-processes the rollout evaluator (e.g.
    forecast/scenarios.make_scenario_rollout_fn for a scenario ensemble, or
    parallel/sharding.shard_rollout_fn on a mesh); ``shards``
    (parallel/sharding.RolloutShards) splits the batch as for the vmap
    planner. The resimulate re-rollout runs through the plant."""
    from .. import mppi as mppi_module
    from ..models.model_data import frankaridgeback_model
    from ..objectives.assisted_manipulation import AssistedManipulation

    model = frankaridgeback_model()
    objective_cfg = objective_cfg or ObjectiveConfiguration()
    robot_cfg = robot_cfg or fr.Configuration()
    plant = fr.make_plant(AssistedManipulation(objective_cfg), robot_cfg, model)
    rollout_fn = make_lanes_rollout_fn(
        model,
        objective_cfg,
        robot_cfg,
        mppi_configuration.step_count,
        mppi_configuration.time_step,
        mppi_configuration.cost_discount_factor,
    )
    if rollout_fn_wrapper is not None:
        rollout_fn = rollout_fn_wrapper(rollout_fn)
    return mppi_module.Planner(
        mppi_configuration, plant, device=device, rollout_fn=rollout_fn, filter_fn=filter_fn, shards=shards
    )

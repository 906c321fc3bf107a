"""Fused MPPI sample + rollout on the GPU (counterpart of
assistedmanipulation_tpu/kernels/pallas_rollout.py).

Three things live here:

- ``fused_sample_rollout_reference``: the plain PyTorch version — the noise
  select chain of the TPU kernel vectorised over the batch, then the lane
  rollout of kernels/lane_rollout.py;
- ``fused_sample_rollout``: the wrapper of the hand-written CUDA kernel
  (csrc/fused_sample_rollout.cu). A CUDA tensor launches the kernel (or
  raises); a CPU tensor takes the plain version;
- ``CudaSampler``: the sampler protocol of mppi.Planner (``init_noise``,
  ``sample_and_rollout``, ``weighted_noise_sum``) for one device.

Noise layout: rollout-minor (S, 12, R), so the kernel's per-thread loads
coalesce. ``noise_to_logical``/``noise_from_logical`` convert to and from the
logical (R, S, 12) form that public comparisons use.

Per-update inputs travel as two small tensors: ``init`` (32,) = q0 (12),
v0 (12), energy, padding; and the per-step ``table`` (S, 32) whose columns
are named below (target xyz, 1/|target|^2, position cost, velocity target,
discount, pre-shift optimal (12), shifted optimal (12), padding). ``meta``
(3,) int32 = (shift, do_shift, first) stays on the device, so an update
never waits on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import frankaridgeback as fr
from ..models.model_data import PRISMATIC, RobotModel
from ..objectives.assisted_manipulation import (
    COLLISION_PAIRS,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from ..ops.gaussian import sample_noise
from . import build
from .lane_rollout import (
    TrajectoryStepData,
    idle_trajectory_step_data,
    rollout_steps,
    trajectory_step_data,
)

TABLE_WIDTH = 32
COL_TARGET, COL_INV2, COL_PCOST, COL_VTARGET, COL_DISC = 0, 3, 4, 5, 6
COL_OPTIMAL, COL_OPTSHIFT = 7, 19

# Kernel launches by wrapper, counted where the wrapper launches.
LAUNCHES = {"fused_sample_rollout": 0}

# Hardware-neutral work of one rollout-step of the folded scalar graph,
# counted by walking the JAX step's jaxpr (assistedmanipulation_tpu/ops/
# flops.py: rollout_step_flops, count_fma_pairs): FLOPs, and FP32
# instructions once each mul->add pair issues as one FMA.
STEP_FLOPS = 4892
STEP_FP32_INSTRUCTIONS = 3301


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def noise_to_logical(noise: torch.Tensor) -> torch.Tensor:
    """(S, 12, R) -> (R, S, 12) view."""
    return noise.permute(2, 0, 1)


def noise_from_logical(noise: torch.Tensor) -> torch.Tensor:
    """(R, S, 12) -> contiguous (S, 12, R)."""
    return noise.permute(1, 2, 0).contiguous()


class _Params(ctypes.Structure):
    """ctypes mirror of ``struct Params`` in csrc/fused_sample_rollout.cu."""

    _fields_ = [
        ("rot", ctypes.c_float * 9 * 12),
        ("trans", ctypes.c_float * 3 * 12),
        ("axis", ctypes.c_float * 3 * 12),
        ("mass", ctypes.c_float * 12),
        ("com", ctypes.c_float * 3 * 12),
        ("inertia", ctypes.c_float * 9 * 12),
        ("kd", ctypes.c_float * 12),
        ("kd_dt", ctypes.c_float * 12),
        ("friction", ctypes.c_float * 12),
        ("damping", ctypes.c_float * 12),
        ("frame_p", ctypes.c_float * 3 * 10),
        ("lower_bound", ctypes.c_float * 12),
        ("lower_scale", ctypes.c_float * 12),
        ("upper_bound", ctypes.c_float * 12),
        ("upper_scale", ctypes.c_float * 12),
        ("pair_radius", ctypes.c_float * 20),
        ("collision_bound", ctypes.c_float),
        ("collision_scale", ctypes.c_float),
        ("infront_bound", ctypes.c_float),
        ("infront_scale", ctypes.c_float),
        ("reach_bound", ctypes.c_float),
        ("reach_scale", ctypes.c_float),
        ("above_bound", ctypes.c_float),
        ("above_scale", ctypes.c_float),
        ("yaw_gain", ctypes.c_float),
        ("energy_below_bound", ctypes.c_float),
        ("energy_below_scale", ctypes.c_float),
        ("energy_above_bound", ctypes.c_float),
        ("energy_above_scale", ctypes.c_float),
        ("velocity_gain", ctypes.c_float * 12),
        ("trajectory_velocity_quadratic", ctypes.c_float),
        ("manipulability_quadratic", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("enable_joint_limit", ctypes.c_int),
        ("enable_self_collision", ctypes.c_int),
        ("enable_workspace", ctypes.c_int),
        ("enable_energy", ctypes.c_int),
        ("enable_velocity", ctypes.c_int),
        ("enable_trajectory", ctypes.c_int),
        ("enable_manipulability", ctypes.c_int),
    ]


def _fill(field, values) -> None:
    """Copy a numpy array into a (nested) ctypes float array, row by row."""
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        for i, x in enumerate(values):
            field[i] = float(x)
    else:
        for i, row in enumerate(values):
            _fill(field[i], row)


class RolloutSpec:
    """The static inputs of the fused rollout: robot model, objective
    configuration, PD gains and time step."""

    def __init__(
        self,
        model: RobotModel,
        objective_cfg: ObjectiveConfiguration,
        robot_cfg: fr.Configuration,
        dt: float,
    ):
        _, self.kp, self.kd = robot_cfg.resolve()
        self.model = model
        self.objective_cfg = objective_cfg
        self.dt = dt
        self.topology_checked = False
        self._params = None

    def topology(self) -> list:
        """The model's topology in the kernel's fsr_topology() encoding."""
        model = self.model
        frames = [model.link_frames[name][0] for name in fr.COLLISION_LINKS]
        frames += [
            model.frames[model.end_effector_frame][0],
            model.frames["arm_mount_joint"][0],
        ]
        return (
            [model.n_joints]
            + [int(p) for p in model.parent]
            + [int(t != PRISMATIC) for t in model.joint_type]
            + [len(frames)] + frames
            + [len(COLLISION_PAIRS)] + [int(i) for i in COLLISION_PAIRS.ravel()]
        )

    def kernel_params(self) -> _Params:
        """The kernel's by-value parameter block, built once."""
        if self._params is not None:
            return self._params
        model, cfg = self.model, self.objective_cfg
        p = _Params()
        axis = model.axis / np.linalg.norm(model.axis, axis=1, keepdims=True)
        _fill(p.rot, model.rotation.reshape(12, 9))
        _fill(p.trans, model.translation)
        _fill(p.axis, axis)
        _fill(p.mass, model.mass)
        _fill(p.com, model.com)
        _fill(p.inertia, model.inertia.reshape(12, 9))
        _fill(p.kd, self.kd)
        _fill(p.kd_dt, np.asarray(self.kd, np.float64) * self.dt)
        _fill(p.friction, model.friction)
        _fill(p.damping, model.damping)
        frames = [model.link_frames[name][2] for name in fr.COLLISION_LINKS]
        frames += [
            model.frames[model.end_effector_frame][2],
            model.frames["arm_mount_joint"][2],
        ]
        _fill(p.frame_p, np.stack(frames))
        lower = np.asarray(cfg.lower_joint_limit, np.float64)
        upper = np.asarray(cfg.upper_joint_limit, np.float64)
        _fill(p.lower_bound, lower[:, 0])
        _fill(p.lower_scale, lower[:, 1])
        _fill(p.upper_bound, upper[:, 0])
        _fill(p.upper_scale, upper[:, 1])
        radii = np.asarray(cfg.self_collision_radii, np.float64)
        _fill(p.pair_radius, radii[COLLISION_PAIRS[:, 0]] + radii[COLLISION_PAIRS[:, 1]])
        p.collision_bound, p.collision_scale = cfg.self_collision_limit
        p.infront_bound, p.infront_scale = cfg.workspace_limit_infront
        p.reach_bound, p.reach_scale = cfg.workspace_limit_reach
        p.above_bound, p.above_scale = cfg.workspace_limit_above
        p.yaw_gain = cfg.workspace_cost_yaw
        p.energy_below_bound, p.energy_below_scale = cfg.energy_limit_below
        p.energy_above_bound, p.energy_above_scale = cfg.energy_limit_above
        _fill(p.velocity_gain, cfg.velocity_cost)
        p.trajectory_velocity_quadratic = cfg.trajectory_velocity_quadratic
        p.manipulability_quadratic = cfg.manipulability_quadratic
        p.dt = self.dt
        p.enable_joint_limit = int(cfg.enable_joint_limit)
        p.enable_self_collision = int(cfg.enable_self_collision_limit)
        p.enable_workspace = int(cfg.enable_workspace_limit)
        p.enable_energy = int(cfg.enable_energy_limit)
        p.enable_velocity = int(cfg.enable_velocity_cost)
        p.enable_trajectory = int(cfg.enable_trajectory_cost)
        p.enable_manipulability = int(cfg.enable_manipulability_cost)
        self._params = p
        return p


def rollout_inputs(
    objective_cfg: ObjectiveConfiguration,
    steps: int,
    dt: float,
    discount: float,
    x0: torch.Tensor,
    time: torch.Tensor,
    ctx: Optional[ForecastContext],
    optimal: torch.Tensor,
    optimal_shifted: torch.Tensor,
):
    """(init (32,), table (S, 32)) in x0's dtype and device."""
    if ctx is None:
        traj = idle_trajectory_step_data(steps, x0.dtype, x0.device)
    else:
        traj = trajectory_step_data(objective_cfg, ctx, time, steps, dt)
    discounts = discount ** torch.arange(steps, dtype=x0.dtype, device=x0.device)
    table = torch.cat(
        [
            traj.target.to(x0.dtype),
            traj.inv_norm2.to(x0.dtype)[:, None],
            traj.position_cost.to(x0.dtype)[:, None],
            traj.velocity_target.to(x0.dtype)[:, None],
            discounts[:, None],
            optimal.to(x0.dtype),
            optimal_shifted.to(x0.dtype),
            torch.zeros((steps, 1), dtype=x0.dtype, device=x0.device),
        ],
        dim=1,
    )
    init = torch.cat(
        [x0[:24], x0[fr.ENERGY:], torch.zeros(7, dtype=x0.dtype, device=x0.device)]
    )
    return init, table


def assemble_noise(table, meta, old, fresh, keep):
    """The TPU kernel's noise select chain (pallas_rollout.py:350-363) over
    the whole (S, 12, R) batch: elite rows keep their old noise, shifted
    left by ``shift`` with a fresh tail when ``do_shift``; other rows take
    fresh noise; rows 0 and 1 of the first batch take 0 and -optimal."""
    S, _, R = old.shape
    shift, do_shift, first = meta[0], meta[1] != 0, meta[2] != 0
    col = torch.arange(S, device=old.device)
    sidx = torch.clamp(col + shift, max=S - 1)
    tail = (col >= S - shift)[:, None, None]
    kept = torch.where(tail, fresh, old[sidx])
    kept = torch.where(do_shift, kept, old)
    sampled = torch.where(keep[None, None, :], kept, fresh)
    row = torch.arange(R, device=old.device)
    row0 = (row == 0) & first
    row1 = (row == 1) & first
    optimal = table[:, COL_OPTIMAL:COL_OPTIMAL + 12, None]
    return torch.where(
        row0, torch.zeros((), dtype=old.dtype, device=old.device),
        torch.where(row1, -optimal, sampled),
    )


def fused_sample_rollout_reference(spec: RolloutSpec, init, table, meta, old, fresh, keep):
    """Plain PyTorch version of the fused kernel, same signature and outputs:
    ((S, 12, R) noise, (R, 2) cost channels, (S, 24) rollout-0 pre-step
    (q, v))."""
    noise = assemble_noise(table, meta, old, fresh, keep)
    traj = TrajectoryStepData(
        target=table[:, COL_TARGET:COL_TARGET + 3],
        inv_norm2=table[:, COL_INV2],
        position_cost=table[:, COL_PCOST],
        velocity_target=table[:, COL_VTARGET],
        active=table[:, COL_INV2] > 0,
    )
    zeros = torch.zeros(6, dtype=init.dtype, device=init.device)
    x0 = torch.cat([init[:24], zeros, init[24:25]])
    costs, states = rollout_steps(
        spec.model, spec.objective_cfg, spec.kp, spec.kd, spec.dt, noise,
        table[:, COL_OPTSHIFT:COL_OPTSHIFT + 12], x0, traj,
        table[:, COL_DISC],
    )
    return noise, costs, states


def _check_kernel_inputs(init, table, meta, old, fresh, keep) -> None:
    device = old.device
    S, _, R = old.shape
    expected = {
        "init": (init, torch.float32, (TABLE_WIDTH,)),
        "table": (table, torch.float32, (S, TABLE_WIDTH)),
        "meta": (meta, torch.int32, (3,)),
        "old": (old, torch.float32, (S, 12, R)),
        "fresh": (fresh, torch.float32, (S, 12, R)),
        "keep": (keep, torch.bool, (R,)),
    }
    for name, (tensor, dtype, shape) in expected.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, old on {device}")
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(tensor.shape)}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R < 1 or S < 1:
        raise ValueError("need at least one rollout and one step")


def _library(spec: RolloutSpec):
    lib = build.load("fused_sample_rollout")
    if not getattr(lib, "_checked", False):
        lib.fsr_params_bytes.restype = ctypes.c_int
        lib.fsr_params_bytes.argtypes = []
        lib.fsr_topology.restype = ctypes.c_int
        lib.fsr_topology.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.fsr_launch.restype = ctypes.c_int
        lib.fsr_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        if lib.fsr_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"kernel Params is {lib.fsr_params_bytes()} bytes, the ctypes "
                f"mirror {ctypes.sizeof(_Params)}"
            )
        lib._checked = True
    if not spec.topology_checked:
        buffer = (ctypes.c_int * 256)()
        count = lib.fsr_topology(buffer, 256)
        if list(buffer[:count]) != spec.topology():
            raise ValueError(
                "the robot model's topology differs from the compiled kernel's"
            )
        spec.topology_checked = True
    return lib


def fused_sample_rollout(spec: RolloutSpec, init, table, meta, old, fresh, keep):
    """Fused noise assembly + rollout. CUDA tensors launch the kernel of
    csrc/fused_sample_rollout.cu (float32 only); CPU tensors take
    ``fused_sample_rollout_reference``. Returns ((S, 12, R) noise, (R, 2)
    costs, (S, 24) rollout-0 states)."""
    if old.device.type == "cpu":
        return fused_sample_rollout_reference(spec, init, table, meta, old, fresh, keep)
    if old.device.type != "cuda":
        raise ValueError(f"no fused rollout for device {old.device}")
    _check_kernel_inputs(init, table, meta, old, fresh, keep)
    lib = _library(spec)
    S, _, R = old.shape
    noise = torch.empty_like(old)
    costs = torch.empty((R, 2), dtype=old.dtype, device=old.device)
    states = torch.empty((S, 24), dtype=old.dtype, device=old.device)
    with torch.cuda.device(old.device):
        err = lib.fsr_launch(
            ctypes.addressof(spec.kernel_params()),
            init.data_ptr(), table.data_ptr(), meta.data_ptr(),
            old.data_ptr(), fresh.data_ptr(), keep.data_ptr(),
            noise.data_ptr(), costs.data_ptr(), states.data_ptr(),
            R, S, torch.cuda.current_stream(old.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sample_rollout launch failed: CUDA error {err}")
    LAUNCHES["fused_sample_rollout"] += 1
    return noise, costs, states


class CudaSampler:
    """Fused sampling + rollout backend for mppi.Planner on one device: the
    noise lives in the kernel's (S, 12, R) layout end to end, and one kernel
    launch per update assembles the noise and scores every rollout.

    Protocol (the one mppi.Planner's JAX counterpart uses for PallasSampler):
    - init_noise(dtype) -> noise representation
    - sample_and_rollout(generator, keep_mask, shift_by, do_shift, old,
      optimal, optimal_shifted, x0, time, ctx, fresh=None)
      -> ((R, 2) costs, noise, (S, 31) rollout-0 states)
    - weighted_noise_sum(noise, (R,) weights) -> (S, 12)

    Diagonal covariance only (the robot default, base.hpp:79-94)."""

    def __init__(
        self,
        model: RobotModel,
        objective_cfg: ObjectiveConfiguration,
        robot_cfg: fr.Configuration,
        rollout_count: int,
        steps: int,
        dt: float,
        diag_scale: np.ndarray,  # (dof,) noise standard deviations
        discount: float = 1.0,
        device="cuda",
    ):
        self.spec = RolloutSpec(model, objective_cfg, robot_cfg, dt)
        self.rollouts = rollout_count
        self.steps = steps
        self.dof = 12
        self.device = resolve_device(device)
        self._diag_scale = np.asarray(diag_scale, np.float64)
        self._objective_cfg = objective_cfg
        self._discount = discount
        self._dt = dt
        self._first = torch.ones((), dtype=torch.int32, device=self.device)
        self._scales = {}

    def init_noise(self, dtype):
        return torch.zeros(
            (self.steps, self.dof, self.rollouts), dtype=dtype, device=self.device
        )

    def sample_and_rollout(
        self, generator, keep_mask, shift_by, do_shift, old, optimal,
        optimal_shifted, x0, time, ctx, fresh=None,
    ):
        """``fresh`` (S, 12, R): N(0, cov) draws to use instead of drawing
        from ``generator`` (the parity tests feed the JAX draws here)."""
        if fresh is None:
            if old.dtype not in self._scales:
                self._scales[old.dtype] = torch.as_tensor(
                    self._diag_scale, dtype=old.dtype
                ).to(self.device)
            fresh = sample_noise(generator, self._scales[old.dtype], old.shape, dim=1)
        init, table = rollout_inputs(
            self._objective_cfg, self.steps, self._dt, self._discount, x0, time,
            ctx, optimal, optimal_shifted,
        )
        meta = torch.stack(
            [shift_by.to(torch.int32), do_shift.to(torch.int32), self._first]
        )
        noise, costs, qv = fused_sample_rollout(
            self.spec, init, table, meta, old, fresh, keep_mask
        )
        tail = x0[24:].to(qv.dtype).expand(self.steps, x0.shape[0] - 24)
        return costs, noise, torch.cat([qv, tail], dim=1)

    def weighted_noise_sum(self, noise, weights):
        return (noise.reshape(self.steps * self.dof, self.rollouts) @ weights).reshape(
            self.steps, self.dof
        )

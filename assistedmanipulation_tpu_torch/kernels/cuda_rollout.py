"""MPPI sample + rollout on the GPU (counterpart of
assistedmanipulation_tpu/kernels/pallas_rollout.py).

Three hand-written CUDA kernels, each with a wrapper and a plain PyTorch
version of the same signature. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version. Each runs on a pair of
warps per 32 rollouts, one running the dynamics, the other the cost terms,
joined by a ring of states in shared memory (csrc/pipeline.cuh).

- ``fused_sample_rollout`` (csrc/fused_sample_rollout.cu) assembles the
  noise (the TPU kernel's select chain) and scores every rollout in one
  launch; plain version ``fused_sample_rollout_reference``;
- ``inkernel_rng_sample_rollout`` (csrc/inkernel_rng_sample_rollout.cu)
  does the same with the fresh draws made in the kernel from 2 seed words
  (Philox, kernels/philox.py); plain version
  ``inkernel_rng_sample_rollout_reference``. Both are instantiations of
  csrc/sample_rollout.cuh's kernel, launch through ``_sample_rollout`` and
  keep their (S, 32) table in shared memory beside the ring, so each takes
  at most ``FUSED_MAX_STEPS`` = ``INKERNEL_MAX_STEPS`` steps;
- ``rollout`` (csrc/rollout.cu) scores given absolute controls against one
  forecast or every scenario of an ensemble in one launch, the two-pass
  kernel; plain version ``rollout_reference``. Its (C, S, 8) tables share
  the block's shared memory with the ring: C x S <= ``ROLLOUT_MAX_TABLE_ROWS``.

Around them: ``make_cuda_rollout_fn``, a rollout evaluator in the logical
layout (the counterpart of ``make_pallas_rollout_fn``),
``make_cuda_filter_rollout_fn``, the re-rollout of one control sequence that
mppi.Planner's resimulate mode takes (kernel 2 at R = 1), and
``CudaSampler``, the sampler protocol of mppi.Planner (``init_noise``,
``sample_and_rollout``, ``weighted_noise_sum``, and for a captured update
``graph_rng``/``seed_replay``) for one device, fused or two-pass.

Noise and control layout: rollout-minor (S, 12, R), so the kernels'
per-thread loads coalesce. ``noise_to_logical``/``noise_from_logical``
convert to and from the logical (R, S, 12) form that public comparisons use.

Per-update inputs travel as small tensors: ``init`` (32,) = q0 (12), v0 (12),
energy, padding; the per-step ``step_table`` (S, 8) = target xyz,
1/|target|^2, position cost, velocity target, discount, padding, which the
two-pass kernel reads ((C, S, 8) for a C-scenario ensemble, built in one
batched pass); the fused kernel's (S, 32) ``table`` continues each row with
the pre-shift optimal (12), the shifted optimal (12) and padding.
``meta`` (3,) int32 = (shift, do_shift, first) stays on the device, so an
update never waits on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, tracing
from ..graphs import GRAPH_SEED, HostInput
from ..models import frankaridgeback as fr
from ..models.model_data import PRISMATIC, RobotModel
from ..objectives.assisted_manipulation import (
    COLLISION_PAIRS,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from ..forecast.scenarios import reduce_scenarios
from ..ops.gaussian import sample_noise
from ..parallel.sharding import RolloutShards
from . import build
from .build import LAUNCHES, reset_launch_counts  # noqa: F401 (the port's one launch registry)
from .philox import normal_draws, seed_bits, shard_seed
from .lane_rollout import TrajectoryStepData, rollout_steps, states_with_tail, step_data

TABLE_WIDTH = 32
STEP_TABLE_WIDTH = 8
COL_TARGET, COL_INV2, COL_PCOST, COL_VTARGET, COL_DISC = 0, 3, 4, 5, 6
COL_OPTIMAL, COL_OPTSHIFT = 7, 19
# Shared memory one block of an H100 can use. Each kernel keeps its
# per-step tables there, beside its warp pair's state ring: 4 stages of
# (q, v) = 24 floats x 32 lanes, and 8 barriers of 8 bytes.
MAX_SHARED_BYTES = 232_448
STATE_RING_BYTES = 4 * 24 * 32 * 4 + 8 * 8
# The largest scenario count the two-pass kernel is compiled for
# (MAX_SCENARIOS in csrc/rollout.cu).
MAX_SCENARIOS = 8
# The longest horizon each fused kernel takes ((S, 32) table rows), and the
# most (C, S, 8) table rows of the two-pass kernel: 1,719 and 6,878. Each
# library exports its own (fsr_max_steps, irs_max_steps,
# ro_max_table_rows), checked against these when it loads.
FUSED_MAX_STEPS = (MAX_SHARED_BYTES - STATE_RING_BYTES) // (TABLE_WIDTH * 4)
INKERNEL_MAX_STEPS = FUSED_MAX_STEPS
ROLLOUT_MAX_TABLE_ROWS = (MAX_SHARED_BYTES - STATE_RING_BYTES) // (STEP_TABLE_WIDTH * 4)


# Hardware-neutral work of one rollout-step of the folded scalar graph,
# counted by walking the JAX step's jaxpr (assistedmanipulation_tpu/ops/
# flops.py: rollout_step_flops, count_fma_pairs): FLOPs, and FP32
# instructions once each mul->add pair issues as one FMA.
STEP_FLOPS = 4892
STEP_FP32_INSTRUCTIONS = 3301
# What each scenario beyond the first adds to a rollout-step of the two-pass
# kernel, counted from csrc/franka_step.cuh::add_trajectory_cost as flops.py
# counts (comparisons and selects free, a mul->add pair one FMA): the two
# dot products (3 + 3), * inv2, sqrt, * sqrt, the velocity error and its
# abs, q * e * e (2), pcost + ..., smooth + ... (15); then + manipulability
# and disc * step into the scenario's total (2).
SCENARIO_FP32_INSTRUCTIONS = 17
# What the in-kernel-RNG kernel adds at a rollout-step that draws: FP32
# issue slots of Box-Muller (6 pairs x (2 uniform conversions + 4 products)
# + 12 scalings = 48, and 24 log/sqrt/sin/cos at 1/8 of the FP32 rate =
# 192), and integer instructions of Philox (3 calls x 10 rounds x (2 high
# and 2 low products, 2 three-way xors, 2 key additions)) and the mantissa
# fill (12 x 2).
DRAW_FP32_SLOTS = 240
DRAW_INTEGER_INSTRUCTIONS = 264


def noise_to_logical(noise: torch.Tensor) -> torch.Tensor:
    """(S, 12, R) -> (R, S, 12) view."""
    return noise.permute(2, 0, 1)


def noise_from_logical(noise: torch.Tensor) -> torch.Tensor:
    """(R, S, 12) -> contiguous (S, 12, R)."""
    return noise.permute(1, 2, 0).contiguous()


class _Params(ctypes.Structure):
    """ctypes mirror of ``struct Params`` in csrc/franka_step.cuh."""

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
        self.topology_checked = set()  # libraries whose topology matched
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


def initial_state(x0: torch.Tensor) -> torch.Tensor:
    """init (32,) = q0, v0, energy, padding, from the (31,) plant state."""
    return torch.cat(
        [x0[:24], x0[fr.ENERGY:], torch.zeros(7, dtype=x0.dtype, device=x0.device)]
    )


def step_table(
    objective_cfg: ObjectiveConfiguration,
    steps: int,
    dt: float,
    discount: float,
    x0: torch.Tensor,
    time: torch.Tensor,
    ctx: Optional[ForecastContext],
) -> torch.Tensor:
    """The (S, 8) per-step table in x0's dtype and device: trajectory
    target, 1/|target|^2, position cost, velocity target, discount, 0. A
    scenario-ensemble ctx ((C, S+1, 6) horizons) gives the (C, S, 8) tables
    of all its scenarios in one batched pass."""
    traj = step_data(objective_cfg, ctx, time, steps, dt, x0)
    lead = traj.target.shape[:-1]  # (S,) or (C, S)
    discounts = discount ** torch.arange(steps, dtype=x0.dtype, device=x0.device)
    return torch.cat(
        [
            traj.target.to(x0.dtype),
            traj.inv_norm2.to(x0.dtype)[..., None],
            traj.position_cost.to(x0.dtype)[..., None],
            traj.velocity_target.to(x0.dtype)[..., None],
            discounts[:, None].expand(*lead, 1),
            torch.zeros((*lead, 1), dtype=x0.dtype, device=x0.device),
        ],
        dim=-1,
    )


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
    """The fused kernel's (init (32,), table (S, 32)) in x0's dtype and
    device."""
    table = step_table(objective_cfg, steps, dt, discount, x0, time, ctx)
    table = torch.cat(
        [
            table[:, :COL_OPTIMAL],
            optimal.to(x0.dtype),
            optimal_shifted.to(x0.dtype),
            table[:, COL_OPTIMAL:],
        ],
        dim=1,
    )
    return initial_state(x0), table


def assemble_noise(optimal, meta, old, fresh, keep):
    """The TPU kernel's noise select chain (pallas_rollout.py:350-363; the
    two-pass sampler's lane_noise_assemble, :673-730) over the whole
    (S, 12, R) batch: elite rows keep their old noise, shifted left by
    ``shift`` with a fresh tail when ``do_shift``; other rows take fresh
    noise; rows 0 and 1 of the first batch take 0 and -optimal (S, 12)."""
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
    return torch.where(
        row0, torch.zeros((), dtype=old.dtype, device=old.device),
        torch.where(row1, -optimal[:, :, None], sampled),
    )


def _plain_rollout(spec: RolloutSpec, init, table, controls, optimal):
    """The lane rollout over (S, 12, R) ``controls`` (+ ``optimal`` (S, 12)
    when not None) with the per-step data of ``table``'s first columns."""
    traj = TrajectoryStepData(
        target=table[:, COL_TARGET:COL_TARGET + 3],
        inv_norm2=table[:, COL_INV2],
        position_cost=table[:, COL_PCOST],
        velocity_target=table[:, COL_VTARGET],
        active=table[:, COL_INV2] > 0,
    )
    zeros = torch.zeros(6, dtype=init.dtype, device=init.device)
    x0 = torch.cat([init[:24], zeros, init[24:25]])
    return rollout_steps(
        spec.model, spec.objective_cfg, spec.kp, spec.kd, spec.dt, controls,
        optimal, x0, traj, table[:, COL_DISC],
    )


def fused_sample_rollout_reference(spec: RolloutSpec, init, table, meta, old, fresh, keep):
    """Plain PyTorch version of the fused kernel, same signature and outputs:
    ((S, 12, R) noise, (R, 2) cost channels, (S, 24) rollout-0 pre-step
    (q, v))."""
    noise = assemble_noise(table[:, COL_OPTIMAL:COL_OPTIMAL + 12], meta, old, fresh, keep)
    costs, states = _plain_rollout(
        spec, init, table, noise, table[:, COL_OPTSHIFT:COL_OPTSHIFT + 12]
    )
    return noise, costs, states


def inkernel_rng_sample_rollout_reference(spec: RolloutSpec, init, table, meta, old, keep, seed, scale):
    """Plain PyTorch version of the in-kernel-RNG kernel: the fused kernel's
    plain version fed the draws ``philox.normal_draws`` makes from ``seed``
    (2,) int32 and ``scale`` (12,). Same outputs as the fused kernel."""
    S, _, R = old.shape
    fresh = normal_draws(seed, S, R, scale.to(old.dtype))
    return fused_sample_rollout_reference(spec, init, table, meta, old, fresh, keep)


def fresh_mask(meta, keep, steps: int) -> torch.Tensor:
    """(S, 1, R) bool: where the select chain takes fresh noise, the same
    for every dof (the in-kernel-RNG kernel draws only there)."""
    shift, do_shift, first = meta[0], meta[1] != 0, meta[2] != 0
    col = torch.arange(steps, device=keep.device)[:, None, None]
    row = torch.arange(keep.shape[0], device=keep.device)
    static = first & (row < 2)
    return ~static & (~keep | (do_shift & (col >= steps - shift)))


def rollout_reference(spec: RolloutSpec, init, table, controls):
    """Plain PyTorch version of the two-pass kernel, same signature and
    outputs: absolute (S, 12, R) controls with the (S, 8) table -> ((R, 2)
    cost channels, (S, 24) rollout-0 pre-step (q, v)); with (C, S, 8)
    scenario tables the costs are (C, R, 2). It rolls the controls out once
    per scenario (the definition, not the kernel's once-only dynamics): in
    one pass over C x R lanes, lane c * R + r rolling rollout r against
    scenario c's per-step data, each lane's arithmetic that of a pass of its
    own; the states are scenario 0's."""
    if table.dim() == 2:
        return _plain_rollout(spec, init, table, controls, None)
    C, R = table.shape[0], controls.shape[2]

    def lanes(column):  # (C, S) -> (S, C x R): each scenario's value on its R lanes
        return column.mT.repeat_interleave(R, dim=1)

    traj = TrajectoryStepData(
        target=torch.stack([lanes(table[..., COL_TARGET + k]) for k in range(3)], dim=1),
        inv_norm2=lanes(table[..., COL_INV2]),
        position_cost=lanes(table[..., COL_PCOST]),
        velocity_target=lanes(table[..., COL_VTARGET]),
        active=lanes(table[..., COL_INV2]) > 0,
    )
    zeros = torch.zeros(6, dtype=init.dtype, device=init.device)
    x0 = torch.cat([init[:24], zeros, init[24:25]])
    costs, states = rollout_steps(
        spec.model, spec.objective_cfg, spec.kp, spec.kd, spec.dt, controls.repeat(1, 1, C),
        None, x0, traj, table[0, :, COL_DISC],
    )
    return costs.reshape(C, R, 2), states


def _check_tensors(expected: dict, device) -> None:
    for name, (tensor, dtype, shape) in expected.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, not {device}")
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(tensor.shape)}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_inputs(init, table, meta, old, keep, fresh=None, seed=None, scale=None) -> None:
    """The fused kernels' inputs: ``fresh`` for the fused kernel, ``seed``
    and ``scale`` for the in-kernel-RNG one, and a horizon within the
    kernel's shared memory (``FUSED_MAX_STEPS``, ``INKERNEL_MAX_STEPS``)."""
    S, _, R = old.shape
    expected = {
        "init": (init, torch.float32, (TABLE_WIDTH,)),
        "table": (table, torch.float32, (S, TABLE_WIDTH)),
        "meta": (meta, torch.int32, (3,)),
        "old": (old, torch.float32, (S, 12, R)),
        "keep": (keep, torch.bool, (R,)),
    }
    if fresh is not None and seed is None and scale is None:
        expected["fresh"] = (fresh, torch.float32, (S, 12, R))
        kernel, limit = "fused", FUSED_MAX_STEPS
    elif fresh is None and seed is not None and scale is not None:
        expected["seed"] = (seed, torch.int32, (2,))
        expected["scale"] = (scale, torch.float32, (12,))
        kernel, limit = "in-kernel-RNG", INKERNEL_MAX_STEPS
    else:
        raise ValueError("the fused kernels take fresh noise, or seed words and scales")
    _check_tensors(expected, old.device)
    if R < 1 or S < 1:
        raise ValueError("need at least one rollout and one step")
    if S > limit:
        raise ValueError(
            f"{S} steps: the {kernel} kernel keeps its (S, {TABLE_WIDTH}) table in shared "
            f"memory and takes at most {limit} steps; the two-pass sampler takes longer horizons"
        )


def _check_rollout_inputs(init, table, controls) -> None:
    """The two-pass kernel's inputs: an (S, 8) table or (C, S, 8) scenario
    tables with 1 <= C <= MAX_SCENARIOS, all C x S rows in shared memory
    (at most ROLLOUT_MAX_TABLE_ROWS)."""
    if controls.dim() != 3 or controls.shape[1] != 12:
        raise ValueError(f"controls must have shape (S, 12, R), got {tuple(controls.shape)}")
    S, _, R = controls.shape
    C = table.shape[0] if table.dim() == 3 else 1
    _check_tensors({
        "init": (init, torch.float32, (TABLE_WIDTH,)),
        "table": (table, torch.float32, (C, S, STEP_TABLE_WIDTH)[3 - table.dim():]),
        "controls": (controls, torch.float32, (S, 12, R)),
    }, controls.device)
    if R < 1 or S < 1:
        raise ValueError("need at least one rollout and one step")
    if not 1 <= C <= MAX_SCENARIOS:
        raise ValueError(f"{C} scenarios: the two-pass kernel is compiled for 1 to {MAX_SCENARIOS}")
    if C * S > ROLLOUT_MAX_TABLE_ROWS:
        raise ValueError(
            f"{C} scenarios x {S} steps: the (C, S, {STEP_TABLE_WIDTH}) tables exceed "
            f"the {ROLLOUT_MAX_TABLE_ROWS} rows that fit in a block's shared memory beside the state ring"
        )


# Exported-symbol prefix, pointer arguments (after the Params block) and
# integer arguments of each library's launch function.
_LIBRARIES = {
    "fused_sample_rollout": ("fsr", 11, 2),
    "rollout": ("ro", 5, 3),
    "inkernel_rng_sample_rollout": ("irs", 11, 2),
}


# Each library's shared-memory limit: its export and the wrapper's constant.
SHARED_MEMORY_LIMITS = {
    "fused_sample_rollout": ("fsr_max_steps", FUSED_MAX_STEPS),
    "inkernel_rng_sample_rollout": ("irs_max_steps", INKERNEL_MAX_STEPS),
    "rollout": ("ro_max_table_rows", ROLLOUT_MAX_TABLE_ROWS),
}


def exported_limit(lib, name: str) -> int:
    """The shared-memory limit a loaded library says its kernel takes: the
    fused kernels' longest horizon, the two-pass kernel's most table rows."""
    export = getattr(lib, SHARED_MEMORY_LIMITS[name][0])
    export.restype = ctypes.c_int
    export.argtypes = []
    return export()


def _library(spec: RolloutSpec, name: str):
    prefix, pointers, integers = _LIBRARIES[name]
    lib = build.load(name)
    params_bytes = getattr(lib, f"{prefix}_params_bytes")
    topology = getattr(lib, f"{prefix}_topology")
    if not getattr(lib, "_checked", False):
        params_bytes.restype = ctypes.c_int
        params_bytes.argtypes = []
        topology.restype = ctypes.c_int
        topology.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        launch = getattr(lib, f"{prefix}_launch")
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.c_void_p] * (1 + pointers) + [ctypes.c_int] * integers + [ctypes.c_void_p]
        if params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"{name}: kernel Params is {params_bytes()} bytes, the ctypes "
                f"mirror {ctypes.sizeof(_Params)}"
            )
        if name == "rollout" and lib.ro_max_scenarios() != MAX_SCENARIOS:
            raise RuntimeError(
                f"rollout: the library is compiled for {lib.ro_max_scenarios()} scenarios, "
                f"the wrapper expects {MAX_SCENARIOS}"
            )
        limit = SHARED_MEMORY_LIMITS[name][1]
        if exported_limit(lib, name) != limit:
            raise RuntimeError(
                f"{name}: the library's shared-memory limit is {exported_limit(lib, name)}, "
                f"the wrapper expects {limit}"
            )
        lib._checked = True
    if name not in spec.topology_checked:
        buffer = (ctypes.c_int * 256)()
        count = topology(buffer, 256)
        if list(buffer[:count]) != spec.topology():
            raise ValueError(
                f"the robot model's topology differs from the compiled {name} kernel's"
            )
        spec.topology_checked.add(name)
    return lib


def _sample_rollout(spec: RolloutSpec, name: str, init, table, meta, old, keep,
                    fresh=None, seed=None, scale=None):
    """Launch one of the two instantiations of csrc/sample_rollout.cuh's
    warp-pair kernel on CUDA tensors: the fused kernel reads ``fresh``, the
    in-kernel-RNG kernel draws from ``seed`` and ``scale`` (the other is
    passed as null)."""
    _check_kernel_inputs(init, table, meta, old, keep, fresh, seed, scale)
    lib = _library(spec, name)
    prefix = _LIBRARIES[name][0]
    S, _, R = old.shape
    noise = torch.empty_like(old)
    costs = torch.empty((R, 2), dtype=old.dtype, device=old.device)
    states = torch.empty((S, 24), dtype=old.dtype, device=old.device)

    def pointer(tensor):
        return None if tensor is None else tensor.data_ptr()

    with torch.cuda.device(old.device):
        err = getattr(lib, f"{prefix}_launch")(
            ctypes.addressof(spec.kernel_params()),
            init.data_ptr(), table.data_ptr(), meta.data_ptr(), old.data_ptr(),
            pointer(fresh), pointer(seed), pointer(scale), keep.data_ptr(),
            noise.data_ptr(), costs.data_ptr(), states.data_ptr(),
            R, S, torch.cuda.current_stream(old.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    build.count_launch(name)
    return noise, costs, states


def fused_sample_rollout(spec: RolloutSpec, init, table, meta, old, fresh, keep):
    """Fused noise assembly + rollout. CUDA tensors launch the kernel of
    csrc/fused_sample_rollout.cu (float32 only, at most FUSED_MAX_STEPS
    steps); CPU tensors take
    ``fused_sample_rollout_reference``. Returns ((S, 12, R) noise, (R, 2)
    costs, (S, 24) rollout-0 states)."""
    if old.device.type == "cpu":
        return fused_sample_rollout_reference(spec, init, table, meta, old, fresh, keep)
    if old.device.type != "cuda":
        raise ValueError(f"no fused rollout for device {old.device}")
    return _sample_rollout(spec, "fused_sample_rollout", init, table, meta, old, keep, fresh=fresh)


def inkernel_rng_sample_rollout(spec: RolloutSpec, init, table, meta, old, keep, seed, scale):
    """Fused noise assembly + rollout with the fresh draws made in the
    kernel from the (2,) int32 ``seed`` words and the (12,) ``scale``. CUDA
    tensors launch the kernel of csrc/inkernel_rng_sample_rollout.cu
    (float32 only, at most INKERNEL_MAX_STEPS steps); CPU tensors take
    ``inkernel_rng_sample_rollout_reference``. Returns ((S, 12, R) noise,
    (R, 2) costs, (S, 24) rollout-0 states)."""
    if old.device.type == "cpu":
        return inkernel_rng_sample_rollout_reference(spec, init, table, meta, old, keep, seed, scale)
    if old.device.type != "cuda":
        raise ValueError(f"no in-kernel-RNG rollout for device {old.device}")
    return _sample_rollout(
        spec, "inkernel_rng_sample_rollout", init, table, meta, old, keep, seed=seed, scale=scale
    )


def rollout(spec: RolloutSpec, init, table, controls):
    """Two-pass rollout of absolute (S, 12, R) controls with the (S, 8)
    per-step table, or against every scenario of an ensemble at once with
    (C, S, 8) tables. CUDA tensors launch the kernel of csrc/rollout.cu once
    (float32 only, C <= MAX_SCENARIOS, C x S <= ROLLOUT_MAX_TABLE_ROWS); CPU
    tensors take ``rollout_reference``. Returns ((R, 2) costs, or (C, R, 2)
    for scenario tables, and (S, 24) rollout-0 states)."""
    if controls.device.type == "cpu":
        return rollout_reference(spec, init, table, controls)
    if controls.device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {controls.device}")
    _check_rollout_inputs(init, table, controls)
    lib = _library(spec, "rollout")
    S, _, R = controls.shape
    C = table.shape[0] if table.dim() == 3 else 1
    costs = torch.empty((C, R, 2), dtype=controls.dtype, device=controls.device)
    states = torch.empty((S, 24), dtype=controls.dtype, device=controls.device)
    with torch.cuda.device(controls.device):
        err = lib.ro_launch(
            ctypes.addressof(spec.kernel_params()),
            init.data_ptr(), table.data_ptr(), controls.data_ptr(),
            costs.data_ptr(), states.data_ptr(),
            R, S, C, torch.cuda.current_stream(controls.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rollout launch failed: CUDA error {err}")
    build.count_launch("rollout")
    return (costs if table.dim() == 3 else costs[0]), states


def _to_device(words: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host seed words on ``device``: through pinned memory with a
    non-blocking copy to a card, so the update never waits on it."""
    if device.type == "cuda":
        return words.pin_memory().to(device, non_blocking=True)
    return words.to(device)


def make_cuda_rollout_fn(
    model: RobotModel,
    objective_cfg: ObjectiveConfiguration,
    robot_cfg: fr.Configuration,
    steps: int,
    dt: float,
    discount: float = 1.0,
    device="cuda",
):
    """Rollout evaluator in the logical layout, the counterpart of
    make_pallas_rollout_fn (pallas_rollout.py:542-670):
    ``fn(noise (R, S, 12), optimal_shifted (S, 12), x0 (31,), time, ctx)
    -> ((R, 2) costs, (S, 31) rollout-0 pre-step states)``, one launch of
    the two-pass kernel on ``device`` (the plain version on the CPU)."""
    spec = RolloutSpec(model, objective_cfg, robot_cfg, dt)
    device = resolve_device(device)

    def fn(noise, optimal_shifted, x0, time, ctx):
        noise = noise.to(device)
        dtype = noise.dtype
        controls = noise_from_logical(noise + optimal_shifted.to(device=device, dtype=dtype)[None])
        x0 = x0.to(device=device, dtype=dtype)
        time = torch.as_tensor(time, dtype=dtype).to(device)
        table = step_table(objective_cfg, steps, dt, discount, x0, time, ctx)
        costs, qv = rollout(spec, initial_state(x0), table, controls)
        return costs, states_with_tail(qv, x0)

    return fn


def make_cuda_filter_rollout_fn(
    model: RobotModel,
    objective_cfg: ObjectiveConfiguration,
    robot_cfg: fr.Configuration,
    steps: int,
    dt: float,
    discount: float = 1.0,
    device="cuda",
):
    """The optimal re-rollout of mppi.Planner's resimulate mode, the
    counterpart of the JAX planner's ``filter_rollout_fn`` (mppi.py:238-241,
    :659-661) with no safety filter: ``fn(optimal (S, 12), x0 (31,), time,
    ctx) -> ((2,) cost channels, (S, 31) pre-step states)`` of the one
    control sequence, one launch of the two-pass kernel at R = 1 on the card
    (the plain version on the CPU). A scenario-ensemble ctx is scored on
    its nominal scenario only, as the JAX objective reads ``horizon[0]`` for
    the re-rollout (objectives/assisted_manipulation.py:65-69)."""
    spec = RolloutSpec(model, objective_cfg, robot_cfg, dt)
    device = resolve_device(device)

    def fn(optimal, x0, time, ctx):
        dtype = optimal.dtype
        controls = optimal.to(device)[:, :, None].contiguous()  # (S, 12, 1)
        x0 = x0.to(device=device, dtype=dtype)
        time = torch.as_tensor(time, dtype=dtype).to(device)
        if ctx is not None and ctx.wrench_horizon.ndim == 3:
            ctx = ctx._replace(wrench_horizon=ctx.wrench_horizon[0])
        table = step_table(objective_cfg, steps, dt, discount, x0, time, ctx)
        costs, qv = rollout(spec, initial_state(x0), table, controls)
        return costs[0], states_with_tail(qv, x0)

    return fn


class CudaSampler:
    """Sampling + rollout backend for mppi.Planner on one device; the noise
    lives in the kernels' (S, 12, R) layout end to end.

    ``fused_assembly=True``: one launch of the fused kernel per update
    assembles the noise and scores every rollout (a single forecast only;
    at most FUSED_MAX_STEPS steps on the card). Its fresh draws come from
    ``torch.randn`` under the sampler's generator, seeded with the update's
    seed words.
    ``False``, the two-pass sampler (PallasSampler with fused_assembly=False,
    pallas_rollout.py:1356-1371): the noise is assembled in plain PyTorch
    (``assemble_noise``), ``controls = noise + optimal_shifted`` go through
    one launch of the two-pass kernel against every forecast scenario (the
    (C, S, 8) tables built in one batched pass), and the costs are the
    scenario mean (risk-neutral; a NaN in any scenario poisons the rollout,
    pallas_rollout.py:1096-1128). The noise is bitwise the same either way.

    ``inkernel_rng=True`` (PallasSampler with inkernel_rng=True,
    pallas_rollout.py:1225-1321): fused assembly with the fresh draws made
    in the kernel, one launch of the in-kernel-RNG kernel per update, which
    takes the update's seed words as its Philox key; no fresh-noise tensor
    exists. It refuses a scenario ensemble, and
    refuses ``fresh=``: there is no draw to replace, and a quiet switch to
    the fused kernel would hide the kernel under test.

    ``shards`` (parallel/sharding.RolloutShards; the JAX sampler's
    ``shards``/``mesh``, pallas_rollout.py:763-775): the batch in contiguous
    blocks of R / n rollouts, one kernel launch per block, each under the
    block's own seed words (``philox.shard_seed``: the generator's seed, or
    the in-kernel key) and only block 0 holding static rollouts 0 and 1
    (``meta[2]``, the kernels' ``first``). Without a mesh the blocks run in
    turn (each a contiguous copy of its columns of the (S, 12, R) noise,
    the results joined back); on a mesh this rank runs its block, holds
    that block of the noise, gathers every block's costs, takes rollout 0's
    states from the first block's rank and, on a scenario axis, scores its
    slice of the ensemble and gathers the scenario costs before the mean.
    The weighted noise sum adds the blocks' partials in block order. One
    shard is the unsharded sampler, unchanged.

    Protocol (the one mppi.Planner's JAX counterpart uses for PallasSampler):
    - init_noise(dtype) -> noise representation
    - sample_and_rollout(seed, keep_mask, shift_by, do_shift, old,
      optimal, optimal_shifted, x0, time, ctx, fresh=None)
      -> ((R, 2) costs, noise, (S, 31) rollout-0 states); ``seed`` is the
      update's (2,) int32 seed words on the host (``philox.split_key`` of
      the planner's key), the whole of its randomness
    - weighted_noise_sum(noise, (R,) weights) -> (S, 12)

    A captured update (mppi.Planner.capture) passes ``graphs.GRAPH_SEED``
    as the seed: the sampler then draws from its generators as the host left
    them (``seed_replay`` seeds each before each replay, with its shard's 64
    bits, so a replay draws what the eager update draws), and the in-kernel
    sampler's seed words come through pinned host buffers that the graph
    copies to the card (``HostInput``). ``graph_rng()`` names the generators
    and host buffers a capture must register.

    Diagonal covariance only (the robot default, base.hpp:79-94): the
    kernels scale their draws per dof. A full covariance runs on a
    ``Plant`` planner, e.g. with ``make_cuda_rollout_fn`` as its rollout
    (the JAX package's ``make_pallas_planner(fused_sampling=False)``)."""

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
        fused_assembly: bool = True,
        inkernel_rng: bool = False,
        shards=None,
    ):
        self.spec = RolloutSpec(model, objective_cfg, robot_cfg, dt)
        self.inkernel_rng = inkernel_rng
        self.fused_assembly = fused_assembly or inkernel_rng
        self.rollouts = rollout_count
        self.steps = steps
        self.dof = 12
        self.device = resolve_device(device)
        self.shards = shards or RolloutShards(rollout_count)
        self._diag_scale = np.asarray(diag_scale, np.float64)
        if self._diag_scale.ndim != 1:
            raise ValueError("fused_sampling requires a diagonal covariance")
        self._objective_cfg = objective_cfg
        self._discount = discount
        self._dt = dt
        self._first = {
            shard: torch.full((), int(shard == 0), dtype=torch.int32, device=self.device)
            for shard in self.shards.local
        }
        self._scales = {}
        self._generators = [torch.Generator(device=self.device) for _ in self.shards.local]
        self._seed_inputs = None  # the seed words' HostInputs, made at the first capture

    def init_noise(self, dtype):
        return torch.zeros(
            (self.steps, self.dof, self.rollouts), dtype=dtype, device=self.device
        )

    def graph_rng(self):
        """(generators, host inputs) a captured update reads its randomness
        from: one generator per shard of the fused and two-pass samplers,
        one pinned buffer of seed words per shard of the in-kernel one."""
        if not self.inkernel_rng:
            return tuple(self._generators), ()
        if self._seed_inputs is None:
            self._seed_inputs = [HostInput((2,), torch.int32, self.device) for _ in self.shards.local]
        return (), tuple(self._seed_inputs)

    def seed_replay(self, seed) -> None:
        """Before a replay of a captured update: each shard's seed words
        (from the update's (2,) host words) into its generator, or into the
        pinned buffer the graph copies."""
        for k, shard in enumerate(self.shards.local):
            words = shard_seed(seed, shard)
            if self.inkernel_rng:
                self._seed_inputs[k].write(words)
            else:
                self._generators[k].manual_seed(seed_bits(words))

    def sample_and_rollout(
        self, seed, keep_mask, shift_by, do_shift, old, optimal,
        optimal_shifted, x0, time, ctx, fresh=None,
    ):
        """``fresh`` (S, 12, R): N(0, cov) draws to use instead of drawing
        from ``seed`` (the parity tests feed the JAX draws here). ``seed``
        ``graphs.GRAPH_SEED``: in a capture (see the class). Device spans
        (``tracing.mark``): ``sampler.kernel`` is each rollout kernel's
        launch alone, ``sampler.draws`` the rest (the kernel's inputs, the
        draws, the assembly and the joined outputs)."""
        tracing.mark("sampler.draws")
        if old.dtype not in self._scales:
            self._scales[old.dtype] = torch.as_tensor(
                self._diag_scale, dtype=old.dtype
            ).to(self.device)
        scale = self._scales[old.dtype]
        if self.inkernel_rng and fresh is not None:
            raise ValueError(
                "inkernel_rng draws the fresh noise in the kernel; there "
                "are no fresh= draws to replace"
            )
        if self.fused_assembly:
            if ctx is not None and ctx.wrench_horizon.ndim == 3:
                raise ValueError(
                    "fused_assembly cannot score a scenario-ensemble ctx; "
                    "use the two-pass sampler (fused_assembly=False)"
                )
            init, table = rollout_inputs(
                self._objective_cfg, self.steps, self._dt, self._discount, x0,
                time, ctx, optimal, optimal_shifted,
            )
        else:
            init = initial_state(x0)
            table = step_table(self._objective_cfg, self.steps, self._dt, self._discount, x0, time, ctx)
            if table.dim() == 2:
                table = table[None]
        shards = self.shards
        noises, costs, states = [], [], []
        for k, shard in enumerate(shards.local):
            held = shards.held_block(old, shard)
            keep = shards.block(keep_mask, shard, 0)
            meta = torch.stack([shift_by.to(torch.int32), do_shift.to(torch.int32), self._first[shard]])
            if self.inkernel_rng:
                words = (self._seed_inputs[k].load() if seed is GRAPH_SEED
                         else _to_device(shard_seed(seed, shard), self.device))
                tracing.mark("sampler.kernel")
                noise, block_costs, qv = inkernel_rng_sample_rollout(
                    self.spec, init, table, meta, held, keep, words, scale
                )
                tracing.mark("sampler.draws")
            else:
                if fresh is not None:
                    draws = shards.block(fresh, shard)
                else:
                    if seed is not GRAPH_SEED:
                        self._generators[k].manual_seed(seed_bits(shard_seed(seed, shard)))
                    draws = sample_noise(self._generators[k], scale, held.shape, dim=1)
                if self.fused_assembly:
                    tracing.mark("sampler.kernel")
                    noise, block_costs, qv = fused_sample_rollout(
                        self.spec, init, table, meta, held, draws, keep
                    )
                    tracing.mark("sampler.draws")
                else:
                    noise = assemble_noise(optimal.to(old.dtype), meta, held, draws, keep)
                    controls = noise + optimal_shifted.to(old.dtype)[:, :, None]
                    tracing.mark("sampler.kernel")
                    scenario_costs, qv = rollout(self.spec, init, table, controls)
                    tracing.mark("sampler.draws")
                    # (C, R / n, 2) -> the risk-neutral scenario mean, over
                    # the whole ensemble on a scenario axis; the states are
                    # scenario 0's (the dynamics do not read the forecast).
                    block_costs = reduce_scenarios(shards.gather_scenarios(scenario_costs))
            noises.append(noise)
            costs.append(block_costs)
            states.append(qv)
        return shards.gather(costs), shards.join(noises), states_with_tail(shards.first(states), x0)

    def weighted_noise_sum(self, noise, weights):
        return self.shards.weighted_noise_sum(noise, weights)

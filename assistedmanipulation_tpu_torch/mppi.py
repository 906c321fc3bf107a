"""MPPI trajectory optimizer (port of assistedmanipulation_tpu/mppi.py).

One ``Planner.update`` (mppi::Trajectory::update, mppi.cpp:154-187 of the
C++ reference):

1. ``_sample_meta``: horizon shift, elite keep mask from the last costs,
   shifted optimal sequence (mppi.cpp:189-231);
2. the sampler draws fresh N(0, covariance) noise, assembles the rollout noise
   (elite reuse, zero and negated-optimal static rollouts) and scores every
   rollout — one fused kernel launch on the GPU (kernels/cuda_rollout.py),
   or, for a planner built on a ``Plant`` alone, the plant rolled out over
   the whole batch in plain PyTorch (``PlantSampler``, the JAX planner's
   generic vmap path, mppi.py:524-574);
3. ``_optimise``: NaN-masked min/max-normalised softmax over the two cost
   channels, weighted noise sum, gradient step, Savitzky-Golay smoothing
   and clipping (mppi.cpp:344-448);
4. the published optimal rollout: in optimal_rollout_mode "resimulate"
   (the default, as in the JAX package) the new optimal sequence re-rolled
   (mppi::Trajectory::filter, mppi.cpp:450-479): by ``filter_rollout_fn``
   when there is no safety filter, else through the plant, with the
   per-step ``filter_fn`` applied and the filtered controls written back
   into the published sequence; in "batch" rollout 0 (zero noise on the
   shifted optimal), its cost and states read from the batch, one update
   early — unless a ``filter_fn`` is attached, which always re-rolls.

Everything stays on the device between updates: no step reads a value back
to the host. The state is an explicit ``PlannerState`` and an update is a
function of it: its ``rng`` is a key of two uint32 words held on the host,
which each update splits into the next key and the update's seed words
(``kernels/philox.split_key``), as the JAX planner splits its key.

``Planner.capture`` records the device part of an update as one CUDA graph
(``CapturedUpdate``), the counterpart of the JAX planner's
``jax.jit(self._update_impl, donate_argnums=0)``: the key split stays on the
host, and each call replays the graph once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import graphs, resolve_device
from .config import from_json
from .kernels.philox import key_from_seed, seed_bits, shard_seed, split_key
from .ops import constant, per_step, take_rows
from .ops.costs import MAXIMUM_COST_DEFAULT
from .ops.gaussian import is_diagonal, noise_factor, sample_noise
from .ops.sg_filter import SGSmoother, sg_smooth
from .parallel.sharding import RolloutShards, shard_rollout_fn

# Static rollouts: index 0 carries zero noise, index 1 carries the negated
# previous optimal control (mppi.cpp:264-269, mppi.hpp s_static_rollouts).
STATIC_ROLLOUTS = 2

# Configuration.elite_select's choices.
ELITE_SELECTS = ("lexsort", "threshold")

# Composition scale for the two-channel (saturations, smooth) cost — equals
# the barriers' maximum_cost, so the composed scalar matches the reference's
# float64 totals.
BARRIER_SCALE = MAXIMUM_COST_DEFAULT


def as_cost_channels(cost: torch.Tensor, batch_shape) -> torch.Tensor:
    """A plant cost of ``batch_shape`` states as (saturations, smooth)
    channels (..., 2): a scalar cost per state is pure smooth; a (..., 2)
    cost is already channelled (the robot objectives count barrier
    saturations apart, ops/costs.py)."""
    if tuple(cost.shape) == tuple(batch_shape):
        return torch.stack([torch.zeros_like(cost), cost], dim=-1)
    return cost


def compose_cost(channels: torch.Tensor) -> torch.Tensor:
    """Composed scalar cost = saturations * BARRIER_SCALE + smooth (lossy in
    f32; for logging only, never for weighting)."""
    return channels[..., 0] * BARRIER_SCALE + channels[..., 1]


@dataclasses.dataclass
class Smoothing:
    window: int = 10
    order: int = 1


@dataclasses.dataclass
class Configuration:
    """Mirror of mppi::Configuration (reference mppi.hpp:242-248 and the
    defaults at src/test/case/base.hpp:69-101)."""

    rollouts: int = 50
    keep_best_rollouts: int = 20
    time_step: float = 0.01
    horizon: float = 0.3
    gradient_step: float = 2.0
    cost_scale: float = 10.0
    cost_discount_factor: float = 1.0
    covariance: Optional[np.ndarray] = None
    control_bound: bool = True
    control_min: Optional[np.ndarray] = None
    control_max: Optional[np.ndarray] = None
    control_default: Optional[np.ndarray] = None
    initial_state: Optional[np.ndarray] = None
    smoothing: Optional[Smoothing] = None
    dtype: str = "float32"
    # Elite selection strategy; only the keep_best boundary is observable
    # (mppi.cpp:219-231):
    # - "lexsort": a full lexicographic sort over (V, S, index);
    # - "threshold": two-stage counting-threshold select (top-k on V, then
    #   top-k on S within the V-boundary tie set, index tiebreak), the same
    #   keep set bit for bit without a total order.
    elite_select: str = "lexsort"
    # How the published optimal rollout's cost and states are obtained:
    # "resimulate" re-rolls the new optimal sequence through the planner's
    # filter_rollout_fn (the JAX default; the port has no plant re-rollout
    # yet, so a Planner in this mode needs the hook); "batch" reads rollout
    # 0's from the batch, one update early.
    optimal_rollout_mode: str = "resimulate"

    @property
    def step_count(self) -> int:
        return int(math.ceil(self.horizon / self.time_step))

    @property
    def rollout_count(self) -> int:
        return self.rollouts + STATIC_ROLLOUTS


class Plant(NamedTuple):
    """Pure-function dynamics + cost bundle over a batch of states (the
    reference's mppi::Dynamics / mppi::Cost subclasses, mppi.hpp:30-145):

    - ``derive(x, t, ctx) -> aux``: derived quantities of the states (FK,
      Jacobians, mass matrix, end-effector state, ...) — the analog of
      RaisimDynamics::calculate (raisim_dynamics.cpp:150-204), computed
      once per step and shared by cost and integrate;
    - ``cost(x, u, aux, t, ctx) -> (..., 2)`` cost channels, or (...) smooth
      cost, per state — Cost::get_cost. NaN poisons the rollout
      (mppi.cpp:331-334);
    - ``integrate(x, u, aux, t, dt, ctx) -> x_next`` — Dynamics::step
      (raisim_dynamics.cpp:255-264).

    ``x`` is (..., state_dof) and ``u`` (..., control_dof): the batch
    rollout passes every rollout's state at once (R, state_dof), the
    re-rollout one (state_dof,). ``t`` is a 0-d tensor shared by the
    batch; ``ctx`` the per-update context ``Planner.update`` forwards (the
    forecast horizon the objective reads). The JAX package's plant takes
    one state and is vmapped."""

    derive: Callable
    cost: Callable
    integrate: Callable
    state_dof: int
    control_dof: int


class PlannerState(NamedTuple):
    """Everything the controller carries between updates (the reference's
    mutable Trajectory members, mppi.hpp:600-650)."""

    optimal_control: torch.Tensor  # (steps, dof) published control sequence
    noise: torch.Tensor  # the sampler's noise representation (elite reuse)
    costs: torch.Tensor  # (R, 2) rollout cost channels from the last update
    last_shift_time: torch.Tensor  # 0-d: time the horizon was last aligned to
    last_update_time: torch.Tensor  # 0-d: time of the last publish
    sg_buffer: torch.Tensor  # (dof, L) smoothing history ((0, 0) if disabled)
    sg_time: torch.Tensor  # 0-d: time sg_buffer was last filled (NaN before)
    rng: torch.Tensor  # (2,) int64 uint32 key words on the host, split per update
    update_count: torch.Tensor  # 0-d int32
    optimal_cost: torch.Tensor  # 0-d: cost of the optimal rollout (logging)
    update_duration: torch.Tensor  # 0-d seconds, host-measured (logging)


class UpdateInfo(NamedTuple):
    """Per-update observability outputs (logger::MPPI's costs, weights and
    gradient CSVs, src/logging/mppi.cpp:23-72)."""

    costs: torch.Tensor  # (R,) composed
    weights: torch.Tensor  # (R,)
    gradient: torch.Tensor  # (steps, dof)
    optimal_rollout_states: torch.Tensor  # (steps, state_dof)
    optimal_cost: torch.Tensor
    degenerate: torch.Tensor  # True when max-min < 1e-6 (update skipped)


def _shift_columns(array: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Shift ``array`` left along axis 0 by a tensor ``shift``, replicating
    the final entry (mppi.cpp:204-206)."""
    length = array.shape[0]
    index = torch.clamp(torch.arange(length, device=array.device) + shift, max=length - 1)
    return array[index]


def _lexsort(keys) -> torch.Tensor:
    """Indices that sort by the last key, then the one before, ... — numpy's
    lexsort, as chained stable sorts from the least significant key."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def threshold_keep_mask(V: torch.Tensor, S: torch.Tensor, is_static: torch.Tensor, keep: int) -> torch.Tensor:
    """The ``keep`` (> 0) rollouts first in (V, S, index) order, statics
    excluded (their V and S are +inf), without a total order: the K-th
    smallest V, then among V equal to it the (K - #{V < kthV})-th smallest
    S; ties on (V, S) at the boundary go to the lower index (mppi.py:435-458
    of the JAX package). The same mask as the lexsort's, bit for bit."""
    kth_v = torch.topk(V, keep, largest=False).values[-1]
    less_v = V < kth_v
    eq_v = V == kth_v
    s_in_tie = torch.where(eq_v, S, torch.full_like(S, float("inf")))
    sorted_s = torch.topk(s_in_tie, keep, largest=False).values  # ascending
    below = torch.sum(less_v.to(torch.int32))
    kth_s = sorted_s.gather(0, torch.clamp(keep - below - 1, 0, keep - 1).long().reshape(1))[0]
    lex_less = less_v | (eq_v & (S < kth_s))
    boundary = eq_v & (S == kth_s) & ~is_static
    boundary_rank = torch.cumsum(boundary.to(torch.int32), 0) - 1
    remaining = keep - torch.sum(lex_less.to(torch.int32))
    return (lex_less | (boundary & (boundary_rank < remaining))) & ~is_static


class PlantSampler:
    """The sampler protocol of ``Planner`` (kernels/cuda_rollout.CudaSampler
    has the same methods) in plain PyTorch for a ``Plant``: the JAX
    planner's sampling (mppi.py:475-522) and generic batch rollout
    (mppi.py:524-574), with the noise in the port's (S, dof, R) layout so
    that ``_optimise``, interop and capture are shared with the kernel path.
    The noise is assembled by ``cuda_rollout.assemble_noise`` (the kernels'
    plain select chain); the fresh draws come from the sampler's generator,
    seeded with the update's seed words, or are given (``fresh=``, or
    ``noise_override=``: every sampled row, JAX's parity hook).

    ``rollout_fn(noise (R, S, dof), optimal_shifted, x0, time, ctx) ->
    (R, 2) costs or ((R, 2), (S, state_dof) rollout-0 states)`` replaces the
    batch rollout (e.g. forecast/scenarios.make_scenario_rollout_fn around
    ``rollout``).

    ``factor`` (ops/gaussian.noise_factor): the (dof,) standard deviations
    of a diagonal covariance, which scale the standard normals elementwise,
    or the (dof, dof) transform T of a full one, which maps them over the
    dof axis (the JAX planner's ``z @ T.T``, mppi.py:486-490).

    ``shards`` (parallel/sharding.RolloutShards): the batch in contiguous
    blocks, each assembled from its own draws (seed words
    ``philox.shard_seed``) and rolled out on its own, static rows 0 and 1 in
    block 0; the weighted noise sum adds the blocks' partials in block
    order. On a mesh this process runs its block only, and its rollout
    returns every rollout's costs: there ``rollout_fn`` takes the block and
    gathers (``sharding.shard_rollout_fn``, which wraps the plant rollout
    when no rollout_fn is given)."""

    def __init__(self, plant: Plant, rollout_count: int, steps: int, dt: float, factor,
                 discount: float = 1.0, device="cuda", rollout_fn=None, shards=None):
        self.plant = plant
        self.rollouts = rollout_count
        self.steps = steps
        self.dof = plant.control_dof
        self.device = resolve_device(device)
        self.shards = shards or RolloutShards(rollout_count)
        if self.shards.distributed and rollout_fn is None:
            from .kernels.cuda_rollout import noise_from_logical

            rollout_fn = shard_rollout_fn(
                lambda noise, *args: self._plant_rollout(noise_from_logical(noise), *args),
                self.shards.mesh, scenario_axis=self.shards.scenario_axis,
            )
        self.rollout_fn = rollout_fn
        self._dt = dt
        self._discount = float(discount)
        self._factor = np.asarray(factor, np.float64)
        self._first = {
            shard: torch.full((), int(shard == 0), dtype=torch.int32, device=self.device)
            for shard in self.shards.local
        }
        self._generators = [torch.Generator(device=self.device) for _ in self.shards.local]

    def init_noise(self, dtype):
        return torch.zeros((self.steps, self.dof, self.rollouts), dtype=dtype, device=self.device)

    def graph_rng(self):
        return tuple(self._generators), ()

    def seed_replay(self, seed) -> None:
        for generator, shard in zip(self._generators, self.shards.local):
            generator.manual_seed(seed_bits(shard_seed(seed, shard)))

    def sample_and_rollout(self, seed, keep_mask, shift_by, do_shift, old, optimal,
                           optimal_shifted, x0, time, ctx, fresh=None, noise_override=None):
        """``fresh`` (S, dof, R): the N(0, cov) draws to use; elite rows
        still keep their noise. ``noise_override`` (S, dof, R - 2): the
        sampled rows 2.. themselves (elite rows included), as the JAX
        planner's ``noise_override``."""
        from .kernels.cuda_rollout import assemble_noise

        shards = self.shards
        if noise_override is not None:
            statics = torch.zeros((*old.shape[:2], STATIC_ROLLOUTS), dtype=old.dtype, device=old.device)
            fresh = torch.cat([statics, noise_override.to(old.dtype)], dim=2)
            keep_mask = torch.zeros_like(keep_mask)
        factor = constant(self._factor, old)
        blocks = []
        for generator, shard in zip(self._generators, shards.local):
            held = shards.held_block(old, shard)
            if fresh is not None:
                draws = shards.block(fresh, shard)
            else:
                if seed is not graphs.GRAPH_SEED:
                    generator.manual_seed(seed_bits(shard_seed(seed, shard)))
                draws = sample_noise(generator, factor, held.shape, dim=1)
            meta = torch.stack([shift_by.to(torch.int32), do_shift.to(torch.int32), self._first[shard]])
            noise = assemble_noise(optimal.to(old.dtype), meta, held, draws, shards.block(keep_mask, shard, 0))
            blocks.append((noise, *self.rollout(noise, optimal_shifted, x0, time, ctx)))
        noise = shards.join([block[0] for block in blocks])
        if shards.distributed:  # the rollout_fn gathered the costs and broadcast the states
            return blocks[0][1], noise, blocks[0][2]
        return shards.gather([block[1] for block in blocks]), noise, blocks[0][2]

    def rollout(self, noise, optimal_shifted, x0, time, ctx):
        """Batched rollouts (mppi.cpp:272-342): the horizon loop over the
        batch step, accumulating discounted cost channels with NaN
        poisoning. Returns ((R, 2) cost channels, (S, state_dof) rollout-0
        pre-step states)."""
        if self.rollout_fn is not None:
            from .kernels.cuda_rollout import noise_to_logical

            out = self.rollout_fn(noise_to_logical(noise), optimal_shifted, x0, time, ctx)
            if isinstance(out, tuple):
                return out
            # Costs alone: no rollout-0 states to publish in batch mode.
            return out, torch.zeros((self.steps, self.plant.state_dof), dtype=noise.dtype, device=noise.device)
        return self._plant_rollout(noise, optimal_shifted, x0, time, ctx)

    def _plant_rollout(self, noise, optimal_shifted, x0, time, ctx):
        controls = (noise + optimal_shifted.to(noise.dtype)[:, :, None]).mT  # (S, R, dof)
        x = x0.to(noise.dtype).expand(noise.shape[2], x0.shape[-1])
        # Rollout 0's pre-step states (the zero-noise static rollout).
        channels, states0, _ = plant_rollout(
            self.plant, controls, x, time, ctx, self._dt, self._discount, record=lambda x: x[0]
        )
        return channels, states0

    def weighted_noise_sum(self, noise, weights):
        return self.shards.weighted_noise_sum(noise, weights)


def plant_rollout(plant: Plant, controls, x0, time, ctx, dt: float, discount: float = 1.0,
                  filter_fn=None, record=None):
    """Roll ``plant`` out from ``x0`` (..., state_dof) under ``controls``
    (S, ..., dof) (mppi.cpp:272-342 for a batch, mppi.cpp:450-479 for the
    optimal sequence): per step derive, cost, integrate, the discounted
    cost channels accumulated with NaN poisoning. ``filter_fn(x, u, t)``
    filters each step's control first. Returns ((..., 2) cost channels,
    the (S, ...) stack of ``record(x)`` of each pre-step state (the state
    itself by default), the (S, ..., dof) controls applied)."""
    steps = controls.shape[0]
    k = torch.arange(steps, dtype=controls.dtype, device=controls.device)
    times, discounts = time.to(controls.dtype) + k * dt, discount ** k
    batch = x0.shape[:-1]
    x = x0
    total = torch.zeros((*batch, 2), dtype=controls.dtype, device=controls.device)
    states, applied = [], []
    for step in range(steps):
        t, u = times[step], controls[step]
        if filter_fn is not None:
            u = filter_fn(x, u, t).to(u.dtype)
        aux = plant.derive(x, t, ctx)
        step_cost = as_cost_channels(plant.cost(x, u, aux, t, ctx), batch).to(total.dtype)
        total = total + step_cost * discounts[step]  # NaN = poisoning
        states.append(x if record is None else record(x))
        applied.append(u)
        x = plant.integrate(x, u, aux, t, dt, ctx)
    return total, torch.stack(states), (torch.stack(applied) if filter_fn is not None else controls)


class Planner:
    """The MPPI update and query. Construction validates the configuration
    like mppi::Trajectory::create (mppi.cpp:11-77) but raises instead of
    returning nullptr.

    The batch goes through a ``sampler`` (kernels/cuda_rollout.CudaSampler:
    it owns the noise layout, the rollout and the weighted noise sum) or,
    given a ``plant`` alone (``Planner(configuration, plant)``, as the JAX
    planner is built), through ``PlantSampler``: the plant rolled out over
    the batch in plain PyTorch, or the ``rollout_fn`` given in its place.

    ``filter_rollout_fn(optimal, x0, time, ctx) -> ((2,) cost channels,
    (steps, state_dof) states)``: the optimal re-rollout of resimulate mode
    when no ``filter_fn`` is attached (the JAX Planner's hook of that name,
    mppi.py:238-241; kernels/cuda_rollout.make_cuda_filter_rollout_fn);
    without it the re-rollout runs through the plant.

    ``filter_fn(x, u, t) -> u_safe`` is the per-step trajectory filter
    (mppi::Filter, mppi.hpp:150-176; safety.make_safety_filter) applied in
    the optimal re-rollout through the plant, in either optimal-rollout
    mode; the filtered controls are written back into the published
    sequence (mppi.cpp:460-466). It needs ``plant``.

    ``shards`` (parallel/sharding.RolloutShards) splits a plant planner's
    batch into rollout shards, run in turn or one per rank of a mesh
    (``PlantSampler``); a kernel sampler carries its own. The update is the
    same code either way: the sampler returns every rollout's costs and
    reduces the weighted noise sum over the shards."""

    def __init__(
        self,
        configuration: Configuration,
        sampler=None,
        control_dof: Optional[int] = None,
        device="cuda",
        filter_rollout_fn=None,
        plant: Optional[Plant] = None,
        rollout_fn=None,
        filter_fn=None,
        shards=None,
    ):
        cfg = configuration
        if isinstance(sampler, Plant):
            if plant is not None:
                raise ValueError("a Planner takes one plant")
            plant, sampler = sampler, None
        if sampler is not None and rollout_fn is not None:
            raise ValueError("sampler and rollout_fn are mutually exclusive")
        if control_dof is None:
            if plant is None:
                raise ValueError("a Planner built on a sampler needs control_dof")
            control_dof = plant.control_dof
        dof = control_dof
        if cfg.covariance is None:
            raise ValueError("mppi configuration requires a covariance")
        covariance = np.asarray(cfg.covariance, dtype=np.float64)
        if covariance.ndim == 1:
            covariance = np.diag(covariance)
        if covariance.shape != (dof, dof):
            raise ValueError(f"covariance shape {covariance.shape} != control dof {dof}")
        if cfg.rollouts < 1:
            raise ValueError("rollouts must be greater than zero")
        if cfg.keep_best_rollouts < 0:
            raise ValueError("keep_best_rollouts cannot be negative")
        if cfg.control_min is None or cfg.control_max is None:
            raise ValueError("control bounds are required")
        if len(np.asarray(cfg.control_min)) != dof or len(np.asarray(cfg.control_max)) != dof:
            raise ValueError(f"control bounds must have length {dof}")
        if cfg.elite_select not in ELITE_SELECTS:
            raise ValueError(f"unknown elite_select {cfg.elite_select!r}; expected one of {ELITE_SELECTS}")
        if sampler is not None and not isinstance(sampler, PlantSampler) and not is_diagonal(covariance):
            # A kernel sampler scales its draws per dof (the JAX
            # PallasSampler, pallas_rollout.py:1595-1599).
            raise ValueError("fused_sampling requires a diagonal covariance")
        if cfg.optimal_rollout_mode not in ("batch", "resimulate"):
            raise ValueError(f"unknown optimal_rollout_mode {cfg.optimal_rollout_mode!r}")
        if filter_fn is not None and plant is None:
            raise ValueError("filter_fn filters the re-rollout through the plant: pass plant=")
        if cfg.optimal_rollout_mode == "resimulate" and filter_rollout_fn is None and plant is None:
            raise ValueError(
                "optimal_rollout_mode 'resimulate' needs a filter_rollout_fn "
                "(kernels/cuda_rollout.make_cuda_filter_rollout_fn) or a plant to re-roll through"
            )
        if sampler is None and plant is None:
            raise ValueError("a Planner needs a sampler or a plant")

        self.configuration = cfg
        self.plant = plant
        self.filter_fn = filter_fn
        self.filter_rollout_fn = filter_rollout_fn
        self.control_dof = control_dof
        self.device = resolve_device(device)
        if sampler is None:
            sampler = PlantSampler(
                plant, cfg.rollout_count, cfg.step_count, cfg.time_step,
                noise_factor(covariance), cfg.cost_discount_factor, self.device, rollout_fn, shards,
            )
        self.sampler = sampler
        self._shards = getattr(sampler, "shards", None)
        self.dtype = getattr(torch, cfg.dtype)
        self.steps = cfg.step_count
        self.rollout_count = cfg.rollout_count
        self.keep_best = min(cfg.keep_best_rollouts, cfg.rollouts)
        self._threshold_select = cfg.elite_select == "threshold" and self.keep_best > 0

        def constant(values):
            return torch.as_tensor(np.asarray(values), dtype=self.dtype).to(self.device)

        self._control_min = constant(cfg.control_min)
        self._control_max = constant(cfg.control_max)
        self._control_default = (
            constant(cfg.control_default) if cfg.control_default is not None else None
        )
        R = self.rollout_count
        row = torch.arange(R, device=self.device)
        self._is_static = row < STATIC_ROLLOUTS
        # Sampled rollouts in index order first, statics last: the same
        # ranks as sorting costs[2:] alone.
        self._tiebreak = torch.where(self._is_static, R + row, row)
        self._arange = row
        self._slot_offsets = torch.arange(self.steps, dtype=self.dtype, device=self.device)
        self._smoother = (
            SGSmoother(
                steps=self.steps,
                window=int(cfg.smoothing.window),
                order=int(cfg.smoothing.order),
            )
            if cfg.smoothing is not None
            else None
        )

    # -- state ---------------------------------------------------------------

    def init(self, seed: int = 0) -> PlannerState:
        steps, dof = self.steps, self.control_dof
        device, dtype = self.device, self.dtype

        def scalar(value, kind=None):
            return torch.full((), value, dtype=kind or dtype, device=device)

        sg_buffer = (
            self._smoother.init_buffer(dof, dtype, device)
            if self._smoother is not None
            else torch.zeros((0, 0), dtype=dtype, device=device)
        )
        return PlannerState(
            optimal_control=torch.zeros((steps, dof), dtype=dtype, device=device),
            noise=self.sampler.init_noise(dtype),
            costs=torch.zeros((self.rollout_count, 2), dtype=dtype, device=device),
            last_shift_time=scalar(0.0),
            last_update_time=scalar(0.0),
            sg_buffer=sg_buffer,
            sg_time=scalar(float("nan")),
            rng=key_from_seed(seed),
            update_count=scalar(0, torch.int32),
            optimal_cost=scalar(0.0),
            update_duration=scalar(0.0),
        )

    # -- public API ----------------------------------------------------------

    def _as_tensor(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(value), dtype=self.dtype, device=self.device)

    def update(
        self, state: PlannerState, x, time, ctx=None, fresh=None, noise_override=None
    ) -> tuple[PlannerState, UpdateInfo]:
        """One MPPI update at plant state ``x`` and time ``time``
        (mppi::Trajectory::update, mppi.cpp:154-187). ``ctx`` is the
        forecast context the objective reads. Pass ``x`` and ``time`` as
        tensors on the planner's device to keep the update free of host
        copies. ``state`` is left as it was.

        Parity-test hooks, so a test can feed both packages the same
        numbers:

        - ``fresh``: logical (R, steps, dof) N(0, cov) draws replacing the
          sampler's own; elite rows keep their noise;
        - ``noise_override`` (a ``Plant`` planner only): (R - 2, steps, dof)
          rows replacing every sampled row, elite rows included — the JAX
          planner's ``noise_override`` (mppi.py:475-522), which the
          reference-pipeline replay feeds its recorded noise through."""
        from .kernels.cuda_rollout import noise_from_logical

        x0 = self._as_tensor(x)
        time = self._as_tensor(time)
        if fresh is not None:
            fresh = noise_from_logical(self._as_tensor(fresh))
        if noise_override is not None:
            if not isinstance(self.sampler, PlantSampler):
                raise ValueError(
                    "noise_override replaces the sampled rows of a Plant planner's noise; "
                    "a kernel sampler takes fresh= draws"
                )
            noise_override = noise_from_logical(self._as_tensor(noise_override))
        rng, seed = split_key(state.rng)
        new_state, info = self.device_update(state, x0, time, ctx, seed, fresh, noise_override)
        return new_state._replace(rng=rng), info

    def capture(self, state: PlannerState, x, time, ctx=None) -> "CapturedUpdate":
        """The update captured as one CUDA graph, for CUDA planners only (on
        another device it raises): a callable with ``update``'s signature
        (no ``fresh=``) that replays the graph once per call and returns
        what ``update`` returns, bitwise. The arguments are examples: the
        capture fixes their shapes, dtypes, the ctx's structure and its time
        step and horizon.

        Like the JAX update's ``donate_argnums=0``, the captured update owns
        its state: the state (and info) a call returns are the graph's
        buffers, and the next call overwrites them, so a state it returned
        is not valid after the next call. Keep a copy to hold on to one. A
        state from elsewhere is copied in and left as it was
        (``CapturedUpdate``)."""
        return CapturedUpdate(self, state, x, time, ctx)

    def device_update(self, state: PlannerState, x0, time, ctx, seed, fresh=None, noise_override=None):
        """The device part of ``update`` for the update's seed words (or
        ``graphs.GRAPH_SEED`` in a capture): the new state with ``rng`` left
        as ``state``'s, and the update's info."""
        (
            optimal_shifted, shift_by, do_shift, last_shift_time, keep_mask,
        ) = self._sample_meta(state, time)
        override = {} if noise_override is None else {"noise_override": noise_override}
        costs, noise, states0 = self.sampler.sample_and_rollout(
            seed, keep_mask, shift_by, do_shift, state.noise,
            state.optimal_control, optimal_shifted, x0, time, ctx, fresh=fresh, **override,
        )
        optimal, weights, gradient, sg_buffer, degenerate = self._optimise(
            costs, noise, optimal_shifted, state.sg_buffer,
            self._sg_trim_offset(state, time),
        )
        sg_time = torch.where(degenerate, state.sg_time, time)
        if self.configuration.optimal_rollout_mode == "batch" and self.filter_fn is None:
            # Zero-noise rollout 0 = the shifted optimal at the current
            # state; its cost and per-step states come from the batch, one
            # update early.
            optimal_cost = compose_cost(costs[0])
            optimal_states = states0
        else:
            # Re-roll the new optimal sequence (mppi::Trajectory::filter),
            # filtered controls written back.
            optimal_cost, optimal_states, optimal = self._filter_rollout(optimal, x0, time, ctx)
        new_state = PlannerState(
            optimal_control=optimal,
            noise=noise,
            costs=costs,
            last_shift_time=last_shift_time,
            last_update_time=time,
            sg_buffer=sg_buffer,
            sg_time=sg_time,
            rng=state.rng,
            update_count=state.update_count + 1,
            optimal_cost=optimal_cost,
            update_duration=state.update_duration,
        )
        info = UpdateInfo(
            costs=compose_cost(costs),
            weights=weights,
            gradient=gradient,
            optimal_rollout_states=optimal_states,
            optimal_cost=optimal_cost,
            degenerate=degenerate,
        )
        return new_state, info

    def get(self, state: PlannerState, time) -> torch.Tensor:
        """The published control at ``time`` by linear interpolation
        (mppi::Trajectory::get, mppi.cpp:481-512)."""
        time = self._as_tensor(time)
        t = per_step(time - state.last_update_time, self.configuration.time_step)
        lower = torch.clamp(t.to(torch.int32), 0, self.steps - 1)
        upper = torch.clamp(lower + 1, max=self.steps - 1)
        frac = torch.clamp(t - lower, 0.0, 1.0)
        interpolated = (
            (1.0 - frac) * take_rows(state.optimal_control, lower.long())
            + frac * take_rows(state.optimal_control, upper.long())
        )
        past_end = lower + 1 >= self.steps
        if self._control_default is not None:
            fallback = self._control_default
        else:
            fallback = state.optimal_control[-1]
        return torch.where(past_end, fallback, interpolated)

    # -- implementation ------------------------------------------------------

    def _sample_meta(self, state: PlannerState, time: torch.Tensor):
        """Horizon shift, shifted optimal and elite keep mask
        (mppi.cpp:189-231)."""
        steps = self.steps
        # The shift in whole steps (mppi.cpp:194), ``per_step``: (0.2 -
        # 0.15) / 0.01 divided in float32 rounds to 5.0, the JAX package's
        # product is 4.9999995, and the reference's float64 truncates 4.99...
        # to 4, so a division would shift one step further than both at 0.2 s
        # and 0.25 s of a 50 ms controller.
        elapsed_steps = per_step(time - state.last_shift_time, self.configuration.time_step)
        shift_by = torch.clamp(elapsed_steps.to(torch.int32), 0, steps)
        do_shift = shift_by > 0
        last_shift_time = torch.where(do_shift, time, state.last_shift_time)
        optimal_shifted = torch.where(
            do_shift,
            _shift_columns(state.optimal_control, shift_by),
            state.optimal_control,
        )

        # Elite ordering by last update's cost: lexicographic over
        # (saturations V, smooth S, index), NaN as +inf, statics pushed
        # behind every sampled rollout. Adding 0.0 turns -0.0 into +0.0, so
        # a radix sort on the float bits sees them as the tie they are.
        inf = torch.full((), float("inf"), dtype=state.costs.dtype, device=self.device)
        V = torch.where(torch.isnan(state.costs[:, 0]) | self._is_static, inf, state.costs[:, 0]) + 0.0
        S = torch.where(torch.isnan(state.costs[:, 1]) | self._is_static, inf, state.costs[:, 1]) + 0.0
        if self._threshold_select:
            keep_mask = threshold_keep_mask(V, S, self._is_static, self.keep_best)
        else:
            order = _lexsort((self._tiebreak, S, V))
            rank = torch.empty_like(order)
            rank[order] = self._arange
            keep_mask = rank < self.keep_best  # never True for statics
        return optimal_shifted, shift_by, do_shift, last_shift_time, keep_mask

    def _sg_trim_offset(self, state: PlannerState, time: torch.Tensor) -> torch.Tensor:
        """The smoothing window's trim offset, time-based like
        MovingExtendedWindow::trim (filter.cpp:47-60): the number of horizon
        slots whose fill time (sg_time + i*dt) precedes the update time. Not
        the same as the horizon shift: the truncating (time - last_shift)/dt
        and the slot-time search can disagree by one slot, as in the
        reference."""
        slot_times = state.sg_time + self._slot_offsets * self.configuration.time_step
        return torch.where(
            torch.isnan(state.sg_time),
            0,
            torch.sum((slot_times < time).to(torch.int32)),
        )

    def _optimise(self, costs, noise, optimal_shifted, sg_buffer, sg_shift):
        """Weight, step, smooth, clip (mppi.cpp:344-448). The min/max
        normalisation and softmax run on the lexicographic composition
        (V - Vmin) * BARRIER_SCALE + (S - Sref), the reference's float64
        (cost - minimum) without float32 cancellation."""
        cfg = self.configuration
        V, S = costs[..., 0], costs[..., 1]
        valid = ~(torch.isnan(V) | torch.isnan(S))
        big = torch.full((), float("inf"), dtype=S.dtype, device=S.device)

        v_min = torch.min(torch.where(valid, V, big))
        s_at_vmin = torch.min(torch.where(valid & (V == v_min), S, big))
        v_max = torch.max(torch.where(valid, V, -big))
        s_at_vmax = torch.max(torch.where(valid & (V == v_max), S, -big))

        difference = (v_max - v_min) * BARRIER_SCALE + (s_at_vmax - s_at_vmin)
        # Degenerate spread: skip the update entirely (mppi.cpp:373-375);
        # also covers the all-NaN case.
        degenerate = ~(difference >= 1e-6)

        relative = (V - v_min) * BARRIER_SCALE + (S - s_at_vmin)
        likelihood = torch.where(
            valid,
            torch.exp(
                -cfg.cost_scale * relative / torch.where(difference > 0, difference, 1.0)
            ),
            0.0,
        )
        total = torch.sum(likelihood)
        weights = likelihood / torch.where(total > 0, total, 1.0)

        # Weighted noise sum = gradient estimate (mppi.cpp:413-418).
        gradient = self.sampler.weighted_noise_sum(noise, weights)
        updated = optimal_shifted + cfg.gradient_step * gradient

        if self._smoother is not None:
            smoothed, new_buffer = sg_smooth(self._smoother, sg_buffer, updated, sg_shift)
            updated = smoothed
            sg_buffer = torch.where(degenerate, sg_buffer, new_buffer)

        if cfg.control_bound:
            updated = torch.clamp(updated, self._control_min, self._control_max)

        optimal = torch.where(degenerate, optimal_shifted, updated)
        return optimal, weights, gradient, sg_buffer, degenerate


    def _filter_rollout(self, optimal, x0, time, ctx):
        """Re-roll the optimal sequence for its cost and states, applying the
        per-step safety filter and writing the filtered controls back into
        the published sequence (mppi::Trajectory::filter, mppi.cpp:450-479;
        the Eigen column reference at :462 makes the reference's filter
        mutate m_optimal_control_shifted in place). Returns (composed cost,
        (steps, state_dof) pre-step states, published sequence). On a
        scenario mesh the rank's ctx is its slice of the ensemble: the
        re-rollout reads the nominal scenario, broadcast from the rank that
        holds it (``RolloutShards.nominal``)."""
        if self._shards is not None:
            ctx = self._shards.nominal(ctx)
        if self.filter_rollout_fn is not None and self.filter_fn is None:
            channels, states = self.filter_rollout_fn(optimal, x0, time, ctx)
            return compose_cost(channels), states, optimal
        channels, states, optimal = plant_rollout(
            self.plant, optimal, x0, time, ctx, self.configuration.time_step,
            self.configuration.cost_discount_factor, filter_fn=self.filter_fn,
        )
        return compose_cost(channels), states, optimal


class CapturedUpdate:
    """``Planner.update`` as one CUDA graph (``Planner.capture``).

    Construction runs one eager update on the example arguments (the
    kernels' builds and checks, library workspaces and the generators' first
    use happen there, never in the capture), then captures the device part
    of an update on the graph's own state, input and context buffers, the
    new state written back into the state buffers as the graph's last step.

    A call copies its ``state`` (unless it is the state the last call
    returned), ``x``, ``time`` and the ctx's tensors into those buffers,
    splits the state's key on the host, seeds the sampler
    (``seed_replay``) and replays the graph once. Like the JAX update's
    ``donate_argnums=0``, the graph owns its state: the state and info a
    call returns are the graph's buffers, and the next call overwrites them.
    A state from any other source is copied in and left as it was."""

    def __init__(self, planner: Planner, state: PlannerState, x, time, ctx=None):
        graphs.require_cuda(planner.device, "Planner.capture")
        self.planner = planner
        x0, time = planner._as_tensor(x), planner._as_tensor(time)
        planner.update(state, x0, time, ctx)
        self._state = graphs.static_copy(state)
        self._x, self._time = x0.clone(), time.clone()
        self._ctx = graphs.static_copy(ctx)
        generators, self._host_inputs = planner.sampler.graph_rng()

        def body():
            new_state, info = planner.device_update(
                self._state, self._x, self._time, self._ctx, graphs.GRAPH_SEED
            )
            graphs.write_back(self._state, new_state)
            return info

        self.graph = graphs.CapturedGraph(body, generators, self._host_inputs)

    def __call__(self, state: PlannerState, x, time, ctx=None) -> tuple[PlannerState, UpdateInfo]:
        graphs.load(self._state, state, "state")
        graphs.load(self._x, x if isinstance(x, torch.Tensor) else self.planner._as_tensor(x), "x")
        graphs.load(self._time, time, "time")
        graphs.load(self._ctx, ctx, "ctx")
        rng, seed = split_key(state.rng)
        self.planner.sampler.seed_replay(seed)
        info = self.graph.replay()
        return self._state._replace(rng=rng), info


def configuration_from_json(tree: dict) -> Configuration:
    return from_json(Configuration, tree)

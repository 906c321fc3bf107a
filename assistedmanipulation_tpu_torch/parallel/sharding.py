"""Rollout sharding over torch.distributed (port of
assistedmanipulation_tpu/parallel/sharding.py).

The reference's only parallel substrate is a 36-thread pool with per-thread
dynamics copies and a future barrier (src/controller/concurrency.hpp,
mppi.cpp:272-307). The JAX package shards the rollout batch over a device
mesh and lets GSPMD insert the collectives. Here every rank runs the same
program on a ``DeviceMesh`` (SPMD), and the update's reductions are written
out against the mesh's process groups, with no backend named in them:

- the rollout batch splits into contiguous blocks of R / n rollouts (the
  reference's thread blocks, mppi.cpp:277-287); the rank at coordinate i of
  the ``"rollouts"`` axis holds block i of the noise and rolls it out with
  one kernel launch, under its own seed words (``philox.shard_seed``, the
  JAX sampler's ``fold_in(key, i)``), block 0 holding static rollouts 0
  and 1;
- one all-gather of the (R / n, 2) cost blocks per update: the elite
  lexsort of the next update and the min/max, softmax and weights of this
  one run replicated on the global (R, 2) costs, so the state keeps them
  replicated;
- the weighted noise sum (the gradient, mppi.cpp:413-418) is a partial
  (S, dof) per rank, gathered and added in rank order;
- rollout 0's states are broadcast from the first rollout shard;
- on a 2-D ``("scenarios", "rollouts")`` mesh each rank scores its block
  against its slice of the forecast ensemble, and the scenario costs are
  gathered over the scenario group and reduced in scenario order.

``RolloutShards`` holds that layout. Without a mesh it runs the same blocks
as a host loop on one device (``build_flagship(sampler_shards=n)``): the same
launches, seed words and orders of addition, so a sharded update equals its
single-process twin bit for bit on the same device. An all-reduce would
order its sums by backend and world size; adding gathered partials in rank
order does not. The safety filter's re-rollout and resimulate mode's
re-rollout run replicated on every rank, on the replicated optimal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ROLLOUT_AXIS = "rollouts"
SCENARIO_AXIS = "scenarios"


def initialize_multi_host(init_method: str, world_size: int, rank: int, backend: Optional[str] = None,
                          device="cuda") -> None:
    """Join a multi-process run: ``torch.distributed.init_process_group``
    with an explicit rendezvous (``tcp://host:port`` or ``file://path``),
    world size and rank; nothing reads the cluster from the environment.
    ``backend`` defaults to NCCL on the card and gloo on the CPU and is
    never swapped for another. Two ranks on one card need gloo: NCCL refuses
    them."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def _init_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        # The card this rank drives: rank % cards, as a launcher would set it.
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_mesh(device_type: str = "cuda"):
    """1-D ``("rollouts",)`` mesh over every rank of the process group."""
    return _init_mesh(device_type, (dist.get_world_size(),), (ROLLOUT_AXIS,))


def make_scenario_mesh(scenarios: int, device_type: str = "cuda"):
    """2-D ``("scenarios", "rollouts")`` mesh (BASELINE config 5's layout):
    the forecast-scenario ensemble splits over the first axis, the rollout
    batch over the second."""
    world = dist.get_world_size()
    if world % scenarios:
        raise ValueError(f"{world} ranks not divisible by {scenarios} scenarios")
    return _init_mesh(device_type, (scenarios, world // scenarios), (SCENARIO_AXIS, ROLLOUT_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _all_gather(tensor: torch.Tensor, group) -> list:
    """Every rank's ``tensor`` of ``group``, in group rank order."""
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return parts


def _add_in_order(parts: list) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _broadcast_first(tensor: torch.Tensor, group) -> torch.Tensor:
    """Group rank 0's ``tensor`` on every rank of ``group``."""
    tensor = tensor.clone()
    dist.broadcast(tensor, src=dist.get_global_rank(group, 0), group=group)
    return tensor


class RolloutShards:
    """The rollout batch of ``rollouts`` in ``count`` contiguous blocks
    (shards), and the reductions over them.

    With a ``mesh`` the count is the size of its ``"rollouts"`` axis and this
    process runs the one shard at its coordinate there (``local``); the
    rollout-major tensors it holds are that block. Without one it runs every
    shard in turn and holds the whole batch. ``scenario_axis``: the mesh
    axis a scenario ensemble splits over, or None.

    Blocks are contiguous: a block of the (S, dof, R) noise is a copy
    (``block``) on the host loop and the tensor itself on a rank."""

    def __init__(self, rollouts: int, count: int = 1, mesh=None, scenario_axis: Optional[str] = None):
        if mesh is not None:
            if ROLLOUT_AXIS not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"mesh must carry a '{ROLLOUT_AXIS}' axis")
            count = axis_size(mesh, ROLLOUT_AXIS)
        if count < 1 or rollouts % count:
            raise ValueError(f"rollout count {rollouts} not divisible into {count} shards")
        self.mesh = mesh
        self.scenario_axis = scenario_axis
        self._rollout_group = self._scenario_group = None
        if mesh is not None:
            self._rollout_group = mesh.get_group(ROLLOUT_AXIS)
            if scenario_axis is not None:
                self._scenario_group = mesh.get_group(scenario_axis)
        self.rollouts = rollouts
        self.count = count
        self.size = rollouts // count
        self.local = (mesh.get_local_rank(ROLLOUT_AXIS),) if mesh is not None else tuple(range(count))

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    def block(self, tensor: torch.Tensor, shard: int, dim: int = -1) -> torch.Tensor:
        """Shard ``shard``'s contiguous block of a whole-batch tensor."""
        if self.count == 1:
            return tensor.contiguous()
        return tensor.narrow(dim, shard * self.size, self.size).contiguous()

    def held_block(self, tensor: torch.Tensor, shard: int, dim: int = -1) -> torch.Tensor:
        """Shard ``shard``'s block of a rollout-major tensor this process
        holds: the tensor itself on a rank, which must be its block (a
        state placed by ``shard_planner_state``)."""
        if not self.distributed:
            return self.block(tensor, shard, dim)
        if tensor.shape[dim] != self.size:
            raise ValueError(
                f"a rank holds its block of {self.size} rollouts, got {tensor.shape[dim]}: "
                "place the state with sharding.shard_planner_state"
            )
        return tensor

    def join(self, blocks: list, dim: int = -1) -> torch.Tensor:
        """The blocks this process ran -> the tensor it holds."""
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=dim)

    def gather(self, blocks: list) -> torch.Tensor:
        """Every shard's block, concatenated along dim 0 in shard order, on
        every process: an all-gather over the rollout axis on a mesh."""
        if self.distributed:
            blocks = _all_gather(blocks[0], self._rollout_group)
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)

    def first(self, values: list) -> torch.Tensor:
        """Shard 0's value on every process (rollout 0 lives there)."""
        if self.distributed:
            return _broadcast_first(values[0], self._rollout_group)
        return values[0]

    def add(self, partials: list) -> torch.Tensor:
        """The sum of every shard's partial, added in shard order."""
        if self.distributed:
            partials = _all_gather(partials[0], self._rollout_group)
        return _add_in_order(partials)

    def weighted_noise_sum(self, noise: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The gradient estimate sum_r w_r noise_r (mppi.cpp:413-418) of the
        (S, dof, R) noise this process holds and the (R,) weights: one
        partial product per block, added in shard order (``add``)."""
        steps, dof = noise.shape[:2]
        partials = [
            self.held_block(noise, shard).reshape(steps * dof, self.size) @ self.block(weights, shard, 0)
            for shard in self.local
        ]
        return self.add(partials).reshape(steps, dof)

    def gather_scenarios(self, costs: torch.Tensor) -> torch.Tensor:
        """(C_local, ...) scenario costs of this rank's slice -> (C, ...)
        of the whole ensemble in scenario order (unchanged without a
        scenario axis)."""
        if self._scenario_group is None:
            return costs
        return torch.cat(_all_gather(costs, self._scenario_group), dim=0)

    def nominal(self, ctx):
        """The ctx an optimal re-rollout reads: on a scenario axis, the
        ensemble's nominal scenario 0 (the objective's and the re-rollout's
        ``horizon[0]``), broadcast from the first scenario rank, where this
        rank's slice starts elsewhere; otherwise ``ctx`` as it is."""
        if self._scenario_group is None or ctx is None or ctx.wrench_horizon.ndim != 3:
            return ctx
        return ctx._replace(wrench_horizon=_broadcast_first(ctx.wrench_horizon[0], self._scenario_group))


def _placements(mesh, sharded: dict):
    """Per mesh axis, Shard(dim) where ``sharded`` maps the axis to a
    tensor dimension, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(
        Shard(sharded[name]) if name in sharded else Replicate() for name in mesh.mesh_dim_names
    )


def planner_state_shardings(planner, mesh):
    """Placements (``torch.distributed.tensor``'s Shard and Replicate, one
    per mesh axis) of a ``PlannerState``: the (S, dof, R) noise splits along
    its rollout dimension over the rollout axis; everything else replicates.
    The costs replicate too, where the JAX package splits them: the update
    gathers them once for its softmax, and the next update's elite lexsort
    reads the gathered (R, 2) array."""
    from ..mppi import PlannerState

    replicated = _placements(mesh, {})
    fields = {name: replicated for name in PlannerState._fields}
    fields["noise"] = _placements(mesh, {ROLLOUT_AXIS: 2})
    return PlannerState(**fields)


def _local_part(tensor: torch.Tensor, placements, mesh) -> torch.Tensor:
    for axis, placement in enumerate(placements):
        if placement.is_shard():
            name = mesh.mesh_dim_names[axis]
            size = tensor.shape[placement.dim] // mesh.size(axis)
            tensor = tensor.narrow(placement.dim, mesh.get_local_rank(name) * size, size)
    return tensor.contiguous()


def _whole(tensor: torch.Tensor, placements, mesh) -> torch.Tensor:
    for axis, placement in reversed(list(enumerate(placements))):
        if placement.is_shard():
            parts = _all_gather(tensor, mesh.get_group(mesh.mesh_dim_names[axis]))
            tensor = torch.cat(parts, dim=placement.dim)
    return tensor


def shard_planner_state(planner, state, mesh):
    """This rank's part of a whole ``PlannerState`` (as ``planner.init``
    makes it): its block of the noise, the rest as it is."""
    shardings = planner_state_shardings(planner, mesh)
    return type(state)(*(_local_part(value, placements, mesh) for value, placements in zip(state, shardings)))


def gather_planner_state(planner, state, mesh):
    """The inverse of ``shard_planner_state``: the whole state on every rank
    (the noise gathered in rank order), for comparisons."""
    shardings = planner_state_shardings(planner, mesh)
    return type(state)(*(_whole(value, placements, mesh) for value, placements in zip(state, shardings)))


def make_sharded_update(planner, mesh):
    """The planner's update on this rank of ``mesh``: ``update(state, x0,
    time, ctx=None, fresh=None)`` on a placed state (``shard_planner_state``)
    and this rank's ctx (``shard_ctx``). The planner's sampler must be
    sharded over the same mesh (``parallel/flagship.build_flagship(mesh=)``
    builds it so); its collectives run inside the update, eagerly: a gloo
    collective cannot be captured in a CUDA graph."""
    shards = getattr(planner.sampler, "shards", None)
    if shards is None or shards.mesh is not mesh:
        raise ValueError("the planner's sampler is not sharded over this mesh")

    def update(state, x0, time, ctx=None, fresh=None):
        shards.held_block(state.noise, shards.local[0])
        return planner.update(state, x0, time, ctx, fresh=fresh)

    return update


def shard_rollout_fn(rollout_fn, mesh, axis: str = ROLLOUT_AXIS, scenario_axis: Optional[str] = None,
                     scenario_weights=None):
    """A rollout evaluator placed on the mesh, the counterpart of the JAX
    package's shard_map wrapper (what its flagship's vmap backend takes
    under a mesh): each rank runs the SAME ``rollout_fn`` on its block of
    the rollout batch.

    ``rollout_fn(noise (R / n, S, dof), optimal_shifted, x0, time, ctx) ->
    costs (R / n, 2), or (costs, (S, state_dof) rollout-0 states)``; the
    wrapped function takes this rank's noise block and returns the same form
    for the whole batch: the costs of every rollout in shard order (one
    all-gather over ``axis``) and rollout 0's states broadcast from the first
    shard. A rollout_fn that returns costs alone is taken as it is (the JAX
    wrapper always unpacks a pair, parallel/sharding.py:173 there).

    A scenario-ensemble ctx ((C_local, S + 1, 6) horizons, this rank's
    slice) is scored one scenario at a time; on a 2-D mesh
    (``scenario_axis`` given) the (C_local, R / n, 2) costs are gathered over
    the scenario axis and reduced in scenario order: the scenario mean, or
    with ``scenario_weights`` (global, (C,)) the weighted mean
    (forecast/scenarios.reduce_scenarios). Without a scenario axis a rank
    holds the whole ensemble and reduces it the same way (the JAX wrapper
    scores only the nominal scenario there: its plant reads
    ``horizon[0]``)."""
    from ..forecast.scenarios import reduce_scenarios
    from ..objectives.assisted_manipulation import scenario_contexts

    rollout_group = mesh.get_group(axis)
    scenario_group = mesh.get_group(scenario_axis) if scenario_axis is not None else None
    weights = None
    if scenario_weights is not None:
        weights = np.asarray(scenario_weights, dtype=np.float64)

    def fn(noise, optimal_shifted, x0, time, ctx):
        outs = [rollout_fn(noise, optimal_shifted, x0, time, c) for c in scenario_contexts(ctx)]
        paired = isinstance(outs[0], tuple)
        costs = [out[0] if paired else out for out in outs]
        if ctx is not None and ctx.wrench_horizon.ndim == 3:
            stacked = torch.stack(costs)  # (C_local, R / n, 2)
            if scenario_group is not None:
                stacked = torch.cat(_all_gather(stacked, scenario_group), dim=0)
            local = reduce_scenarios(stacked, weights)
        else:
            local = costs[0]
        total = torch.cat(_all_gather(local, rollout_group), dim=0)
        if not paired:
            return total
        # Rollout-0 states do not depend on the forecast: any scenario's.
        return total, _broadcast_first(outs[0][1], rollout_group)

    return fn


def scenario_ctx_shardings(mesh, axis: str = SCENARIO_AXIS):
    """Placements of a scenario-ensemble ``ForecastContext``: the
    (C, S + 1, 6) wrench ensemble splits along its scenario dimension over
    ``axis``; the start time replicates; the time step and horizon are
    numbers."""
    from ..objectives.assisted_manipulation import ForecastContext

    return ForecastContext(
        wrench_horizon=_placements(mesh, {axis: 0}),
        start_time=_placements(mesh, {}),
        time_step=None,
        horizon=None,
    )


def shard_ctx(ctx, mesh, axis: str = SCENARIO_AXIS):
    """This rank's scenario slice of a whole ensemble ctx
    (``scenario_ctx_shardings``)."""
    shardings = scenario_ctx_shardings(mesh, axis)
    return ctx._replace(
        wrench_horizon=_local_part(ctx.wrench_horizon, shardings.wrench_horizon, mesh),
        start_time=_local_part(ctx.start_time, shardings.start_time, mesh),
    )

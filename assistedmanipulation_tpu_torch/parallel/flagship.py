"""Flagship serving composition (port of
assistedmanipulation_tpu/parallel/flagship.py).

``build_flagship()`` is the serving MPPI solve: 9,998 sampled + 2 static
rollouts over 50 steps of 10 ms, the 12-dof Franka-Ridgeback model with the
default 7-term assisted-manipulation objective, batch optimal-rollout mode,
every update one launch of the fused sample+rollout CUDA kernel
(kernels/cuda_rollout.CudaSampler). ``build_flagship(scenarios=C)`` scores
every rollout against a C-scenario forecast ensemble (BASELINE config 5):
the two-pass sampler, one launch of the two-pass rollout kernel per update
for all C scenarios.
``build_flagship(inkernel_rng=True)`` is the serving solve with its fresh
draws made inside the kernel: one launch of the in-kernel-RNG kernel per
update and no fresh-noise tensor. ``build_flagship(capture=True)`` replays
one CUDA graph per update (mppi.Planner.capture), and
``optimal_rollout_mode="resimulate"`` re-rolls each new optimal sequence
with one more launch of the two-pass kernel at R = 1, inside that graph.
``build_flagship(safety=True)`` attaches the ADMM-QP safety filter
(safety.make_safety_filter; BASELINE config 5's safety layer): after the
kernel has scored the batch, the new optimal sequence is re-rolled through
the plant (models/frankaridgeback.make_plant), 50 serial steps of derive,
objective, QP filter and integrate in plain PyTorch, and the filtered
controls are published. ``build_flagship(backend="vmap")`` is the JAX
package's generic planner: the plant rolled out over the whole batch in
plain PyTorch (mppi.PlantSampler), no rollout kernel;
``build_flagship(backend="lanes")`` the JAX package's lanes backend: the
batch rolled out by the lanes step in plain PyTorch
(kernels/lane_rollout.make_lanes_planner), no kernel either.
``make_serving_tick`` composes the Kalman-driven serving tick (forecast
update, scenario draw, planner update), eager or as one graph.
``build_flagship(mesh=...)`` splits the rollout batch over the ranks of a
``torch.distributed`` device mesh (parallel/sharding.py): each rank launches
the same kernel on its block and the update's reductions go through
collectives; ``build_flagship(sampler_shards=n)`` is its single-process
twin, the same blocks run in turn on one device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import graphs, resolve_device, tracing
from .. import mppi as mppi_module
from ..forecast.forecast import KalmanForecast, KalmanForecastState
from ..forecast.scenarios import make_scenario_rollout_fn, sample_scenarios
from ..kernels.cuda_rollout import (
    FUSED_MAX_STEPS,
    INKERNEL_MAX_STEPS,
    CudaSampler,
    make_cuda_filter_rollout_fn,
    noise_from_logical,
)
from ..kernels.lane_rollout import make_lanes_planner
from ..kernels.philox import split_key
from ..models import frankaridgeback as fr
from ..models.model_data import frankaridgeback_model
from ..objectives.assisted_manipulation import (
    AssistedManipulation,
    Configuration as ObjectiveConfiguration,
    ForecastContext,
)
from ..ops.gaussian import diagonal_scale, noise_factor
from ..safety import make_safety_filter
from .sharding import (
    SCENARIO_AXIS,
    RolloutShards,
    axis_size,
    make_sharded_update,
    shard_ctx,
    shard_rollout_fn,
    shard_planner_state,
)

BACKENDS = ("cuda", "vmap", "lanes")


class Flagship(NamedTuple):
    """A ready-to-run flagship planner bundle."""

    planner: mppi_module.Planner
    # (state, x0, time, ctx, fresh=None) -> (state, info); captured: no
    # fresh=, and the graph owns the state it returns (CapturedUpdate)
    update: Callable
    init: Callable  # (seed) -> PlannerState
    make_ctx: Callable  # () -> ForecastContext
    x0: torch.Tensor
    mesh: Optional[object] = None  # the torch.distributed DeviceMesh, when sharded


def default_mppi_configuration(
    rollouts: int, steps: int, dtype: str = "float32", optimal_rollout_mode: str = "batch",
    elite_select: str = "lexsort",
) -> mppi_module.Configuration:
    """The serving MPPI configuration: reference defaults (base.hpp:69-101)
    at production rollout counts, batch optimal-rollout mode unless asked
    (as the JAX flagship's)."""
    return mppi_module.Configuration(
        rollouts=rollouts,
        keep_best_rollouts=max(1, rollouts // 5),
        time_step=0.01,
        horizon=steps * 0.01,
        gradient_step=2.0,
        cost_scale=10.0,
        covariance=fr.DEFAULT_COVARIANCE,
        control_min=fr.DEFAULT_CONTROL_MIN,
        control_max=fr.DEFAULT_CONTROL_MAX,
        control_default=np.zeros(12),
        smoothing=mppi_module.Smoothing(window=10, order=1),
        dtype=dtype,
        optimal_rollout_mode=optimal_rollout_mode,
        elite_select=elite_select,
    )


def synthetic_wrench_horizons(
    steps: int, scenarios: int = 1, device="cuda", dtype=torch.float32
) -> torch.Tensor:
    """Deterministic stand-in for the Kalman forecast ensemble
    (forecast/scenarios.sample_scenarios): scenario 0 is the mean — a
    constant 20 N x-force, the benchmark's canonical human pull — and the
    rest spread around it like posterior draws. (steps + 1, 6) for one
    scenario, else (scenarios, steps + 1, 6)."""
    mean = torch.zeros((steps + 1, 6), dtype=dtype)
    mean[:, 0] = 20.0
    if scenarios == 1:
        return mean.to(resolve_device(device))
    offsets = np.zeros((scenarios, 6), dtype=np.float32)
    # Alternate +/- force offsets of growing magnitude per scenario.
    for c in range(1, scenarios):
        offsets[c, (c - 1) % 3] = 2.0 * ((-1) ** c) * ((c + 1) // 2)
    horizons = mean[None] + torch.as_tensor(offsets, dtype=dtype)[:, None, :]
    return horizons.to(resolve_device(device))


def build_flagship(
    rollouts: int = 10_000 - mppi_module.STATIC_ROLLOUTS,
    steps: int = 50,
    device="cuda",
    dtype: str = "float32",
    scenarios: int = 1,
    fused_assembly: Optional[bool] = None,
    inkernel_rng: bool = False,
    optimal_rollout_mode: str = "batch",
    capture: bool = False,
    backend: str = "cuda",
    safety: bool = False,
    mesh=None,
    sampler_shards: int = 1,
    elite_select: str = "lexsort",
) -> Flagship:
    """Compose the flagship planner on one device. ``device="cpu"`` runs the
    plain PyTorch rollouts (tests); the default needs CUDA and raises without
    it. The CUDA kernels take float32 only.

    - ``scenarios`` > 1 scores every rollout against a wrench-forecast
      ensemble (risk-neutral scenario mean), BASELINE config 5; ``make_ctx``
      then returns the (scenarios, steps + 1, 6) ensemble.
    - ``fused_assembly`` picks the sampler: the fused sample+rollout kernel
      (True) or the two-pass sampler (False: noise assembled in plain
      PyTorch, then one launch of the two-pass rollout kernel against
      every scenario). It
      defaults to the fused kernel for one scenario up to
      ``FUSED_MAX_STEPS`` steps, whose (S, 32) table and state ring fill a
      block's shared memory there, and to the two-pass sampler otherwise
      (its kernel takes one scenario up to ``ROLLOUT_MAX_TABLE_ROWS`` =
      6,878 steps); a scenario
      ensemble needs the two-pass sampler. The JAX package switches for
      horizons past ~64 steps (``max_sublanes_for_vmem(steps, 3, 16) <
      16``), a rule of the TPU's VMEM. The noise is bitwise the same on
      either path, so the results are the same.
    - ``inkernel_rng=True`` draws the fresh noise inside the kernel
      (Philox from 2 seed words per update, kernels/philox.py): the
      composition of the JAX package's ``make_pallas_planner(cfg,
      fused_sampling=True, fused_assembly=True, inkernel_rng=True)``. It
      needs one scenario and fused assembly, and its updates take no
      ``fresh=`` draws, and at most ``INKERNEL_MAX_STEPS`` steps.
    - ``optimal_rollout_mode="resimulate"`` publishes the re-rollout of each
      new optimal sequence (one two-pass launch at R = 1, the nominal
      scenario of an ensemble: ``make_cuda_filter_rollout_fn``); "batch"
      (the default, as the JAX flagship's) rollout 0 of the batch.
    - ``capture=True`` (CUDA only; raises on the CPU): ``update`` captures
      its first call as one CUDA graph (mppi.Planner.capture) and every
      call replays it once, bitwise the eager update; it takes no
      ``fresh=``, and the state it returns is the graph's own, overwritten
      by the next call.
    - ``backend``: "cuda" (the default) scores the batch with the rollout
      kernels as above; "vmap" rolls the plant out over the batch in plain
      PyTorch (the JAX flagship's ``backend="vmap"``, its generic planner),
      scored against a scenario ensemble one scenario at a time
      (forecast/scenarios.make_scenario_rollout_fn). It launches no
      rollout kernel, and takes none of the kernel options. "lanes" (the
      JAX flagship's ``backend="lanes"``) scores the batch with the lanes
      step, the scalar graph the kernels run per thread, as plain PyTorch
      over every rollout at once on ``device``
      (kernels/lane_rollout.make_lanes_planner); the filter, the scenarios
      and the mesh are wired as for "vmap". It is picked by name, never in
      place of a kernel: the "cuda" backend raises without its kernels.
    - ``elite_select``: the planner's keep-mask rule,
      mppi.Configuration.elite_select ("lexsort" or "threshold", the
      same mask).
    - ``safety=True`` attaches the ADMM-QP trajectory filter
      (safety.make_safety_filter) to the optimal re-rollout through the
      plant, in either optimal-rollout mode: the published sequence is the
      filtered one, and its cost and states are the filtered re-rollout's.
      On the "cuda" backend the kernel still streams rollout 0's states;
      the re-rollout supplies the published ones.
    - ``mesh`` (parallel/sharding.make_mesh, make_scenario_mesh; every rank
      calls build_flagship alike): a 1-D ``("rollouts",)`` mesh splits the
      rollout batch over its ranks, each rank launching the kernel once per
      update on its R / n block; a 2-D ``("scenarios", "rollouts")`` mesh
      also splits a scenario ensemble (``scenarios`` > 1), each rank scoring
      its block against its slice. ``init`` places the state
      (``shard_planner_state``), ``make_ctx`` gives the rank's scenario
      slice, and ``update`` runs the collectives eagerly, so ``capture``
      refuses a mesh. The rollout count must divide the rollout axis and
      ``scenarios`` the scenario axis. Every backend and option above runs
      under a mesh; the safety filter's and resimulate mode's re-rollouts run
      replicated on every rank.
    - ``sampler_shards=n`` (no mesh): the mesh's single-process twin, the
      batch in n blocks with their own seed words run in turn on one device,
      the weighted noise sum added in block order: bitwise what n ranks
      compute on the same device. It captures too (one graph, n launches per
      replay)."""
    device = resolve_device(device)
    if capture and mesh is not None:
        raise ValueError("capture=True takes no mesh: the sharded update's collectives run eagerly")
    if capture:
        graphs.require_cuda(device, "build_flagship(capture=True)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    configuration = default_mppi_configuration(rollouts, steps, dtype, optimal_rollout_mode, elite_select)
    horizon = configuration.step_count
    rollout_count = configuration.rollout_count
    scenario_axis = None
    if mesh is not None:
        if sampler_shards != 1:
            raise ValueError("sampler_shards is the single-process twin of a mesh: pass one or the other")
        if SCENARIO_AXIS in (mesh.mesh_dim_names or ()) and scenarios > 1:
            scenario_axis = SCENARIO_AXIS
            if scenarios % axis_size(mesh, SCENARIO_AXIS):
                raise ValueError(
                    f"{scenarios} scenarios not divisible by the "
                    f"{axis_size(mesh, SCENARIO_AXIS)}-rank scenario axis"
                )
    # The mesh's rollout axis and the rollout count's split are checked here.
    shards = RolloutShards(rollout_count, sampler_shards, mesh, scenario_axis)
    plant = filter_fn = None
    if safety or backend == "vmap":
        plant = fr.make_plant(AssistedManipulation(ObjectiveConfiguration()), fr.Configuration(),
                              frankaridgeback_model())
    if safety:
        filter_fn = make_safety_filter()
    torch_dtype = getattr(torch, dtype)

    def make_ctx():
        ctx = ForecastContext(
            wrench_horizon=synthetic_wrench_horizons(steps, scenarios, device),
            start_time=torch.zeros((), dtype=torch.float32, device=device),
            time_step=0.01,
            horizon=steps * 0.01,
        )
        return ctx if scenario_axis is None else shard_ctx(ctx, mesh)

    def bundle(planner):
        x0 = torch.as_tensor(fr.make_state("huddled"), dtype=torch_dtype).to(device)
        if mesh is not None:
            return Flagship(
                planner, make_sharded_update(planner, mesh),
                lambda seed=0: shard_planner_state(planner, planner.init(seed), mesh), make_ctx, x0, mesh,
            )
        update = _CaptureOnFirstCall(planner.capture) if capture else planner.update
        return Flagship(planner, update, planner.init, make_ctx, x0)

    if backend == "lanes":
        if inkernel_rng or fused_assembly:
            raise ValueError("inkernel_rng and fused_assembly choose a rollout kernel; the lanes backend has none")
        wrapper = None
        if mesh is not None:
            wrapper = lambda fn: shard_rollout_fn(fn, mesh, scenario_axis=scenario_axis)  # noqa: E731
        elif scenarios > 1:
            wrapper = make_scenario_rollout_fn
        return bundle(make_lanes_planner(
            configuration, filter_fn=filter_fn, rollout_fn_wrapper=wrapper, device=device, shards=shards
        ))
    if backend == "vmap":
        if inkernel_rng or fused_assembly:
            raise ValueError("inkernel_rng and fused_assembly choose a rollout kernel; the vmap backend has none")
        rollout_fn = None
        if scenarios > 1 and mesh is None:
            # Each scenario through the generic batch rollout. On a mesh the
            # sampler places its plant rollout with shard_rollout_fn, which
            # scores an ensemble the same way.
            base = mppi_module.PlantSampler(
                plant, rollout_count, horizon, configuration.time_step,
                noise_factor(configuration.covariance), configuration.cost_discount_factor, device,
            )
            rollout_fn = make_scenario_rollout_fn(
                lambda noise, optimal, x0, time, ctx: base.rollout(
                    noise_from_logical(noise), optimal, x0, time, ctx
                )
            )
        return bundle(mppi_module.Planner(
            configuration, plant, device=device, rollout_fn=rollout_fn, filter_fn=filter_fn, shards=shards
        ))
    if inkernel_rng and fused_assembly is False:
        raise ValueError("inkernel_rng is fused assembly; it cannot run with fused_assembly=False")
    if inkernel_rng and horizon > INKERNEL_MAX_STEPS:
        raise ValueError(
            f"{horizon} steps: the in-kernel-RNG kernel takes at most {INKERNEL_MAX_STEPS} "
            "(its (S, 32) table lives in shared memory)"
        )
    if fused_assembly is None:
        fused_assembly = (scenarios == 1 and horizon <= FUSED_MAX_STEPS) or inkernel_rng
    if fused_assembly and scenarios > 1:
        raise ValueError("a scenario ensemble needs the two-pass sampler (fused_assembly=False)")
    if fused_assembly and not inkernel_rng and horizon > FUSED_MAX_STEPS:
        raise ValueError(
            f"{horizon} steps: the fused kernel takes at most {FUSED_MAX_STEPS}; "
            "the two-pass sampler (fused_assembly=False) takes longer horizons"
        )
    sampler = CudaSampler(
        frankaridgeback_model(),
        ObjectiveConfiguration(),
        fr.Configuration(),
        configuration.rollout_count,
        configuration.step_count,
        configuration.time_step,
        diag_scale=diagonal_scale(configuration.covariance),
        discount=configuration.cost_discount_factor,
        device=device,
        fused_assembly=fused_assembly,
        inkernel_rng=inkernel_rng,
        shards=shards,
    )
    filter_rollout_fn = None
    if optimal_rollout_mode == "resimulate" and not safety:
        filter_rollout_fn = make_cuda_filter_rollout_fn(
            frankaridgeback_model(), ObjectiveConfiguration(), fr.Configuration(),
            configuration.step_count, configuration.time_step,
            configuration.cost_discount_factor, device=device,
        )
    return bundle(mppi_module.Planner(
        configuration, sampler, fr.DoF.CONTROL, device=device, filter_rollout_fn=filter_rollout_fn,
        plant=plant, filter_fn=filter_fn,
    ))


class _CaptureOnFirstCall:
    """The first call captures (``capture(*args)`` returns the captured
    callable) on its arguments; every call replays the graph once."""

    def __init__(self, capture: Callable):
        self._capture = capture
        self.captured = None

    def __call__(self, *args):
        if self.captured is None:
            self.captured = self._capture(*args)
        return self.captured(*args)


def make_serving_tick(
    flagship: Flagship,
    forecast: KalmanForecast,
    scenarios: int,
    generator: torch.Generator,
    capture: bool = False,
):
    """One tick of the Kalman-driven serving loop: the measured wrench into
    the forecast (``KalmanForecast.update``), ``scenarios`` wrench horizons
    drawn from its posterior with ``generator`` (``sample_scenarios``), and
    the planner update against that ensemble at plant state ``x``:

        tick(forecast_state, planner_state, x, measurement, time)
            -> (forecast_state, planner_state, info, horizons)

    ``capture=True`` (CUDA only) captures the first call's device work as
    one CUDA graph (``CapturedServingTick``), bitwise the eager tick."""
    planner = flagship.planner
    if capture:
        graphs.require_cuda(planner.device, "make_serving_tick(capture=True)")
        return _CaptureOnFirstCall(
            lambda *args: CapturedServingTick(planner, forecast, scenarios, generator, *args)
        )

    def tick(forecast_state, planner_state, x, measurement, time):
        with tracing.span("serving_tick"), tracing.timeline("serving_tick", planner.device):
            forecast_state, horizons, ctx = _forecast_step(
                forecast, scenarios, generator, forecast_state, measurement, time
            )
            planner_state, info = planner.update(planner_state, x, time, ctx)
        return forecast_state, planner_state, info, horizons

    return tick


def _forecast_step(forecast, scenarios, generator, forecast_state, measurement, time):
    """The tick's forecast part: (new forecast state, horizons, ctx)."""
    tracing.mark("forecast")
    forecast_state = forecast.update(forecast_state, measurement, time)
    horizons = sample_scenarios(forecast, forecast_state, generator, scenarios)
    c = forecast.configuration
    ctx = ForecastContext(horizons, forecast_state.last_update, c.time_step, c.horizon)
    return forecast_state, horizons, ctx


class CapturedServingTick:
    """The serving tick of ``make_serving_tick`` as one CUDA graph: the
    forecast update, the scenario draw and the planner's device update,
    captured after one eager tick on the example arguments (``generator``'s
    state is restored after that tick and the capture). Like ``mppi.CapturedUpdate``, the
    graph owns the forecast and planner states it returns; each call copies
    in the states it is given (unless they are the ones the last call
    returned), ``x``, the measurement and the time, splits the planner's key
    on the host and replays the graph once. ``generator`` is registered
    with the graph: each replay advances it as the eager tick does."""

    def __init__(self, planner, forecast, scenarios, generator, forecast_state: KalmanForecastState,
                 planner_state, x, measurement, time):
        graphs.require_cuda(planner.device, "CapturedServingTick")
        self.planner = planner
        x, time = planner._as_tensor(x), planner._as_tensor(time)
        measurement = torch.as_tensor(measurement).to(planner.device)
        rng_state = generator.get_state()
        _, _, ctx = _forecast_step(forecast, scenarios, generator, forecast_state, measurement, time)
        planner.update(planner_state, x, time, ctx)
        self._forecast_state = graphs.static_copy(forecast_state)
        self._planner_state = graphs.static_copy(planner_state)
        self._x, self._measurement, self._time = x.clone(), measurement.clone(), time.clone()
        generators, host_inputs = planner.sampler.graph_rng()

        def body():
            new_forecast, horizons, ctx = _forecast_step(
                forecast, scenarios, generator, self._forecast_state, self._measurement, self._time
            )
            new_planner, info = planner.device_update(
                self._planner_state, self._x, self._time, ctx, graphs.GRAPH_SEED
            )
            graphs.write_back(self._forecast_state, new_forecast)
            graphs.write_back(self._planner_state, new_planner)
            return info, horizons

        self.graph = graphs.CapturedGraph(body, (generator, *generators), host_inputs, entry="serving_tick")
        generator.set_state(rng_state)

    def __call__(self, forecast_state, planner_state, x, measurement, time):
        with tracing.span("serving_tick"):
            with tracing.span("serving_tick.load"):
                graphs.load(self._forecast_state, forecast_state, "forecast_state")
                graphs.load(self._planner_state, planner_state, "planner_state")
                graphs.load(self._x, x, "x")
                graphs.load(self._measurement, measurement, "measurement")
                graphs.load(self._time, time, "time")
            with tracing.span("serving_tick.seed"):
                rng, seed = split_key(planner_state.rng)
                self.planner.sampler.seed_replay(seed)
            with tracing.span("serving_tick.replay"):
                info, horizons = self.graph.replay()
        return self._forecast_state, self._planner_state._replace(rng=rng), info, horizons

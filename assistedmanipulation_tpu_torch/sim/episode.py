"""The experiment episode on the device: the whole control experiment with
the human model, the forecast, the controller at its rate and the plant
(port of assistedmanipulation_tpu/sim/episode.py).

The reference runs its experiments as a host loop at 200 Hz with a
thread-pooled controller (base.cpp:150-163 + actor.cpp:166-203). The JAX
package compiles the whole episode into one ``lax.scan`` over simulator
ticks, with the controller update inside a ``lax.cond`` on the countdown.

A CUDA graph holds no condition, but the firing schedule is fixed: with the
countdown ``c`` at the start, tick k fires when k >= max(c, 0) and
k - max(c, 0) is a multiple of ``countdown_max``. So the episode runs in
controller periods, each one update tick (derive, human PID, forecast
observation, dynamics forecast, planner update, query, integrate) and
``countdown_max - 1`` plain ticks:

- eager (the CPU, or ``capture=False``): a Python loop over the ticks that
  fires the update on that schedule;
- captured (a CUDA device's default): the ticks before the first update
  and the first period run eagerly; then one period is captured as one CUDA
  graph (``graphs.CapturedGraph``) and replayed once per further whole
  period; a last partial period runs eagerly. Per replay the host loads
  the period's first tick and its update's number into static device
  buffers (every time inside the graph is computed from them), splits the
  planner's key and reseeds the sampler's registered generator, as
  ``mppi.CapturedUpdate`` does. Captured and eager runs are bitwise equal.

The per-tick outputs are written into (ticks, ...) device tensors and the
per-update logs (update info, published sequence, forecast rollout) into
(updates, ...) ones, at a device-side index, so nothing is read back to the
host during the run. Only the ticks that fired are logged per update; the
JAX version's zero-filled skip branch has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import graphs, mppi, resolve_device
from ..forecast import forecast as fc
from ..forecast.dynamics_forecast import (
    Configuration as DynamicsForecastConfiguration,
    DynamicsForecast,
)
from ..kernels.cuda_rollout import noise_from_logical
from ..kernels.philox import split_key
from ..models import factory
from ..models import frankaridgeback as fr
from ..models.model_data import frankaridgeback_model
from ..ops import constant
from . import pid as pid_module


class EpisodeOutputs(NamedTuple):
    ee_position: torch.Tensor  # (ticks, 3)
    reference: torch.Tensor  # (ticks, 3)
    wrench: torch.Tensor  # (ticks, 6)
    control: torch.Tensor  # (ticks, 12)
    tank_energy: torch.Tensor  # (ticks,)
    optimal_cost: torch.Tensor  # (ticks,)


class EpisodeLogs(NamedTuple):
    """Full observability stream for the harness CSV tree
    (``collect_logs=True``): everything the host-loop loggers consume,
    collected on the device and written after the run. The per-update
    fields hold the updates only, in order: row u is the update of tick
    ``np.flatnonzero(update_fired)[u]``."""

    x: torch.Tensor  # (ticks, state_dof) plant state
    pid: pid_module.PIDState  # per field (ticks, ...)
    update_fired: torch.Tensor  # (ticks,) bool
    update_info: mppi.UpdateInfo  # per field (updates, ...)
    optimal_control: torch.Tensor  # (updates, steps, dof)
    forecast: object  # ForecastRollout, per field (updates, forecast steps, ...)
    ee_linear_acceleration: torch.Tensor  # (ticks, 3) classical J'v + J q''
    ee_angular_acceleration: torch.Tensor  # (ticks, 3)
    joint_power: torch.Tensor  # (ticks,) tau . v (raisim_dynamics.cpp:176-179)
    torque_pid: pid_module.PIDState  # per field (ticks, ...)
    torque_reference: torch.Tensor  # (ticks, 4) wxyz quat (zeros when off)


class EpisodeCarry(NamedTuple):
    """The state an episode carries from tick to tick (the JAX scan's
    carry): the countdown is a host integer, the planner's key host words."""

    x: torch.Tensor  # (state_dof,)
    planner_state: mppi.PlannerState
    strategy_state: object
    pid_state: pid_module.PIDState
    torque_state: pid_module.PIDState
    countdown: int  # ticks until the next update; <= 0 fires on the first tick


class _TickCarry(NamedTuple):
    """EpisodeCarry without the host countdown: what a tick carries on."""

    x: torch.Tensor
    planner_state: mppi.PlannerState
    strategy_state: object
    pid_state: pid_module.PIDState
    torque_state: pid_module.PIDState


@dataclasses.dataclass
class EpisodeConfiguration:
    duration: float = 15.0
    time_step: float = 0.005
    controller_rate: float = 0.05
    forecast_time_step: float = 0.01
    forecast_horizon: float = 0.3
    wrench_enabled: bool = True  # False = "unassisted-of-wrench" base run
    # Drive the torque channel of the human wrench from the quaternion PID
    # against the orientation trajectory — the reference's intended-but-dead
    # path (external_wrench.cpp:214-221 is commented out and
    # QuaternionPID::update is an empty stub, pid.cpp:122-125). Defaults to
    # the reference's zero-torque reality.
    torque_enabled: bool = False
    # False = the "unassisted" rows of the reference experiment tables
    # (analysis.py:439-460): no wrench forecast reaches the planner, so the
    # trajectory/assistance term is zero (assisted_manipulation.cpp:237-240
    # returns 0 without a forecast) and the human gets no intent-directed
    # help.
    assisted: bool = True
    # Whether the MPPI controller runs at all. In the reference the
    # controller ALWAYS runs — an unassisted run still optimizes the
    # posture terms (velocity redistribution, manipulability, limits), so
    # the base actively follows a dragged arm (actor.cpp:166-203 has no
    # off-switch). False = plant-only (zero commands: PD holds the
    # base/gripper, the arm is gravity-compensated) — a harsher condition
    # with no reference analog, kept for plant-isolation diagnostics.
    controller_enabled: bool = True


def _write(buffers, values, index: torch.Tensor) -> None:
    """Write each tensor of ``values`` into row ``index`` ((1,) int64 on the
    device) of the same field of ``buffers``."""
    if isinstance(buffers, tuple):
        for buffer, value in zip(buffers, values):
            _write(buffer, value, index)
    else:
        buffers.index_copy_(0, index, values.unsqueeze(0).to(buffers.dtype))


def _allocate(values, rows: int):
    """(rows, ...) buffers shaped like each tensor of ``values``."""
    if isinstance(values, tuple):
        fields = [_allocate(value, rows) for value in values]
        return type(values)(*fields) if hasattr(values, "_fields") else tuple(fields)
    return torch.zeros((rows, *values.shape), dtype=values.dtype, device=values.device)


class Episode:
    """One experiment configuration, run on ``device`` (the card unless the
    caller asks for the CPU); ``capture`` (default: on a CUDA device)
    replays one CUDA graph per controller period."""

    def __init__(
        self,
        mppi_configuration: mppi.Configuration,
        objective,
        trajectory,
        episode: EpisodeConfiguration = None,
        wrench_strategy=None,
        robot_configuration: fr.Configuration = None,
        pid_configuration: pid_module.Configuration = None,
        dtype=torch.float32,
        collect_logs: bool = False,
        filter_fn=None,
        model=None,
        orientation_trajectory=None,
        torque_pid_configuration: pid_module.Configuration = None,
        device="cuda",
        capture: Optional[bool] = None,
    ):
        """``model`` overrides the robot model (e.g. a variant with other
        friction for plant-parameter sweeps). ``orientation_trajectory`` +
        ``episode.torque_enabled`` drive the wrench torque channel from the
        quaternion PID (the slerp scenario, slerp.hpp:14-67)."""
        self.episode = episode or EpisodeConfiguration()
        if collect_logs and not self.episode.assisted:
            raise ValueError("collect_logs requires an assisted episode")
        if collect_logs and not self.episode.controller_enabled:
            raise ValueError("collect_logs requires the controller")
        self.collect_logs = collect_logs
        self.device = resolve_device(device)
        self.capture = self.device.type == "cuda" if capture is None else capture
        if self.capture:
            graphs.require_cuda(self.device, "Episode(capture=True)")
        self._filter_fn = filter_fn
        self.dtype = dtype
        self.model = model if model is not None else frankaridgeback_model()
        self.robot_configuration = robot_configuration or fr.Configuration()
        _, self._kp, self._kd = self.robot_configuration.resolve()
        # The dynamics-backend seam the reference's SimulatorDynamics type
        # selects (actor_dynamics.cpp:46-86): the episode's own plant
        # quantities honour dynamics_type, not just make_plant's rollouts.
        self._backend = factory.create(self.robot_configuration.dynamics_type)

        self.objective = objective
        plant = fr.make_plant(objective, self.robot_configuration, self.model)
        self.planner = mppi.Planner(mppi_configuration, plant, filter_fn=filter_fn, device=self.device)
        self.trajectory = trajectory
        self.pid = pid_module.PID(pid_configuration or pid_module.HUMAN_POINT_CONTROL)
        # Always constructed, like the reference (external_wrench.cpp:88-95);
        # active only with an orientation trajectory + torque_enabled.
        self.orientation_trajectory = orientation_trajectory
        self.torque_pid = pid_module.QuaternionPID(torque_pid_configuration or pid_module.HUMAN_ORIENTATION_CONTROL)
        self._torque_on = orientation_trajectory is not None and self.episode.torque_enabled
        self.wrench_strategy = wrench_strategy or fc.KalmanForecast(
            fc.KalmanForecastConfiguration(
                observed_states=6,
                order=1,
                time_step=self.episode.forecast_time_step,
                horizon=self.episode.forecast_horizon,
            )
        )
        self.dynamics_forecast = DynamicsForecast(
            DynamicsForecastConfiguration(
                time_step=self.episode.forecast_time_step, horizon=self.episode.forecast_horizon
            ),
            self.robot_configuration,
            self.model,
        )

        self.ticks = int(round(self.episode.duration / self.episode.time_step))
        self.countdown_max = int(round(self.episode.controller_rate / self.episode.time_step))
        # Filled by a captured run: the period's graph and its device
        # operation count per replay is what chip_smoke.py profiles.
        self.graph: Optional[graphs.CapturedGraph] = None

    def init_carry(self, seed: int = 0) -> EpisodeCarry:
        initial, _, _ = self.robot_configuration.resolve()
        return EpisodeCarry(
            x=torch.as_tensor(np.asarray(initial), dtype=self.dtype).to(self.device),
            planner_state=self.planner.init(seed=seed),
            strategy_state=self.wrench_strategy.init(self.dtype, self.device),
            pid_state=self.pid.init(self.dtype, self.device),
            torque_state=self.torque_pid.init(self.dtype, self.device),
            countdown=0,  # update on the first tick
        )

    def _fire_ticks(self, countdown: int) -> list:
        """The ticks whose controller update fires, from a carry's countdown
        (the JAX scan's ``countdown <= 0`` schedule)."""
        if not self.episode.controller_enabled:
            return []
        return list(range(max(countdown, 0), self.ticks, self.countdown_max))

    # -- one tick ------------------------------------------------------------

    def _tick(self, carry, k: torch.Tensor, update_fn):
        """One simulator tick at tick number ``k`` (0-d int64 on the device).
        ``update_fn(planner_state, x, t, ctx)`` is the controller update when
        this tick fires, else None. Returns (carry without the countdown,
        EpisodeOutputs row, per-tick log row, per-update log row or None)."""
        x, planner_state, strategy_state, pid_state, torque_state = carry
        dt = self.episode.time_step
        t = k.to(self.dtype) * dt
        model = self.model

        aux = fr.derive_aux(model, x, backend=self._backend)

        # Human model wrench (external_wrench.cpp:185-231).
        reference = self.trajectory.position(t).to(self.dtype)
        pid_state = self.pid.set_reference(pid_state, reference)
        pid_state = self.pid.update(pid_state, aux.ee_position, t)
        if self._torque_on:
            # The reference's intended torque path
            # (external_wrench.cpp:214-221, commented out there):
            # quaternion PID toward the orientation trajectory.
            reference_quat = self.orientation_trajectory.orientation(t).to(self.dtype)
            torque_state = self.torque_pid.update_quaternion(torque_state, aux.ee_orientation, reference_quat, t)
            torque = torque_state.control
        else:
            reference_quat = constant(np.zeros(4), x)
            torque = constant(np.zeros(3), x)
        if self.episode.wrench_enabled:
            wrench = torch.cat([pid_state.control, torque])
        else:
            wrench = constant(np.zeros(6), x)

        # Forecast observation every tick (forecast_rate = 0,
        # base.hpp:150, actor.cpp:154-163).
        strategy_state = self.wrench_strategy.update(strategy_state, wrench, t)

        update = None
        if self.episode.controller_enabled:
            if update_fn is not None:
                # Controller update at the rate division (actor.cpp:172-192).
                if self.episode.assisted:
                    rollout, ctx = self.dynamics_forecast.forecast(
                        x, t, lambda tq: self.wrench_strategy.forecast(strategy_state, tq)
                    )
                else:
                    # No forecast: the trajectory/assistance term is
                    # inactive (assisted_manipulation.cpp:237-240), the
                    # posture terms still optimize.
                    rollout, ctx = None, None
                planner_state, info = update_fn(planner_state, x, t, ctx)
                update = (info, planner_state.optimal_control, rollout)
            u = self.planner.get(planner_state, t)
        else:
            # Plant only: zero commands — PD holds the base/gripper, the arm
            # is gravity-compensated, the human drags the robot.
            u = constant(np.zeros(self.planner.plant.control_dof), x)
        kp, kd = constant(self._kp, x), constant(self._kd, x)
        x_next, qdd, tau = fr.integrate_with_wrench_extras(model, kp, kd, x, u, aux, wrench, dt)

        outputs = EpisodeOutputs(
            ee_position=aux.ee_position,
            reference=reference,
            wrench=wrench,
            control=u,
            tank_energy=x[fr.ENERGY],
            optimal_cost=planner_state.optimal_cost,
        )
        tick_logs = None
        if self.collect_logs:
            extras = fr.simulation_extras(model, aux, x, tau, qdd, backend=self._backend)
            tick_logs = (
                x, pid_state, extras.ee_linear_acceleration, extras.ee_angular_acceleration,
                extras.joint_power, torque_state, reference_quat,
            )
        return _TickCarry(x_next, planner_state, strategy_state, pid_state, torque_state), outputs, tick_logs, update

    # -- the run -------------------------------------------------------------

    def run(self, seed: int = 0, carry: Optional[EpisodeCarry] = None, noise_override=None):
        """Run the episode from ``carry`` (``init_carry(seed)`` by default).
        Returns EpisodeOutputs, and EpisodeLogs with ``collect_logs``; the
        final carry is left in ``self.final_carry``.

        ``noise_override`` (parity hook): (updates, rollouts, steps, dof),
        the sampled rows of each update of this run in order, passed to the
        planner's update as its ``noise_override`` (the JAX planner's hook,
        through which a test feeds both packages the same noise)."""
        carry = carry if carry is not None else self.init_carry(seed)
        fires = self._fire_ticks(carry.countdown)
        ticks, period, device = self.ticks, self.countdown_max, self.device
        if noise_override is not None:
            noise_override = torch.as_tensor(noise_override).to(device=device, dtype=self.planner.dtype)
            if noise_override.shape[0] < len(fires):
                raise ValueError(f"noise_override has {noise_override.shape[0]} updates, the run {len(fires)}")
        self._rows = torch.arange(ticks, device=device)
        self._update_rows = torch.arange(max(len(fires), 1), device=device)
        self._buffers = {}
        self.graph = None
        state = _TickCarry(*carry[:5])
        rng, updates = carry.planner_state.rng, 0

        # Captured: eager to the end of the first period, one replay per
        # further whole period, the rest eagerly.
        captured_from = captured_to = 0
        if self.capture and fires:
            captured_from = fires[0] + period
            captured_to = captured_from + max(0, (ticks - captured_from) // period) * period
        fire_set = set(fires)
        k = 0
        while k < ticks:
            if captured_from <= k < captured_to:
                state, rng = self._replay_periods(state, k, captured_to, rng, updates, noise_override)
                updates += (captured_to - k) // period
                k = captured_to
                continue
            update_fn = None
            if k in fire_set:
                override = None if noise_override is None else noise_override[updates]

                def update_fn(planner_state, x, t, ctx, override=override):
                    return self.planner.update(planner_state, x, t, ctx, noise_override=override)

            state, update = self._record_tick(state, self._rows[k], update_fn, self._update_rows[updates : updates + 1])
            if update is not None:
                rng = state.planner_state.rng
                updates += 1
            k += 1

        if fires:
            countdown = fires[-1] + period - ticks
        else:
            countdown = carry.countdown - ticks if self.episode.controller_enabled else carry.countdown
        self.final_carry = EpisodeCarry(*state._replace(planner_state=state.planner_state._replace(rng=rng)), countdown)
        outputs = EpisodeOutputs(*self._buffers["outputs"])
        if not self.collect_logs:
            return outputs
        x, pid_state, lin_acc, ang_acc, power, torque_state, torque_reference = self._buffers["ticks"]
        info, optimal_control, forecast = self._buffers["updates"]
        fired = torch.zeros(ticks, dtype=torch.bool, device=device)
        fired[fires] = True
        return outputs, EpisodeLogs(
            x=x, pid=pid_state, update_fired=fired, update_info=info, optimal_control=optimal_control,
            forecast=forecast, ee_linear_acceleration=lin_acc, ee_angular_acceleration=ang_acc,
            joint_power=power, torque_pid=torque_state, torque_reference=torque_reference,
        )

    def _record_tick(self, state, k: torch.Tensor, update_fn, update_row: torch.Tensor):
        """One tick with its outputs written at row ``k`` and its update's
        logs at ``update_row`` ((1,) int64); the buffers are made at the
        first write. Returns (carry, the update's log row or None)."""
        state, outputs, tick_logs, update = self._tick(state, k, update_fn)
        index = k.reshape(1)
        for name, values, rows, count in (
            ("outputs", outputs, index, self.ticks),
            ("ticks", tick_logs, index, self.ticks),
            ("updates", update if self.collect_logs else None, update_row, len(self._update_rows)),
        ):
            if values is not None:
                if name not in self._buffers:
                    self._buffers[name] = _allocate(values, count)
                _write(self._buffers[name], values, rows)
        return state, update

    def _replay_periods(self, state, start: int, stop: int, rng, updates: int, noise_override):
        """Ticks ``start`` .. ``stop`` (whole periods, each starting with an
        update) as replays of one captured period, the first of them
        ``updates``. Returns (carry, the planner's key after them)."""
        if self.graph is None:
            self._capture_period(state, noise_override)
        graphs.load(self._static, state, "carry")
        for first in range(start, stop, self.countdown_max):
            self._start.fill_(first)
            self._update_index.fill_(updates)
            if noise_override is not None:
                self._noise.copy_(noise_override[updates])
            rng, seed = split_key(rng)
            self.planner.sampler.seed_replay(seed)
            self.graph.replay()
            updates += 1
        return self._static._replace(planner_state=self._static.planner_state._replace(rng=rng)), rng

    def _capture_period(self, state, noise_override) -> None:
        """Capture one controller period on static buffers: the carry, the
        period's first tick and its update's row, and an injected run's
        noise rows."""
        device, planner = self.device, self.planner
        self._static = graphs.static_copy(state)
        self._start = torch.zeros((), dtype=torch.int64, device=device)
        self._update_index = torch.zeros(1, dtype=torch.int64, device=device)
        self._noise = None if noise_override is None else noise_override[0].clone()

        def update_fn(planner_state, x, t, ctx):
            override = None if self._noise is None else noise_from_logical(self._noise)
            return planner.device_update(planner_state, x, t, ctx, graphs.GRAPH_SEED, noise_override=override)

        def body():
            carry = self._static
            for j in range(self.countdown_max):
                carry, _ = self._record_tick(carry, self._start + j, update_fn if j == 0 else None,
                                             self._update_index)
            graphs.write_back(self._static, carry)

        generators, host_inputs = planner.sampler.graph_rng()
        self.graph = graphs.CapturedGraph(body, generators, host_inputs, entry="episode")


def episode_metrics(outputs: EpisodeOutputs) -> dict:
    """The analysis summary metrics (analysis.py:350-504): mean user force
    magnitude and reference-tracking RMSE."""

    def host(value):
        return value.detach().cpu().numpy().astype(np.float64)

    force = np.linalg.norm(host(outputs.wrench[:, :3]), axis=-1)
    error = host(outputs.ee_position) - host(outputs.reference)
    rmse = float(np.sqrt(np.mean(np.sum(error**2, axis=-1))))
    return {
        "mean_force": float(force.mean()),
        "max_force": float(force.max()),
        "rmse": rmse,
        "final_energy": float(host(outputs.tank_energy)[-1]),
    }

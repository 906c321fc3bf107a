"""Actor: the composition root wiring plant dynamics + MPPI controller +
dynamics forecast, with countdown-based rate division (port of
assistedmanipulation_tpu/sim/actor.py).

Re-implements FrankaRidgeback::Actor (simulation/frankaridgeback/actor.cpp):

- the controller updates every ``controller_rate / sim_dt`` ticks with
  ``controller_substeps`` repeats (actor.cpp:166-192);
- wrench observations feed the forecast strategy at most every
  ``forecast_rate`` (actor.cpp:154-164); between controller updates the
  strategy gets prediction-only ticks (actor.cpp:194-198);
- every tick queries the interpolated control and steps the plant with the
  accumulated external wrench (actor.cpp:200-202).

The countdowns are host integers, as in the JAX actor; every tensor stays
on the actor's device. On a CUDA device the planner update replays one
CUDA graph per update (``Planner.capture``, made at the first update);
``capture=False`` keeps it eager. The dynamics forecast, the query and the
plant step run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import mppi, resolve_device
from ..forecast import forecast as fc
from ..forecast.dynamics_forecast import (
    Configuration as DynamicsForecastConfiguration,
    DynamicsForecast,
)
from ..models import factory
from ..models import frankaridgeback as fr
from ..models.model_data import frankaridgeback_model
from ..objectives.assisted_manipulation import (
    AssistedManipulation,
    Configuration as AssistedManipulationConfiguration,
)
from ..objectives.track_point import (
    Configuration as TrackPointConfiguration,
    TrackPoint,
)
from ..safety import Configuration as SafetyConfiguration


@dataclasses.dataclass
class ObjectiveConfiguration:
    type: str = "assisted_manipulation"
    assisted_manipulation: Optional[AssistedManipulationConfiguration] = None
    track_point: Optional[TrackPointConfiguration] = None


@dataclasses.dataclass
class ForecastConfiguration:
    # merge-patch can't express "delete the optional forecast" (the
    # reference documents this wart at pose.hpp:50-60); an explicit flag can.
    enabled: bool = True
    configuration: DynamicsForecastConfiguration = dataclasses.field(
        default_factory=DynamicsForecastConfiguration
    )
    end_effector_wrench_forecast: fc.Configuration = dataclasses.field(
        default_factory=lambda: fc.Configuration(
            type="kalman",
            kalman=fc.KalmanForecastConfiguration(
                observed_states=6,
                time_step=0.01,
                horizon=0.3,
                order=1,
            ),
        )
    )


@dataclasses.dataclass
class Configuration:
    """Mirror of Actor::Configuration defaults (base.hpp:68-151)."""

    mppi: mppi.Configuration = dataclasses.field(
        default_factory=lambda: mppi.Configuration(
            rollouts=50,
            keep_best_rollouts=20,
            time_step=0.01,
            horizon=0.3,
            gradient_step=2.0,
            cost_scale=10.0,
            cost_discount_factor=1.0,
            covariance=fr.DEFAULT_COVARIANCE,
            control_bound=True,
            control_min=fr.DEFAULT_CONTROL_MIN,
            control_max=fr.DEFAULT_CONTROL_MAX,
            control_default=np.zeros(12),
            smoothing=mppi.Smoothing(window=10, order=1),
        )
    )
    dynamics: fr.Configuration = dataclasses.field(default_factory=fr.Configuration)
    objective: ObjectiveConfiguration = dataclasses.field(default_factory=ObjectiveConfiguration)
    forecast: Optional[ForecastConfiguration] = dataclasses.field(default_factory=ForecastConfiguration)
    controller_rate: float = 0.05
    controller_substeps: int = 1
    forecast_rate: float = 0.0
    # Optional QP trajectory safety filter (safety.Configuration). None =
    # disabled, matching the reference actor's nullptr filter
    # (actor.cpp:96-101).
    safety_filter: Optional[SafetyConfiguration] = None


def make_objective(configuration: ObjectiveConfiguration):
    """The actor's objective (actor.cpp:20-48)."""
    if configuration.type == "assisted_manipulation":
        return AssistedManipulation(configuration.assisted_manipulation or AssistedManipulationConfiguration())
    if configuration.type == "track_point":
        return TrackPoint(configuration.track_point or TrackPointConfiguration())
    raise ValueError(f"unknown objective type {configuration.type}")


class Actor:
    """Stateful host-side wrapper: the per-tick loop is host logic at
    ~200 Hz; each step inside runs on the actor's device."""

    def __init__(
        self,
        configuration: Configuration,
        sim_time_step: float,
        dtype=torch.float32,
        device="cuda",
        capture: Optional[bool] = None,
    ):
        if configuration.controller_substeps < 1:
            raise ValueError("actor substeps must be at least one")
        self.configuration = configuration
        self.dtype = dtype
        self.device = resolve_device(device)
        self.capture = self.device.type == "cuda" if capture is None else capture
        self.model = frankaridgeback_model()
        self.objective = make_objective(configuration.objective)

        plant = fr.make_plant(self.objective, configuration.dynamics, self.model)
        # Optional QP safety filter (the reference's actor always passed a
        # nullptr filter because TrajectorySafetyFilter was a stub,
        # actor.cpp:96-101; this one is real, safety.make_safety_filter).
        filter_fn = None
        if configuration.safety_filter is not None:
            from .. import safety as safety_module

            filter_fn = safety_module.make_safety_filter(configuration.safety_filter)
        self.planner = mppi.Planner(configuration.mppi, plant, filter_fn=filter_fn, device=self.device)
        self.plant_step = fr.make_plant_step(configuration.dynamics, self.model)
        # Backend for the actor's own aux queries, matching plant_step's
        # (the SimulatorDynamics type seam, actor_dynamics.cpp:46-86).
        self._backend = factory.create(configuration.dynamics.dynamics_type)

        # Forecast (actor.cpp:55-80).
        if configuration.forecast is not None and configuration.forecast.enabled:
            self.wrench_forecast = fc.create(configuration.forecast.end_effector_wrench_forecast)
            self.dynamics_forecast = DynamicsForecast(
                configuration.forecast.configuration, configuration.dynamics, self.model
            )
        else:
            self.wrench_forecast = None
            self.dynamics_forecast = None

        # Rate division (actor.cpp:107-116).
        self._controller_countdown_max = int(configuration.controller_rate / sim_time_step)
        self._forecast_countdown_max = int(configuration.forecast_rate / sim_time_step)
        self._sim_time_step = sim_time_step
        self._captured = None

        self.reset()

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=self.dtype, device=self.device)

    def reset(self, initial_state: Optional[np.ndarray] = None):
        initial, _, _ = self.configuration.dynamics.resolve()
        if initial_state is not None:
            initial = np.asarray(initial_state)
        self.x = self._tensor(np.asarray(initial))
        self.planner_state = self.planner.init()
        self.forecast_state = (
            self.wrench_forecast.init(self.dtype, self.device) if self.wrench_forecast is not None else None
        )
        self.ctx = None
        self.control = torch.zeros(12, dtype=self.dtype, device=self.device)
        self.aux = fr.derive_aux(self.model, self.x, backend=self._backend)
        self.last_forecast_rollout = None
        self.last_update_info = None
        self._trajectory_countdown = 0  # update on first tick (actor.cpp:147)
        self._forecast_countdown = 0
        self._pending_wrench = torch.zeros(6, dtype=self.dtype, device=self.device)

    # -- observation path (actor.cpp:154-164) --------------------------------

    def add_end_effector_wrench(self, wrench, time):
        """Apply an external wrench this tick and feed the forecast."""
        wrench = self._tensor(wrench)
        self._pending_wrench = self._pending_wrench + wrench
        if self.wrench_forecast is not None and self._forecast_countdown <= 0:
            self.forecast_state = self.wrench_forecast.update(self.forecast_state, wrench, self._tensor(time))
            self._forecast_countdown = self._forecast_countdown_max

    # -- control path (actor.cpp:166-203) ------------------------------------

    def _update(self, x, time):
        """One planner update: the captured graph on a CUDA device unless
        ``capture=False``, made at the first update; ``planner.update``
        otherwise."""
        if not self.capture:
            return self.planner.update(self.planner_state, x, time, self.ctx)
        if self._captured is None:
            self._captured = self.planner.capture(self.planner_state, x, time, self.ctx)
        return self._captured(self.planner_state, x, time, self.ctx)

    def act(self, time):
        """One simulator tick: maybe update the controller, query the
        interpolated control, step the plant."""
        t = self._tensor(time)
        self._trajectory_countdown -= 1
        if self._trajectory_countdown <= 0:
            self._trajectory_countdown = self._controller_countdown_max

            if self.dynamics_forecast is not None:
                strategy, strategy_state = self.wrench_forecast, self.forecast_state
                rollout, self.ctx = self.dynamics_forecast.forecast(
                    self.x, t, lambda tq: strategy.forecast(strategy_state, tq)
                )
                self.last_forecast_rollout = rollout

            for _ in range(self.configuration.controller_substeps):
                self.planner_state, self.last_update_info = self._update(self.x, t)

        if self.wrench_forecast is not None:
            if self._forecast_countdown != self._forecast_countdown_max:
                self.forecast_state = self.wrench_forecast.observe_time(self.forecast_state, t)
            self._forecast_countdown -= 1

        self.control = self.planner.get(self.planner_state, t)
        self.x, self.aux = self.plant_step(self.x, self.control, self._pending_wrench, self._sim_time_step)
        self._pending_wrench = torch.zeros(6, dtype=self.dtype, device=self.device)
        return self.control

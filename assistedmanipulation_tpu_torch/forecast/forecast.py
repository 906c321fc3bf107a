"""Wrench forecast strategies: LOCF, sliding-window average, Kalman (port of
assistedmanipulation_tpu/forecast/forecast.py).

Functional re-design of the reference's polymorphic Forecast hierarchy
(src/controller/forecast.hpp:14-416, forecast.cpp). Each strategy is an
explicit state (a NamedTuple of tensors) with pure update/forecast
functions; nothing reads a value back to the host, so the serving loop's
forecast step stays on the device. The shared_mutex synchronization
disappears: states are values.

The reference factory bug at forecast.cpp:19-25 (AVERAGE validating the locf
config) is not reproduced; create() validates the matching config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops import per_step, take_rows
from .kalman import (
    KalmanSpec,
    KalmanState,
    euler_state_transition_matrix,
    kalman_init,
    kalman_predict,
    kalman_update,
)


def _tensor(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` in ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype).to(like.device)


# --- LOCF (forecast.hpp:62-140) ----------------------------------------------


@dataclasses.dataclass
class LOCFConfiguration:
    observation: Optional[np.ndarray] = None  # initial observation
    horizon: float = 0.3
    states: int = 6


class LOCFState(NamedTuple):
    observation: torch.Tensor  # (n,)
    valid_until: torch.Tensor  # 0-d


class LOCFForecast:
    """Last observation carried forward with a validity horizon."""

    def __init__(self, configuration: LOCFConfiguration):
        self.configuration = configuration

    def init(self, dtype=torch.float32, device="cuda") -> LOCFState:
        device = resolve_device(device)
        c = self.configuration
        observation = (
            torch.as_tensor(np.asarray(c.observation), dtype=dtype)
            if c.observation is not None
            else torch.zeros(c.states, dtype=dtype)
        )
        return LOCFState(
            observation=observation.to(device),
            valid_until=torch.zeros((), dtype=dtype, device=device),
        )

    def update(self, state: LOCFState, measurement, time) -> LOCFState:
        return LOCFState(
            observation=_tensor(measurement, state.observation),
            valid_until=_tensor(time + self.configuration.horizon, state.valid_until),
        )

    def observe_time(self, state: LOCFState, time) -> LOCFState:
        return state  # no-op (forecast.hpp:107-108)

    def forecast(self, state: LOCFState, time) -> torch.Tensor:
        expired = _tensor(time, state.valid_until) > state.valid_until
        return torch.where(expired, torch.zeros_like(state.observation), state.observation)


# --- Sliding-window average (forecast.hpp:147-231, forecast.cpp:41-128) ------


@dataclasses.dataclass
class AverageConfiguration:
    states: int = 6
    window: float = 0.3
    # Static ring capacity (the reference uses an unbounded deque; a static
    # ring holds max_measurements most-recent samples).
    max_measurements: int = 64


class AverageState(NamedTuple):
    buffer: torch.Tensor  # (capacity, n)
    times: torch.Tensor  # (capacity,) -inf where empty
    cursor: torch.Tensor  # 0-d int32 ring insert position
    last: torch.Tensor  # 0-d most recent measurement time


class AverageForecast:
    """Mean of all measurements within the trailing time window."""

    def __init__(self, configuration: AverageConfiguration):
        if configuration.window < 0:
            raise ValueError("prediction window time is negative")
        self.configuration = configuration

    def init(self, dtype=torch.float32, device="cuda") -> AverageState:
        device = resolve_device(device)
        c = self.configuration
        return AverageState(
            buffer=torch.zeros((c.max_measurements, c.states), dtype=dtype, device=device),
            times=torch.full((c.max_measurements,), -math.inf, dtype=dtype, device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
            last=torch.zeros((), dtype=dtype, device=device),
        )

    def update(self, state: AverageState, measurement, time) -> AverageState:
        """Insert a measurement; stale measurements (older than the window)
        are masked at query time. Measurements in the past are ignored
        (forecast.cpp:113-117)."""
        time = _tensor(time, state.last)
        stale = time < state.last
        measurement = _tensor(measurement, state.buffer)
        slot = torch.arange(self.configuration.max_measurements, device=state.cursor.device)
        write = (slot == state.cursor) & ~stale
        return AverageState(
            buffer=torch.where(write[:, None], measurement, state.buffer),
            times=torch.where(write, time, state.times),
            cursor=torch.where(
                stale, state.cursor, (state.cursor + 1) % self.configuration.max_measurements
            ),
            last=torch.maximum(state.last, time),
        )

    def observe_time(self, state: AverageState, time) -> AverageState:
        """Advance the window clock (clear_old_measurements semantics,
        forecast.cpp:102-107): expiry is handled by masking against ``last``."""
        return state._replace(last=torch.maximum(state.last, _tensor(time, state.last)))

    def forecast(self, state: AverageState, time) -> torch.Tensor:
        """Average of in-window measurements; zero if empty
        (forecast.cpp:86-100, 124-128). The most recent measurement is always
        retained even when the window has expired — the reference's
        clear_old_measurements comment and its own unit test
        (test/case/forecast.cpp:95-98) specify this, though the deque
        implementation erases everything; this implements the intended,
        tested behaviour."""
        finite = torch.isfinite(state.times)
        most_recent = state.times == torch.max(state.times)
        in_window = state.times > (state.last - self.configuration.window)
        included = (in_window | most_recent) & finite
        count = torch.sum(included)
        total = torch.sum(torch.where(included[:, None], state.buffer, 0.0), dim=0)
        average = total / torch.clamp(count, min=1)
        return torch.where(finite.any() & (count > 0), average, torch.zeros_like(average))


# --- Kalman forecast (forecast.hpp:238-385, forecast.cpp:130-367) ------------


@dataclasses.dataclass
class KalmanForecastConfiguration:
    observed_states: int = 6
    order: int = 1
    time_step: float = 0.01
    horizon: float = 0.3
    variance: Optional[np.ndarray] = None  # (observed_states,): unused, as in the reference
    initial_state: Optional[np.ndarray] = None
    # Noise model with no reference equivalent: the reference pins both
    # covariances at 1e-8 I (forecast.cpp:277-286), leaving the posterior
    # degenerate, fine for the mean forecast and useless for the scenario
    # ensemble of forecast/scenarios.py. When set, these scale the
    # observation / transition covariances. None = the reference's 1e-8.
    observation_variance: Optional[float] = None
    transition_variance: Optional[float] = None

    @property
    def steps(self) -> int:
        return int(math.ceil(self.horizon / self.time_step))

    @property
    def states(self) -> int:
        return self.observed_states * (self.order + 1)


class KalmanForecastState(NamedTuple):
    filter: KalmanState
    measurement: torch.Tensor  # (states,) stacked value + fd derivatives
    prediction: torch.Tensor  # (steps + 1, observed_states)
    last_update: torch.Tensor  # 0-d


class KalmanForecast:
    """Constant-derivative Kalman wrench predictor with a cached horizon.

    Matches KalmanForecast (forecast.cpp:130-367): the filter observes the
    full derivative-augmented state (H = I) built from finite differences of
    the measurements; after each update a predictor clone rolls the model
    ``steps`` times caching the horizon; queries linearly interpolate and
    return zero beyond the horizon. The roll is one product with the
    precomputed observed rows of F^0..F^steps (``horizon_map``).
    """

    def __init__(self, configuration: KalmanForecastConfiguration):
        c = configuration
        self.configuration = c
        n = c.states
        observation_variance = 1e-8 if c.observation_variance is None else c.observation_variance
        transition_variance = 1e-8 if c.transition_variance is None else c.transition_variance
        self.spec = KalmanSpec(
            state_transition=euler_state_transition_matrix(c.time_step, c.observed_states, c.order),
            transition_covariance=np.eye(n) * transition_variance,
            observation=np.eye(n),
            observation_covariance=np.eye(n) * observation_variance,
        ).validate()
        self._horizon_maps = {}

    def horizon_map(self, dtype, device) -> torch.Tensor:
        """(steps + 1, observed, n): rows [:observed] of F^k for k = 0..steps,
        computed on the host in float64 and cast once per dtype and device.
        ``horizon_map @ x`` is the predictor's roll of x over the horizon
        (kalman_predict's state without covariance, ``steps`` times)."""
        key = (dtype, torch.device(device))
        if key not in self._horizon_maps:
            c = self.configuration
            F = self.spec.state_transition
            powers = [np.eye(c.states)]
            for _ in range(c.steps):
                powers.append(F @ powers[-1])
            stack = np.stack(powers)[:, : c.observed_states, :]
            self._horizon_maps[key] = torch.as_tensor(stack, dtype=dtype).to(device)
        return self._horizon_maps[key]

    def init(self, dtype=torch.float32, device="cuda") -> KalmanForecastState:
        device = resolve_device(device)
        c = self.configuration
        initial = torch.zeros(c.states, dtype=dtype)
        if c.initial_state is not None:
            initial[: c.observed_states] = torch.as_tensor(np.asarray(c.initial_state), dtype=dtype)
        initial = initial.to(device)
        return KalmanForecastState(
            filter=kalman_init(
                self.spec, initial, torch.eye(c.states, dtype=dtype, device=device) * 1e-8
            ),
            measurement=torch.zeros(c.states, dtype=dtype, device=device),
            prediction=torch.zeros((c.steps + 1, c.observed_states), dtype=dtype, device=device),
            # First dt = time - (-time_step) (forecast.cpp:195).
            last_update=torch.full((), -c.time_step, dtype=dtype, device=device),
        )

    def update(self, state: KalmanForecastState, measurement, time) -> KalmanForecastState:
        """Measurement update: finite-difference derivative stacking
        (forecast.cpp:288-310), filter update, horizon roll
        (forecast.cpp:322-330)."""
        c = self.configuration
        o = c.observed_states
        measurement = _tensor(measurement, state.measurement)
        time = _tensor(time, state.last_update)
        dt = time - state.last_update

        stacked = state.measurement
        delta = (measurement - stacked[:o]) / dt
        new_stacked = stacked.clone()
        for i in range(1, c.order + 1):
            next_delta = (delta - stacked[o * i : o * (i + 1)]) / dt
            new_stacked[o * i : o * (i + 1)] = delta
            delta = next_delta
        new_stacked[:o] = measurement

        filter_state = kalman_update(self.spec, state.filter, new_stacked)

        # Roll a predictor clone over the horizon (covariance not updated,
        # forecast.cpp:327 predict(false)): the predictor's k-th state is
        # F^k applied to the corrected state, one product for all k.
        horizon = self.horizon_map(filter_state.state.dtype, filter_state.state.device)
        return KalmanForecastState(
            filter=filter_state,
            measurement=new_stacked,
            prediction=horizon @ filter_state.state,
            last_update=time,
        )

    def observe_time(self, state: KalmanForecastState, time) -> KalmanForecastState:
        """Prediction-only tick (forecast.cpp:332-340): extrapolate the
        filter, leave the cached horizon untouched."""
        advance = _tensor(time, state.last_update) > state.last_update
        predicted = kalman_predict(self.spec, state.filter, update_covariance=True)
        filter_state = KalmanState(
            *(torch.where(advance, new, old) for new, old in zip(predicted, state.filter))
        )
        return state._replace(filter=filter_state)

    def forecast(self, state: KalmanForecastState, time) -> torch.Tensor:
        """Linear interpolation into the cached horizon; zero beyond it
        (forecast.cpp:342-367)."""
        c = self.configuration
        elapsed = _tensor(time, state.last_update) - state.last_update
        rel = per_step(elapsed, c.time_step)
        lower = torch.clamp(rel.to(torch.int32), 0, c.steps - 1)
        frac = torch.clamp(rel - lower, 0.0, 1.0)
        lower = lower.long()
        value = (1.0 - frac)[..., None] * take_rows(state.prediction, lower) + frac[..., None] * take_rows(
            state.prediction, lower + 1
        )
        return torch.where(elapsed > c.horizon, torch.zeros_like(value), value)


# --- factory (forecast.cpp:7-39) ---------------------------------------------


@dataclasses.dataclass
class Configuration:
    type: str = "kalman"  # "locf" | "average" | "kalman"
    locf: Optional[LOCFConfiguration] = None
    average: Optional[AverageConfiguration] = None
    kalman: Optional[KalmanForecastConfiguration] = None


ForecastStrategy = Union[LOCFForecast, AverageForecast, KalmanForecast]


def create(configuration: Configuration) -> ForecastStrategy:
    if configuration.type == "locf":
        return LOCFForecast(configuration.locf or LOCFConfiguration())
    if configuration.type == "average":
        return AverageForecast(configuration.average or AverageConfiguration())
    if configuration.type == "kalman":
        return KalmanForecast(configuration.kalman or KalmanForecastConfiguration())
    raise ValueError(f"unknown forecast type {configuration.type}")

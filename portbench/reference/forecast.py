"""The plain reference of the serving tick's forecast half: one Kalman
update of the wrench forecast with its cached horizon
(``Actor::add_end_effector_wrench`` -> ``KalmanForecast::update``,
forecast.cpp:288-330, and ``KalmanFilter::update``, kalman.cpp:103-138, of
the C++ reference), and the posterior scenario ensemble drawn from it.

Plain PyTorch on whatever device its tensors are on; it imports nothing of
the program. Inputs are the program's float32 state and the tick's float32
measurement and time; everything is computed in ``dtype`` (float64 for the
judge, bfloat16 for the benchmark's lower-precision control, whose solve and
factorisation go through float32 and are rounded back, as
``linalg.py``'s are).

Departures from the C++ reference, each also the program's:

- the observation and transition covariances are the configuration's
  variances times I; the C++ reference pins both at 1e-8 I
  (forecast.cpp:277-286);
- the gain K = P S^-1 comes from a linear solve, not an explicit inverse;
- the predictor's roll over the horizon is one product with the observed
  rows of F^0 .. F^steps (the C++ reference steps a clone ``steps`` times
  with ``predict(false)``, the same values in exact arithmetic);
- the constructor fault at kalman.cpp:81-87 (the filter built twice, an
  uninitialised ``next_state`` multiplied) is not reproduced: the state
  starts as the member initialisers at kalman.cpp:90-101 leave it;
- the scenario ensemble has no C++ counterpart (BASELINE.json configs[4],
  the port's ``forecast/scenarios.py``): scenario 0 is the cached mean
  prediction, scenarios 1 .. C-1 are draws x + L z from the posterior
  (L the Cholesky factor of the symmetrised covariance plus 1e-10 I, NaN
  where it fails) rolled through the same predictor."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Precisions that torch's solve and factorisation do not take: computed in
# float32, each result rounded back.
_UPCAST = (torch.bfloat16, torch.float16)
JITTER = 1e-10  # added to the symmetrised posterior before its factorisation
INITIAL_COVARIANCE = 1e-8  # the filter's first covariance, times I


def euler_transition(time_step: float, observed: int, order: int) -> np.ndarray:
    """The constant-derivative transition F (forecast.cpp:212-275): block
    (i, i + j) of each observed state's derivative group is dt^j / j!."""
    n = observed * (order + 1)
    F = np.zeros((n, n))
    for derivative in range(order + 1):
        for state in range(observed):
            row = derivative * observed + state
            for j in range(order - derivative + 1):
                F[row, (derivative + j) * observed + state] = time_step**j / math.factorial(j)
    return F


@dataclasses.dataclass(frozen=True)
class Forecast:
    """The forecast of a configuration's ``forecast`` block."""

    observed: int
    order: int
    time_step: float
    horizon: float
    transition: np.ndarray  # F (n, n)
    transition_variance: float
    observation_variance: float

    @classmethod
    def from_config(cls, config: dict) -> "Forecast":
        f = config["forecast"]
        if f["type"] != "kalman":
            raise ValueError(f"the tick's reference forecasts by a Kalman filter, not {f['type']!r}")
        observed, order = int(f["observed_states"]), int(f["order"])
        return cls(observed, order, float(f["time_step"]), float(f["horizon"]),
                   euler_transition(float(f["time_step"]), observed, order),
                   float(f["transition_variance"]), float(f["observation_variance"]))

    @property
    def states(self) -> int:
        return self.observed * (self.order + 1)

    @property
    def steps(self) -> int:
        return int(math.ceil(self.horizon / self.time_step))

    def horizon_map(self) -> np.ndarray:
        """(steps + 1, observed, n): the observed rows of F^0 .. F^steps."""
        powers = [np.eye(self.states)]
        for _ in range(self.steps):
            powers.append(self.transition @ powers[-1])
        return np.stack(powers)[:, : self.observed, :]


def init_state(forecast: Forecast, device, precision=torch.float32) -> dict:
    """The forecast's first state, as the program builds it: zeros, the
    covariance 1e-8 I, the first update's dt measured from -time_step
    (forecast.cpp:195)."""
    n = forecast.states
    zeros = torch.zeros(n, dtype=precision, device=device)
    F = torch.as_tensor(forecast.transition, dtype=precision).to(device)
    return {
        "state": zeros,
        "next_state": (F @ zeros[:, None])[:, 0],
        "covariance": torch.eye(n, dtype=precision, device=device) * INITIAL_COVARIANCE,
        "measurement": torch.zeros(n, dtype=precision, device=device),
        "prediction": torch.zeros((forecast.steps + 1, forecast.observed), dtype=precision, device=device),
        "last_update": torch.full((), -forecast.time_step, dtype=precision, device=device),
    }


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    if A.dtype in _UPCAST:
        return torch.linalg.solve(A.float(), B.float()).to(A.dtype)
    return torch.linalg.solve(A, B)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """The lower factor of A; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A.float() if A.dtype in _UPCAST else A)
    L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
    return L.to(A.dtype)


def update(forecast: Forecast, state: dict, measurement, time, dtype=torch.float64) -> dict:
    """The forecast state after the measurement ``measurement`` (observed,)
    at ``time``: the finite-difference derivative stack (forecast.cpp:288-310),
    the filter's measurement update and one-step prediction with H = I
    (kalman.cpp:103-138), and the cached horizon (forecast.cpp:322-330).
    ``last_update`` stays in the state's precision (the time is exact)."""
    device = state["state"].device
    o, n = forecast.observed, forecast.states
    z = torch.as_tensor(measurement).to(device=device, dtype=dtype)
    time = torch.as_tensor(time, dtype=state["last_update"].dtype, device=device)
    dt = time.to(dtype) - state["last_update"].to(dtype)

    stacked = state["measurement"].to(dtype)
    delta = (z - stacked[:o]) / dt
    new = stacked.clone()
    for i in range(1, forecast.order + 1):
        following = (delta - stacked[o * i: o * (i + 1)]) / dt
        new[o * i: o * (i + 1)] = delta
        delta = following
    new[:o] = z

    F = torch.as_tensor(forecast.transition).to(device=device, dtype=dtype)
    eye = torch.eye(n, dtype=dtype, device=device)
    P = state["covariance"].to(dtype)
    predicted = state["next_state"].to(dtype)
    innovation = P + forecast.observation_variance * eye  # H P H^T + R
    gain = _solve(innovation.T, P.T).T  # P H^T S^-1
    corrected = predicted + gain @ (new - predicted)
    P = (eye - gain) @ P
    P = F @ P @ F.T + forecast.transition_variance * eye
    rows = torch.as_tensor(forecast.horizon_map()).to(device=device, dtype=dtype)
    return {
        "state": corrected,
        "next_state": F @ corrected,
        "covariance": P,
        "measurement": new,
        "prediction": rows @ corrected,
        "last_update": time,
    }


def draws(generator_state: torch.Tensor, scenarios: int, forecast: Forecast, device, precision=torch.float32):
    """(standard normals (scenarios - 1, n), the generator's state after):
    what ``torch.randn`` draws in the state's ``precision`` from a generator
    on ``device`` left at ``generator_state``."""
    generator = torch.Generator(device=device)
    generator.set_state(generator_state)
    z = torch.randn((scenarios - 1, forecast.states), generator=generator, dtype=precision, device=device)
    return z, generator.get_state()


def scenarios(forecast: Forecast, state: dict, normals: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(C, steps + 1, observed) wrench horizons of the updated ``state``:
    scenario 0 its prediction, scenario c the draw x + L z_c rolled through
    the predictor."""
    P = state["covariance"].to(dtype)
    n = P.shape[0]
    P = 0.5 * (P + P.T) + JITTER * torch.eye(n, dtype=dtype, device=P.device)
    L = _cholesky(P)
    x = state["state"].to(dtype)[None] + normals.to(dtype) @ L.T
    rows = torch.as_tensor(forecast.horizon_map()).to(device=P.device, dtype=dtype)
    sampled = torch.einsum("kon,cn->cko", rows, x)
    return torch.cat([state["prediction"].to(dtype)[None], sampled], dim=0)

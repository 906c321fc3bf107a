"""Kalman filter as a pure function of an explicit state (port of
assistedmanipulation_tpu/forecast/kalman.py).

Re-implements the reference KalmanFilter (src/controller/kalman.cpp:103-152)
functionally:

- update: optimal gain K = P H^T (H P H^T + R)^-1; correct the previously
  predicted state; covariance (I - K H) P then extrapolate F P F^T + Q
  (kalman.cpp:106-137);
- predict: process-only extrapolation, optional covariance propagation
  (kalman.cpp:140-152).

The constructor bug at kalman.cpp:81-87 (building the filter twice and
multiplying an uninitialized next_state) is not reproduced; initialization
follows the (working) member-initializer path kalman.cpp:90-101.

The filter's covariances are ~1e-8, so a float32 matmul must run in full
float32: with TF32 (about three decimal digits) the update and predict
raise instead of returning a wrong posterior.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.precision import check_f32_matmuls


@dataclasses.dataclass(frozen=True)
class KalmanSpec:
    """Static filter matrices (host numpy)."""

    state_transition: np.ndarray  # F (n, n)
    transition_covariance: np.ndarray  # Q (n, n)
    observation: np.ndarray  # H (m, n)
    observation_covariance: np.ndarray  # R (m, m)

    def validate(self):
        n = self.state_transition.shape[0]
        m = self.observation.shape[0]
        shapes = (
            (self.state_transition, (n, n)),
            (self.transition_covariance, (n, n)),
            (self.observation, (m, n)),
            (self.observation_covariance, (m, m)),
        )
        for matrix, shape in shapes:
            if matrix.shape != shape:
                raise ValueError(f"Kalman matrix of shape {matrix.shape}, expected {shape}")
        return self


class KalmanState(NamedTuple):
    state: torch.Tensor  # (n,) corrected estimate
    next_state: torch.Tensor  # (n,) one-step prediction
    covariance: torch.Tensor  # (n, n)


# (id(spec), field, dtype, device) -> (spec, tensor): each spec matrix is
# copied to a device once, so an update makes no host-to-device copy (a
# captured one could not). The spec is held with its tensor, so its id stays
# its own.
_matrices: dict = {}


def _matrix(spec: KalmanSpec, field: str, like: torch.Tensor) -> torch.Tensor:
    key = (id(spec), field, like.dtype, like.device)
    if key not in _matrices:
        _matrices[key] = (spec, torch.as_tensor(getattr(spec, field), dtype=like.dtype).to(like.device))
    return _matrices[key][1]


def kalman_init(spec: KalmanSpec, initial_state, initial_covariance) -> KalmanState:
    initial_state = torch.as_tensor(initial_state)
    F = _matrix(spec, "state_transition", initial_state)
    return KalmanState(
        state=initial_state,
        next_state=(F @ initial_state[..., None])[..., 0],
        covariance=torch.as_tensor(initial_covariance, dtype=initial_state.dtype).to(
            initial_state.device
        ),
    )


def kalman_update(spec: KalmanSpec, ks: KalmanState, observation) -> KalmanState:
    """Measurement update + one-step prediction (kalman.cpp:103-138)."""
    check_f32_matmuls("the Kalman filter")
    like = ks.state
    F = _matrix(spec, "state_transition", like)
    Q = _matrix(spec, "transition_covariance", like)
    H = _matrix(spec, "observation", like)
    R = _matrix(spec, "observation_covariance", like)
    observation = torch.as_tensor(observation, dtype=like.dtype).to(like.device)

    P = ks.covariance
    innovation_cov = H @ P @ H.T + R
    # solve_ex: no check of the factorisation on the host, so the update
    # never waits on the device (a singular S gives inf/NaN, as in JAX).
    gain = torch.linalg.solve_ex(innovation_cov.T, (P @ H.T).T)[0].T  # P H^T S^-1

    state = ks.next_state + gain @ (observation - H @ ks.next_state)
    eye = torch.eye(P.shape[-1], dtype=like.dtype, device=like.device)
    P = (eye - gain @ H) @ P
    next_state = F @ state
    P = F @ P @ F.T + Q
    return KalmanState(state=state, next_state=next_state, covariance=P)


def kalman_predict(
    spec: KalmanSpec, ks: KalmanState, update_covariance: bool = True
) -> KalmanState:
    """Process-only extrapolation (kalman.cpp:140-152)."""
    check_f32_matmuls("the Kalman filter")
    F = _matrix(spec, "state_transition", ks.state)
    Q = _matrix(spec, "transition_covariance", ks.state)
    state = ks.next_state
    next_state = F @ state
    covariance = F @ ks.covariance @ F.T + Q if update_covariance else ks.covariance
    return KalmanState(state=state, next_state=next_state, covariance=covariance)


def euler_state_transition_matrix(
    time_step: float, observed_states: int, order: int
) -> np.ndarray:
    """Constant-derivative Taylor-block transition matrix
    (KalmanForecast::create_euler_state_transition_matrix,
    forecast.cpp:212-275): block (i, i+j) = dt^j / j! on the diagonal of
    each observed-state group."""
    n = observed_states * (order + 1)
    matrix = np.zeros((n, n))
    for derivative in range(order + 1):
        for state in range(observed_states):
            row = derivative * observed_states + state
            for j in range(order - derivative + 1):
                col = (derivative + j) * observed_states + state
                matrix[row, col] = time_step**j / math.factorial(j)
    return matrix

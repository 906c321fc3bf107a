"""Carry state between the JAX package and the port, as numpy arrays.

This system has no learned weights: the robot tables and the planner state
play that role. ``model_from_numpy`` rebuilds a RobotModel from another
package's model fields; ``planner_state_from_numpy`` turns a JAX
``PlannerState`` (read out with ``np.asarray``) into the port's, and
``planner_state_to_numpy`` goes back the other way for comparisons;
``forecast_state_from_numpy`` / ``forecast_state_to_numpy`` do the same for
a Kalman forecast state.

Noise layouts: the JAX fused sampler keeps noise in its TPU lane layout
(G, S, 12, SUB, 128), where logical rollout r sits at
(g, a, b) = (r // (SUB*128), (r % (SUB*128)) // 128, r % 128)
(assistedmanipulation_tpu/kernels/pallas_rollout.py:686); its logical-layout
planners keep (R, S, 12). The port keeps (S, 12, R).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from . import resolve_device
from .forecast.forecast import KalmanForecastState
from .forecast.kalman import KalmanState
from .kernels.cuda_rollout import noise_from_logical, noise_to_logical
from .models.model_data import RobotModel
from .mppi import PlannerState


def _getter(arrays):
    return arrays.get if isinstance(arrays, dict) else lambda name: getattr(arrays, name)


def model_from_numpy(fields) -> RobotModel:
    """A RobotModel from a mapping or object with RobotModel's field names
    (e.g. the JAX package's RobotModel): arrays copied, frames rebuilt."""
    get = _getter(fields)
    values = {}
    for field in dataclasses.fields(RobotModel):
        value = get(field.name)
        if field.name in ("frames", "link_frames"):
            value = {
                name: (int(parent), np.array(R, dtype=np.float64), np.array(p, dtype=np.float64))
                for name, (parent, R, p) in value.items()
            }
        elif isinstance(value, np.ndarray) or hasattr(value, "__array__"):
            value = np.array(value)
        values[field.name] = value
    return RobotModel(**values)


def lane_noise_to_logical(noise: np.ndarray, rollouts: int) -> np.ndarray:
    """(G, S, 12, SUB, 128) lane layout -> (R, S, 12), padding dropped."""
    G, S, D, sub, lanes = noise.shape
    return noise.transpose(0, 3, 4, 1, 2).reshape(G * sub * lanes, S, D)[:rollouts]


def planner_state_from_numpy(arrays, rollouts: int, device="cuda", dtype=torch.float32) -> PlannerState:
    """The port's PlannerState from a JAX PlannerState given as numpy arrays
    (a mapping or an object with the same field names), on ``device`` (the
    card unless the caller asks for the CPU). ``noise`` may be in the lane
    layout (5-d) or logical (R, S, 12). ``rng`` is two uint32 key words (a
    JAX threefry key's data, or the port's own key), kept on the host as
    the port's key; other key data is folded into two words by SHA-256. The
    port's Philox cannot reproduce JAX's bits, so from a JAX key its stream
    differs (parity tests feed their own draws); from the port's own key it
    continues bitwise."""
    device = resolve_device(device)
    get = _getter(arrays)
    noise = np.asarray(get("noise"))
    if noise.ndim == 5:
        noise = lane_noise_to_logical(noise, rollouts)

    def tensor(value, kind=dtype):
        return torch.as_tensor(np.array(value)).to(device=device, dtype=kind)

    key_words = np.ascontiguousarray(np.asarray(get("rng")).astype(np.uint32).ravel())
    if key_words.size != 2:
        key_words = np.frombuffer(hashlib.sha256(key_words.tobytes()).digest()[:8], np.uint32)
    rng = torch.tensor(key_words.astype(np.int64))
    return PlannerState(
        optimal_control=tensor(get("optimal_control")),
        noise=noise_from_logical(tensor(noise)),
        costs=tensor(get("costs")),
        last_shift_time=tensor(get("last_shift_time")),
        last_update_time=tensor(get("last_update_time")),
        sg_buffer=tensor(get("sg_buffer")),
        sg_time=tensor(get("sg_time")),
        rng=rng,
        update_count=tensor(get("update_count"), torch.int32),
        optimal_cost=tensor(get("optimal_cost")),
        update_duration=tensor(get("update_duration")),
    )


def planner_state_to_numpy(state: PlannerState) -> dict:
    """The port's PlannerState as numpy arrays, noise in logical
    (R, S, 12) layout, the key as two uint32 words (what
    ``planner_state_from_numpy`` takes back)."""
    arrays = {
        name: value.detach().cpu().numpy()
        for name, value in state._asdict().items()
        if name not in ("rng", "noise")
    }
    arrays["noise"] = noise_to_logical(state.noise).detach().cpu().numpy()
    arrays["rng"] = state.rng.numpy().astype(np.uint32)
    return arrays


def forecast_state_from_numpy(arrays, device="cuda", dtype=None) -> KalmanForecastState:
    """The port's KalmanForecastState from a JAX one given as numpy arrays
    (a mapping or an object with the same field names, ``filter`` nested
    the same way), on ``device`` (the card unless the caller asks for the
    CPU). ``dtype`` None keeps each array's own."""
    device = resolve_device(device)
    get = _getter(arrays)
    get_filter = _getter(get("filter"))

    def tensor(value):
        value = torch.as_tensor(np.array(value))
        return value.to(device=device, dtype=dtype or value.dtype)

    return KalmanForecastState(
        filter=KalmanState(*(tensor(get_filter(name)) for name in KalmanState._fields)),
        measurement=tensor(get("measurement")),
        prediction=tensor(get("prediction")),
        last_update=tensor(get("last_update")),
    )


def forecast_state_to_numpy(state: KalmanForecastState) -> dict:
    """The port's KalmanForecastState as nested numpy arrays."""
    return {
        "filter": {name: value.detach().cpu().numpy() for name, value in state.filter._asdict().items()},
        "measurement": state.measurement.detach().cpu().numpy(),
        "prediction": state.prediction.detach().cpu().numpy(),
        "last_update": state.last_update.detach().cpu().numpy(),
    }

"""Carry state between the JAX package and the port, as numpy arrays.

This system has no learned weights: the robot tables and the planner state
play that role. ``model_from_numpy`` rebuilds a RobotModel from another
package's model fields; ``planner_state_from_numpy`` turns a JAX
``PlannerState`` (read out with ``np.asarray``) into the port's, and
``planner_state_to_numpy`` goes back the other way for comparisons;
``forecast_state_from_numpy`` / ``forecast_state_to_numpy`` do the same for
the state of a wrench forecast strategy (Kalman, average or LOCF),
``pid_state_from_numpy`` for a PID state, and ``episode_carry_from_numpy``
for a whole episode carry (plant state, planner state with its key,
forecast strategy state, both PID states, countdown), so that a test
starts both packages' episodes from the same numbers.

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
from .forecast.forecast import AverageState, KalmanForecastState, LOCFState
from .forecast.kalman import KalmanState
from .kernels.cuda_rollout import noise_from_logical, noise_to_logical
from .models.model_data import RobotModel
from .mppi import PlannerState
from .sim.episode import EpisodeCarry
from .sim.pid import PIDState


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


def lane_noise_to_logical(noise: np.ndarray, rollouts: int, shards: int = 1) -> np.ndarray:
    """(G, S, 12, SUB, 128) lane layout -> (R, S, 12), padding dropped. A
    sampler of ``shards`` rollout shards (the JAX ``sampler_shards``, or a
    mesh's rollout axis) tiles and pads each shard's R / shards rollouts on
    their own (pallas_rollout.py:763-767, :850-851): G is shards x the
    shard's tiles, and each shard's padding is dropped before the next
    shard's rollouts."""
    G, S, D, sub, lanes = noise.shape
    local = rollouts // shards
    blocks = noise.reshape(shards, G // shards, S, D, sub, lanes).transpose(0, 1, 4, 5, 2, 3)
    return blocks.reshape(shards, -1, S, D)[:, :local].reshape(rollouts, S, D)


def planner_state_from_numpy(arrays, rollouts: int, device="cuda", dtype=torch.float32,
                             shards: int = 1) -> PlannerState:
    """The port's PlannerState from a JAX PlannerState given as numpy arrays
    (a mapping or an object with the same field names), on ``device`` (the
    card unless the caller asks for the CPU). ``noise`` may be in the lane
    layout (5-d, of ``shards`` rollout shards) or logical (R, S, 12).
    ``rng`` is two uint32 key words (a
    JAX threefry key's data, or the port's own key), kept on the host as
    the port's key; other key data is folded into two words by SHA-256. The
    port's Philox cannot reproduce JAX's bits, so from a JAX key its stream
    differs (parity tests feed their own draws); from the port's own key it
    continues bitwise."""
    device = resolve_device(device)
    get = _getter(arrays)
    noise = np.asarray(get("noise"))
    if noise.ndim == 5:
        noise = lane_noise_to_logical(noise, rollouts, shards)

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


def _has(arrays, name: str) -> bool:
    return name in arrays if isinstance(arrays, dict) else hasattr(arrays, name)


def forecast_state_from_numpy(arrays, device="cuda", dtype=None):
    """The port's state of a wrench forecast strategy from a JAX one given
    as numpy arrays (a mapping or an object with the same field names), on
    ``device`` (the card unless the caller asks for the CPU). The strategy
    is told by the fields: ``filter`` (nested the same way) for a
    KalmanForecastState, ``buffer`` for an AverageState, ``observation``
    for a LOCFState. ``dtype`` None keeps each array's own; an integer
    array (the average's ring cursor) keeps its dtype either way."""
    device = resolve_device(device)
    get = _getter(arrays)

    def tensor(value):
        value = torch.as_tensor(np.array(value))
        kind = value.dtype if dtype is None or not value.is_floating_point() else dtype
        return value.to(device=device, dtype=kind)

    if _has(arrays, "filter"):
        get_filter = _getter(get("filter"))
        return KalmanForecastState(
            filter=KalmanState(*(tensor(get_filter(name)) for name in KalmanState._fields)),
            measurement=tensor(get("measurement")),
            prediction=tensor(get("prediction")),
            last_update=tensor(get("last_update")),
        )
    for kind in (AverageState, LOCFState):
        if _has(arrays, kind._fields[0]):
            return kind(*(tensor(get(name)) for name in kind._fields))
    raise ValueError("not a forecast strategy state: no filter, buffer or observation field")


def forecast_state_to_numpy(state) -> dict:
    """The port's forecast strategy state (Kalman, average or LOCF) as
    numpy arrays, a Kalman state's filter nested."""
    arrays = {}
    for name, value in state._asdict().items():
        if isinstance(value, KalmanState):
            arrays[name] = {field: v.detach().cpu().numpy() for field, v in value._asdict().items()}
        else:
            arrays[name] = value.detach().cpu().numpy()
    return arrays


def pid_state_from_numpy(arrays, device="cuda", dtype=None) -> PIDState:
    """The port's PIDState from a JAX one given as numpy arrays (a mapping
    or an object with the same field names), on ``device`` (the card unless
    the caller asks for the CPU). ``dtype`` None keeps each array's own;
    ``derivative_valid`` stays bool."""
    device = resolve_device(device)
    get = _getter(arrays)

    def tensor(name):
        value = torch.as_tensor(np.array(get(name)))
        kind = value.dtype if dtype is None or name == "derivative_valid" else dtype
        return value.to(device=device, dtype=kind)

    return PIDState(*(tensor(name) for name in PIDState._fields))


def episode_carry_from_numpy(carry, rollouts: int, device="cuda", dtype=torch.float32) -> EpisodeCarry:
    """The port's EpisodeCarry from a JAX episode carry, the 6-tuple of
    ``Episode.init_carry`` (plant state, PlannerState, the forecast
    strategy's state (Kalman, average or LOCF), force and torque PIDStates,
    countdown) with its arrays read out as numpy
    (``np.asarray``) or left as they are. ``rollouts``: the planner's rollout
    count with the two statics."""
    x, planner_state, strategy_state, pid_state, torque_state, countdown = carry
    device = resolve_device(device)
    return EpisodeCarry(
        x=torch.as_tensor(np.array(x)).to(device=device, dtype=dtype),
        planner_state=planner_state_from_numpy(planner_state, rollouts, device, dtype),
        strategy_state=forecast_state_from_numpy(strategy_state, device, dtype),
        pid_state=pid_state_from_numpy(pid_state, device, dtype),
        torque_state=pid_state_from_numpy(torque_state, device, dtype),
        countdown=int(np.asarray(countdown)),
    )

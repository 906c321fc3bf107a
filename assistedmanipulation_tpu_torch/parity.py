"""Reference-pipeline replayer: the BASELINE "control-seq max error" metric
(the port's own copy of assistedmanipulation_tpu/parity.py, plain float64
NumPy as there; the port imports nothing of the JAX package).

A standalone float64 NumPy reimplementation of the reference's
``mppi::Trajectory`` update pipeline, faithful to its idiosyncratic
semantics rather than to either package's engine:

- serial column-by-column Gaussian noise draws from one shared mt19937
  stream, in elite-sort-dependent order (mppi.cpp:250-261: kept rollouts
  redraw only their tail columns, resampled rollouts redraw all columns,
  both iterated in cost-sorted order, so every draw's destination depends
  on the previous update's sort);
- stable elite sort of sampled-rollout indices by previous cost
  (mppi.cpp:219-231) and kept-noise left-shift (mppi.cpp:242-253);
- the negated-previous-optimal static rollout (mppi.cpp:269);
- NaN cost poisoning and min/max-normalized softmax weighting with serial
  accumulation order (mppi.cpp:344-418);
- the MovingExtendedWindow Savitzky-Golay smoother with trim / add /
  extend / write-back-one-slot-behind semantics (filter.cpp:19-173,
  vendored gram_savitzky_golay weights), whose history buffer evolves
  across consecutive updates;
- truncating shift arithmetic ``(int)((time - last_shift) / dt)``
  (mppi.cpp:194) and the replicate-last optimal-control shift
  (mppi.cpp:204-206);
- the optimal re-rollout for the published cost (mppi.cpp:450-479) and
  linear-interpolation control queries (mppi.cpp:481-512).

Every sampled noise tensor is recorded per update so the port's planner can
be driven with the *same recorded noise* (``Planner.update(noise_override=)``),
making "control sequence matches the reference pipeline at the same horizon
and noise" a measured number (scripts/torch_parity_replay.py).

The mt19937 bit stream here is numpy's, not libstdc++'s `std::normal_
distribution` (implementation-defined), so parity is defined over the
recorded-noise replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


# --- Gram-polynomial Savitzky-Golay weights (gram_savitzky_golay.cpp) ------


def _gram_poly(i: int, m: int, k: int, s: int) -> float:
    if k > 0:
        return (4.0 * k - 2.0) / (k * (2.0 * m - k + 1.0)) * (
            i * _gram_poly(i, m, k - 1, s) + s * _gram_poly(i, m, k - 1, s - 1)
        ) - ((k - 1.0) * (2.0 * m + k)) / (
            k * (2.0 * m - k + 1.0)
        ) * _gram_poly(i, m, k - 2, s)
    return 1.0 if (k == 0 and s == 0) else 0.0


def _gen_fact(a: int, b: int) -> float:
    result = 1.0
    for j in range(a - b + 1, a + 1):
        result *= j
    return result


def _sg_weights(m: int, t: int, n: int, s: int) -> np.ndarray:
    """ComputeWeights (gram_savitzky_golay.cpp:46-53)."""
    weights = np.zeros(2 * m + 1)
    for i in range(-m, m + 1):
        w = 0.0
        for k in range(n + 1):
            w += (
                (2 * k + 1)
                * (_gen_fact(2 * m, k) / _gen_fact(2 * m + k + 1, k + 1))
                * _gram_poly(i, m, k, 0)
                * _gram_poly(t, m, k, s)
            )
        weights[i + m] = w
    return weights


class MovingExtendedWindow:
    """filter.cpp:19-116, verbatim semantics in Python."""

    def __init__(self, size: int, w: int):
        self.window = w
        self.last_trim_t = -1.0
        self.start_idx = w
        self.uu = [0.0] * (size + 2 * w + 1)
        self.tt = [-1.0] * (size + 2 * w + 1)

    def trim(self, t: float) -> None:
        if t < self.last_trim_t:
            raise RuntimeError("window reset back in the past")
        self.last_trim_t = t
        trim_idx = self.start_idx
        for i in range(self.start_idx):
            if self.tt[i] >= t:
                trim_idx = i
                break
        offset = trim_idx - self.window
        if offset < 0:
            # size_t underflow in the C++ (filter.cpp:57) — never reached in
            # practice because trim times are monotonic; guard explicitly.
            raise RuntimeError("trim before window start")
        if offset > 0:
            self.tt = self.tt[offset:] + self.tt[:offset]
            self.uu = self.uu[offset:] + self.uu[:offset]
            fill_t = self.tt[-offset - 1]
            fill_u = self.uu[-offset - 1]
            for i in range(len(self.tt) - offset, len(self.tt)):
                self.tt[i] = fill_t
                self.uu[i] = fill_u
        self.start_idx = self.window
        self.tt[self.start_idx] = t

    def add_point(self, u: float, t: float) -> None:
        if t < self.tt[self.start_idx]:
            raise RuntimeError("adding measurement older than new time")
        self.uu[self.start_idx] = u
        self.tt[self.start_idx] = t
        self._extend()
        self.start_idx += 1

    def _extend(self) -> None:
        for i in range(self.start_idx + 1, len(self.uu)):
            self.uu[i] = self.uu[self.start_idx]
            self.tt[i] = self.tt[self.start_idx]

    def _lower_bound(self, t: float) -> int:
        # std::lower_bound: first index whose time is NOT less than t.
        lo, hi = 0, len(self.tt)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.tt[mid] < t:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def extract(self, t: float) -> np.ndarray:
        idx = self._lower_bound(t)
        return np.asarray(
            self.uu[idx - self.window : idx + self.window + 1]
        )

    def set(self, u: float, t: float) -> None:
        idx = self._lower_bound(t) - 1
        self.uu[idx] = u


class SavitzkyGolayFilter:
    """filter.cpp:118-173: per-channel windows + Gram weights."""

    def __init__(self, steps: int, nu: int, window: int, order: int):
        self.weights = _sg_weights(window, 0, order, 0)
        self.windows = [MovingExtendedWindow(steps, window) for _ in range(nu)]

    def reset(self, t: float) -> None:
        for w in self.windows:
            w.trim(t)

    def add_measurement(self, u: np.ndarray, t: float) -> None:
        for i, w in enumerate(self.windows):
            w.add_point(float(u[i]), t)

    def apply(self, u: np.ndarray, t: float) -> np.ndarray:
        out = np.empty_like(u)
        for i, w in enumerate(self.windows):
            out[i] = float(self.weights @ w.extract(t))
            w.set(out[i], t)
        return out


# --- The trajectory replayer ------------------------------------------------


@dataclasses.dataclass
class ReplayerConfig:
    """mppi::Configuration subset (mppi.hpp:242-248) in float64."""

    rollouts: int
    keep_best_rollouts: int
    time_step: float
    horizon: float
    gradient_step: float
    cost_scale: float
    cost_discount_factor: float
    covariance: np.ndarray
    control_min: np.ndarray
    control_max: np.ndarray
    control_bound: bool = True
    smoothing_window: Optional[int] = 10
    smoothing_order: int = 1

    @property
    def step_count(self) -> int:
        return int(np.ceil(self.horizon / self.time_step))


STATIC_ROLLOUTS = 2


class ReferenceTrajectoryReplayer:
    """float64 replica of mppi::Trajectory (mppi.cpp:79-512).

    ``step_fn(state, control, dt) -> state`` and
    ``cost_fn(state, control, time) -> float`` stand in for the
    Dynamics/Cost subclasses; both must be pure float64 NumPy.
    """

    def __init__(
        self,
        config: ReplayerConfig,
        step_fn: Callable,
        cost_fn: Callable,
        seed: int = 0,
    ):
        cfg = config
        self.cfg = cfg
        self.step_fn = step_fn
        self.cost_fn = cost_fn
        self.steps = cfg.step_count
        self.dof = len(cfg.control_min)
        self.rollout_count = cfg.rollouts + STATIC_ROLLOUTS

        # Gaussian transform: eigvecs @ diag(sqrt(eigvals)) (gaussian.hpp:48-55).
        vals, vecs = np.linalg.eigh(np.asarray(cfg.covariance, np.float64))
        self.transform = vecs @ np.diag(np.sqrt(vals))
        self.rng = np.random.Generator(np.random.MT19937(seed))

        S, D, R = self.steps, self.dof, self.rollout_count
        self.noise = np.zeros((R, D, S))  # rollout.noise, (dof, steps) each
        self.costs = np.zeros(R)
        self.optimal_control = np.zeros((D, S))
        self.optimal_control_shifted = np.zeros((D, S))
        self.last_shift_time = 0.0
        self.last_rollout_time = 0.0
        self.rollout_time = 0.0
        self.rollout_state = None
        self.optimal_cost = 0.0
        if cfg.smoothing_window is not None:
            self.smoother = SavitzkyGolayFilter(
                S, D, cfg.smoothing_window, cfg.smoothing_order
            )
        else:
            self.smoother = None

    # gaussian.hpp:70-75 — one serial draw of dof standard normals.
    def _gaussian(self) -> np.ndarray:
        z = self.rng.standard_normal(self.dof)
        return self.transform @ z

    def update(self, state: np.ndarray, time: float) -> np.ndarray:
        """mppi.cpp:154-187. Returns the recorded sampled-noise tensor
        (rollouts, steps, dof) — what Planner.update(noise_override=)
        consumes."""
        self.rollout_state = np.asarray(state, np.float64).copy()
        self.rollout_time = float(time)
        self._sample(time)
        self._rollout()
        self._optimise()
        self._filter()
        self.last_rollout_time = self.rollout_time
        self.optimal_control = self.optimal_control_shifted.copy()
        return self.noise[STATIC_ROLLOUTS:].transpose(0, 2, 1).copy()

    def _sample(self, time: float) -> None:
        """mppi.cpp:189-270."""
        cfg = self.cfg
        S = self.steps
        shift_by = int((time - self.last_shift_time) / cfg.time_step)

        if shift_by > 0:
            self.last_shift_time = time
            shifted = S - shift_by
            new = np.empty_like(self.optimal_control_shifted)
            new[:, :shifted] = self.optimal_control[:, shift_by:]
            new[:, shifted:] = self.optimal_control[:, -1:]
            self.optimal_control_shifted = new

        # Stable sort of sampled indices by previous cost (mppi.cpp:222-231).
        ordered = sorted(
            range(STATIC_ROLLOUTS, self.rollout_count),
            key=lambda i: self.costs[i],
        )
        keep = ordered[: cfg.keep_best_rollouts]
        resample = ordered[cfg.keep_best_rollouts :]

        if shift_by > 0:
            shifted = S - shift_by
            for index in keep:
                noise = self.noise[index]
                noise[:, :shifted] = noise[:, shift_by:].copy()
                for i in range(shifted, S):
                    noise[:, i] = self._gaussian()

        for index in resample:
            noise = self.noise[index]
            for i in range(S):
                noise[:, i] = self._gaussian()

        # Static rollout 1: negated previous optimal (mppi.cpp:269).
        self.noise[1] = -self.optimal_control

    def _rollout(self) -> None:
        """mppi.cpp:309-342 (serially; thread partitioning is irrelevant to
        the values)."""
        cfg = self.cfg
        for r in range(self.rollout_count):
            state = self.rollout_state.copy()
            total = 0.0
            self.costs[r] = 0.0
            poisoned = False
            for step in range(self.steps):
                control = (
                    self.optimal_control_shifted[:, step]
                    + self.noise[r][:, step]
                )
                step_cost = cfg.cost_discount_factor**step * self.cost_fn(
                    state, control, self.rollout_time + step * cfg.time_step
                )
                if np.isnan(step_cost):
                    self.costs[r] = np.nan
                    poisoned = True
                    break
                total += step_cost
                state = self.step_fn(state, control, cfg.time_step)
            if not poisoned:
                self.costs[r] = total

    def _optimise(self) -> None:
        """mppi.cpp:344-448."""
        cfg = self.cfg
        valid = self.costs[~np.isnan(self.costs)]
        if valid.size == 0:
            raise RuntimeError("all nan rollouts")
        minimum = valid.min()
        maximum = valid.max()
        difference = maximum - minimum
        if difference < 1e-6:
            return

        weights = np.zeros(self.rollout_count)
        total = 0.0
        for i in range(self.rollout_count):
            cost = self.costs[i]
            if np.isnan(cost):
                continue
            likelihood = np.exp(-cfg.cost_scale * (cost - minimum) / difference)
            total += likelihood
            weights[i] = likelihood
        weights /= total

        gradient = self.noise[0] * weights[0]
        for i in range(1, self.rollout_count):
            gradient += self.noise[i] * weights[i]

        self.optimal_control_shifted = (
            self.optimal_control_shifted + gradient * cfg.gradient_step
        )

        if self.smoother is not None:
            self.smoother.reset(self.rollout_time)
            for i in range(self.steps):
                self.smoother.add_measurement(
                    self.optimal_control_shifted[:, i],
                    self.rollout_time + i * cfg.time_step,
                )
            for i in range(self.steps):
                self.optimal_control_shifted[:, i] = self.smoother.apply(
                    self.optimal_control_shifted[:, i],
                    self.rollout_time + i * cfg.time_step,
                )

        if cfg.control_bound:
            self.optimal_control_shifted = np.clip(
                self.optimal_control_shifted,
                cfg.control_min[:, None],
                cfg.control_max[:, None],
            )

    def _filter(self) -> None:
        """mppi.cpp:450-479 (no mppi::Filter attached, as in the reference's
        actual runs — actor.cpp:96-101 passes nullptr)."""
        cfg = self.cfg
        state = self.rollout_state.copy()
        total = 0.0
        for step in range(self.steps):
            control = self.optimal_control_shifted[:, step]
            total += cfg.cost_discount_factor**step * self.cost_fn(
                state, control, self.rollout_time + step * cfg.time_step
            )
            state = self.step_fn(state, control, cfg.time_step)
        self.optimal_cost = total

    def get(self, time: float) -> np.ndarray:
        """mppi.cpp:481-512 linear interpolation (control_default unset)."""
        t = (time - self.last_rollout_time) / self.cfg.time_step
        lower = int(t)
        upper = lower + 1
        if upper >= self.steps:
            return self.optimal_control[:, -1].copy()
        t -= lower
        return (
            (1.0 - t) * self.optimal_control[:, lower]
            + t * self.optimal_control[:, upper]
        )

"""The closed loop of one controller around ``Flagship.update``: the traffic
of every cell whose ``entry`` is ``update``.

A cycle issues one update at the plant state ``x0`` and the cycle's tick
time, then copies the control the robot applies (the first control of the
published sequence, which ``sim/actor.Actor`` reads through
``Planner.get`` at the update's own time) to the host; only then does the
next cycle start. The tick times advance by the traffic's ``tick_s`` and
are staged on the device before the window, so a cycle makes no
host-to-device copy of its own; each tick's forecast starts at its tick
time and holds the traffic's constant ``wrench`` over the horizon.

The mix's parameters (``portbench/traffic/<traffic>.json``): ``tick_s``,
``wrench`` (6 numbers, N and N m), ``max_rate_hz`` (the most cycles a
second the staged ticks cover).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import compare
from portbench.reference import update as reference
from portbench.reference.keys import update_words


def build_options(config: dict) -> dict:
    """``build_flagship`` keyword arguments of a configuration file: its
    sizes, and its ``flagship`` options as they stand."""
    mppi = config["mppi"]
    return {
        "rollouts": int(mppi["rollouts"]),
        "steps": int(round(mppi["horizon"] / mppi["time_step"])),
        "dtype": config["precision"],
        "optimal_rollout_mode": mppi["optimal_rollout_mode"],
        "safety": bool(config["safety_filter"]),
        "elite_select": mppi["elite_select"],
        **config.get("flagship", {}),
    }


class Loop:
    """The program under test, driven one closed-loop cycle at a time."""

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float, device, capture: bool):
        from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import ForecastContext
        from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship

        self.device = torch.device(device)
        self.flagship = build_flagship(device=self.device, capture=capture, **build_options(config))
        _check_configuration(self.flagship.planner.configuration, config)
        steps = self.flagship.planner.steps
        tick = float(traffic["tick_s"])
        count = int(seconds * float(traffic["max_rate_hz"])) + 1000
        # Tick k is at (k + 1) tick_s, in float32 as the planner reads it.
        self.times_host = (np.arange(1, count + 1, dtype=np.float64) * tick).astype(np.float32)
        self.times = torch.as_tensor(self.times_host, device=self.device)
        horizon = torch.as_tensor(np.tile(np.asarray(traffic["wrench"], np.float32), (steps + 1, 1)), device=self.device)
        self.context = lambda time: ForecastContext(horizon, time, tick, steps * tick)
        self.state = self.flagship.init(seed)
        self.k = 0

    @property
    def cycles_left(self) -> int:
        return len(self.times_host) - self.k

    def issue(self) -> None:
        """Issue the next update."""
        time = self.times[self.k]
        self.state, _ = self.flagship.update(self.state, self.flagship.x0, time, self.context(time))
        self.k += 1

    def read(self) -> np.ndarray:
        """The control of the last update, on the host."""
        return self.state.optimal_control[0].cpu().numpy()

    def cycle(self) -> np.ndarray:
        self.issue()
        return self.read()

    def snapshot(self) -> dict:
        """A host copy of the planner state as it stands (the last update's
        output, the next one's input), in the reference's field names; on
        the host, so that it adds nothing to the device's peak memory."""
        state = self.state
        out = {name: getattr(state, name).detach().to("cpu", copy=True) for name in (
            "optimal_control", "noise", "costs", "last_shift_time", "last_update_time", "sg_buffer", "sg_time",
            "update_count",
        )}
        out["key"] = tuple(int(word) & 0xFFFFFFFF for word in state.rng.tolist())
        return out

    def close(self) -> None:
        del self.flagship, self.state, self.context, self.times
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _check_configuration(built, config: dict) -> None:
    """Refuse a program whose planner departs from the configuration file."""
    mppi = config["mppi"]
    stated = {
        "keep_best_rollouts": mppi["keep_best_rollouts"], "time_step": mppi["time_step"],
        "horizon": mppi["horizon"], "gradient_step": mppi["gradient_step"], "cost_scale": mppi["cost_scale"],
        "cost_discount_factor": mppi["cost_discount_factor"], "covariance": mppi["covariance"],
        "control_min": mppi["control_min"], "control_max": mppi["control_max"],
        "elite_select": mppi["elite_select"], "optimal_rollout_mode": mppi["optimal_rollout_mode"],
        "smoothing": [mppi["smoothing"]["window"], mppi["smoothing"]["order"]],
    }
    for name, value in stated.items():
        have = getattr(built, name)
        if name == "smoothing":
            have = [have.window, have.order]
        if isinstance(value, str) or isinstance(have, str):
            same = have == value
        else:
            same = np.allclose(np.asarray(have, np.float64), np.asarray(value, np.float64), rtol=0, atol=0)
        if not same:
            raise ValueError(f"the program's planner has {name} = {have!r}, the configuration states {value!r}")


def _reference_updates(config: dict, traffic: dict, seed: int, samples: list, device, dtype):
    """For each sample ``(k, before, after)``: (setup, k, the program's state
    before update k on ``device``, the state the reference starts from, the
    program's state after, the reference's state after, the key into update
    k, the key out of it). Update 0 starts from the reference's own first
    state; every other update from the program's."""
    setup = reference.Setup.from_config(config, traffic)
    tick = float(traffic["tick_s"])
    chain = update_words(seed, max(k for k, _, _ in samples) + 2)
    for k, before, after in samples:
        before = {name: (value.to(device) if isinstance(value, torch.Tensor) else value) for name, value in before.items()}
        start = dict(reference.init_state(setup, device), key=before["key"]) if k == 0 else before
        expected = reference.update(setup, start, float(np.float32(np.float64(k + 1) * tick)), chain[k][1], dtype)
        yield setup, k, before, start, after, expected, chain[k][0], chain[k + 1][0]


def check(config: dict, traffic: dict, seed: int, samples: list, device, expected_out=None) -> list:
    """The compared numbers of each sample ``(k, before, after)``: update
    ``k``'s output ``after`` against the reference's update from the state
    ``before`` it (update 0: from the reference's own first state, the
    program's first state compared with it bit for bit). ``expected_out``
    collects each sample's (state before, reference's state after)."""
    readings = []
    for setup, k, before, start, after, expected, key_in, key_out in _reference_updates(
        config, traffic, seed, samples, device, torch.float64
    ):
        if expected_out is not None:
            expected_out.append((start, expected))
        reading = compare.numbers(setup, after, expected)
        if k == 0:
            reading["exact_mismatch"] += compare.exact_mismatch(
                before, start, compare.EXACT_FIELDS + ("optimal_control", "costs", "sg_buffer")
            )
        reading["exact_mismatch"] += int(before["key"] != key_in) + int(after["key"] != key_out)
        readings.append(reading)
    return readings


def control_samples(config: dict, traffic: dict, seed: int, samples: list, device, dtype=torch.bfloat16) -> list:
    """The samples with the control in the program's place: each update's
    output is the reference's, computed in ``dtype`` (bfloat16, the
    precision below the configuration's float32) from the same state."""
    return [
        (k, before, dict(expected, key=key_out))
        for _, k, before, _, _, expected, _, key_out in _reference_updates(config, traffic, seed, samples, device, dtype)
    ]

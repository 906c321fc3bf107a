"""The closed loop of one controller around the Kalman-driven serving tick
(``parallel/flagship.make_serving_tick``): the traffic of every cell whose
``entry`` is ``serving_tick``.

A cycle measures the operator's push, runs one tick on it (the forecast
update, the posterior scenario draws, the planner update against the
ensemble, one CUDA graph when captured) at the flagship's plant state
``x0``, then copies the control the robot applies (the first of the
published sequence) to the host; only then does the next cycle start.

The push of tick k, at (k + 1) ``tick_s``, is ``wrench`` plus a sway of
``sway_n`` x sin(2 pi ``sway_hz`` t) in y, with N(0, ``noise_variance``)
noise on each force component, drawn from ``--seed``. Every measurement
is made before the window, in pinned host memory, so a cycle copies only
its own 6 numbers to the card; the tick times are float32 numbers staged
beside them, which a captured tick fills into its time buffer. The mix's
parameters (``portbench/traffic/<traffic>.json``): ``tick_s``, ``wrench``
(the push's steady part, 6 numbers, N and N m), ``sway_n``, ``sway_hz``,
``noise_variance`` (N^2), ``max_rate_hz`` (the most cycles a second the
staged ticks cover).

``portbench/calibrate.py`` drives one loop through many seeds: it gives the
loop a new planner state and sets ``k`` to 0. The loop then restarts the
forecast, the scenario generator and the traffic of that state's seed
(the planner's first key holds the seed's two words).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import compare
from portbench.reference import forecast as forecast_reference
from portbench.reference import tick as reference
from portbench.reference import update as planner_reference
from portbench.reference.keys import update_words
from portbench.traffic.update import _check_configuration, build_options

# The scenario generator's seed is --seed under this mask, so that it never
# shares the planner key's words.
SCENARIO_SEED_XOR = 0x5CE7A210


def scenario_seed(seed: int) -> int:
    return (seed ^ SCENARIO_SEED_XOR) & (2**63 - 1)


def ticks(traffic: dict, seed: int, count: int):
    """(times (count,), pushes (count, 6)), float32: tick k at (k + 1)
    ``tick_s`` and the push measured there."""
    times = np.arange(1, count + 1, dtype=np.float64) * float(traffic["tick_s"])
    noise = np.random.default_rng([seed & (2**64 - 1), 22]).normal(
        0.0, np.sqrt(float(traffic["noise_variance"])), (count, 3)
    )
    pushes = np.tile(np.asarray(traffic["wrench"], np.float64), (count, 1))
    pushes[:, 1] += float(traffic["sway_n"]) * np.sin(2.0 * np.pi * float(traffic["sway_hz"]) * times)
    pushes[:, :3] += noise
    return times.astype(np.float32), pushes.astype(np.float32)


def forecast_options(config: dict) -> dict:
    """``KalmanForecastConfiguration`` keyword arguments of a configuration
    file's ``forecast`` block."""
    f = config["forecast"]
    if f["type"] != "kalman":
        raise ValueError(f"the serving tick forecasts by a Kalman filter here, not {f['type']!r}")
    names = ("observed_states", "order", "time_step", "horizon", "observation_variance", "transition_variance")
    return {name: f[name] for name in names}


class Loop:
    """The program under test, driven one closed-loop cycle at a time."""

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float, device, capture: bool):
        from assistedmanipulation_tpu_torch.forecast.forecast import KalmanForecast, KalmanForecastConfiguration
        from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship, make_serving_tick

        self.device = torch.device(device)
        # The tick captures itself: the flagship's own update stays eager.
        self.flagship = build_flagship(device=self.device, **build_options(config))
        _check_configuration(self.flagship.planner.configuration, config)
        self.forecast = KalmanForecast(KalmanForecastConfiguration(**forecast_options(config)))
        self.generator = torch.Generator(device=self.device)
        self.capture = capture
        self.tick = make_serving_tick(
            self.flagship, self.forecast, int(config["flagship"]["scenarios"]), self.generator, capture=capture
        )
        self.traffic = traffic
        self.count = int(seconds * float(traffic["max_rate_hz"])) + 1000
        on_card = self.device.type == "cuda"
        self.pushes = torch.empty((self.count, 6), dtype=torch.float32, pin_memory=on_card)
        self.control = torch.empty(12, dtype=torch.float32, pin_memory=on_card)
        self.x = self.flagship.x0
        self.state = self.flagship.init(seed)
        self._k = 0
        self._start(seed)

    def _start(self, seed: int) -> None:
        """The first tick's forecast state, scenario generator and traffic
        of ``seed``: the measurements staged in pinned memory, the tick
        times as Python floats (each a float32 value)."""
        times, pushes = ticks(self.traffic, seed, self.count)
        self.times = times.tolist()
        self.pushes.copy_(torch.from_numpy(pushes))
        self.generator.manual_seed(scenario_seed(seed))
        self.forecast_state = self.forecast.init(device=self.device)
        self.horizons = None

    @property
    def k(self) -> int:
        """The next tick's index."""
        return self._k

    @k.setter
    def k(self, value: int) -> None:
        if value == 0:  # a restart: from the seed of the planner state given
            words = [int(word) & 0xFFFFFFFF for word in self.state.rng.tolist()]
            self._start((words[0] << 32) | words[1])
        self._k = value

    @property
    def cycles_left(self) -> int:
        return len(self.times) - self.k

    def issue(self) -> None:
        """Issue the next tick."""
        k = self.k
        self.forecast_state, self.state, _, self.horizons = self.tick(
            self.forecast_state, self.state, self.x, self.pushes[k], self.times[k]
        )
        if k == 0 and self.capture:
            # A tick that exposes its own input buffer takes it back without
            # a copy; the plant state is held fixed.
            self.x = getattr(self.tick.captured, "x", self.x)
        self._k += 1

    def read(self) -> np.ndarray:
        """The control of the last tick, on the host."""
        self.control.copy_(self.state.optimal_control[0], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.control.numpy().copy()

    def cycle(self) -> np.ndarray:
        self.issue()
        return self.read()

    def snapshot(self) -> dict:
        """Host copies of the tick's state as it stands (the last tick's
        output, the next one's input), in the reference's field names."""
        state, f = self.state, self.forecast_state
        out = {name: getattr(state, name).detach().to("cpu", copy=True) for name in reference.PLANNER_FIELDS}
        out["key"] = tuple(int(word) & 0xFFFFFFFF for word in state.rng.tolist())
        out["forecast"] = {
            "state": f.filter.state, "next_state": f.filter.next_state, "covariance": f.filter.covariance,
            "measurement": f.measurement, "prediction": f.prediction, "last_update": f.last_update,
        }
        out["forecast"] = {name: value.detach().to("cpu", copy=True) for name, value in out["forecast"].items()}
        out["scenario_rng"] = self.generator.get_state().clone()
        out["horizons"] = None if self.horizons is None else self.horizons.detach().to("cpu", copy=True)
        return out

    def close(self) -> None:
        del self.tick, self.flagship, self.state, self.forecast_state, self.horizons, self.x
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _to(value, device):
    """A snapshot's tensors on ``device``; a generator's state stays on the
    host, where ``set_state`` takes it."""
    if isinstance(value, dict):
        return {name: item if name == "scenario_rng" else _to(item, device) for name, item in value.items()}
    return value.to(device) if isinstance(value, torch.Tensor) else value


def _first_state(setup, seed: int, key, device) -> dict:
    """The tick's first state as the reference builds it."""
    generator = torch.Generator(device=device)
    generator.manual_seed(scenario_seed(seed))
    return dict(planner_reference.init_state(setup.planner, device), key=key,
                forecast=forecast_reference.init_state(setup.forecast, device),
                scenario_rng=generator.get_state())


def _reference_ticks(config: dict, traffic: dict, seed: int, samples: list, device, dtype):
    """For each sample ``(k, before, after)``: (setup, k, the program's
    state before tick k on ``device``, the state the reference starts
    from, the program's state after, the reference's state after, the key
    into tick k, the key out of it). Tick 0 starts from the reference's own
    first state; every other tick from the program's."""
    setup = reference.TickSetup.from_config(config)
    last = max(k for k, _, _ in samples)
    times, pushes = ticks(traffic, seed, last + 1)
    chain = update_words(seed, last + 2)
    for k, before, after in samples:
        before = _to(before, device)
        start = _first_state(setup, seed, before["key"], device) if k == 0 else before
        expected = reference.tick(setup, start, pushes[k], times[k], chain[k][1], dtype)
        yield setup, k, before, start, after, expected, chain[k][0], chain[k + 1][0]


def _exact(program: dict, expected: dict) -> int:
    """The tick's own elements that must agree bit for bit: the forecast's
    time and the scenario generator's state."""
    time = compare.exact_mismatch(program["forecast"], expected["forecast"], ("last_update",))
    return time + int(not torch.equal(program["scenario_rng"].cpu(), expected["scenario_rng"].cpu()))


def check(config: dict, traffic: dict, seed: int, samples: list, device, expected_out=None) -> list:
    """The compared numbers of each sample ``(k, before, after)``: tick
    ``k``'s output ``after`` against the reference's tick from the state
    ``before`` it (tick 0: from the reference's own first state, the
    program's first state compared with it bit for bit). The numbers of
    ``compare.numbers`` for the planner, and ``forecast_gap``: the widest
    gap between the program's 4 horizons and the reference's, in N.
    ``expected_out`` collects each sample's (state before, reference's
    state after)."""
    readings = []
    for setup, k, before, start, after, expected, key_in, key_out in _reference_ticks(
        config, traffic, seed, samples, device, torch.float64
    ):
        if expected_out is not None:
            expected_out.append((start, expected))
        reading = compare.numbers(setup.planner, after, expected)
        gap = (after["horizons"].double().to(expected["horizons"].device) - expected["horizons"].double()).abs().max()
        reading["forecast_gap"] = compare._finite(gap.item())
        if k == 0:
            reading["exact_mismatch"] += compare.exact_mismatch(
                before, start, compare.EXACT_FIELDS + ("optimal_control", "costs", "sg_buffer")
            )
            reading["exact_mismatch"] += compare.exact_mismatch(before["forecast"], start["forecast"],
                                                                tuple(start["forecast"]))
            reading["exact_mismatch"] += int(not torch.equal(before["scenario_rng"].cpu(),
                                                             start["scenario_rng"].cpu()))
        reading["exact_mismatch"] += _exact(after, expected)
        reading["exact_mismatch"] += int(before["key"] != key_in) + int(after["key"] != key_out)
        readings.append(reading)
    return readings


def control_samples(config: dict, traffic: dict, seed: int, samples: list, device, dtype=torch.bfloat16) -> list:
    """The samples with the control in the program's place: each tick's
    output is the reference's, computed in ``dtype`` (bfloat16, the
    precision below the configuration's float32) from the same state."""
    return [
        (k, before, dict(expected, key=key_out))
        for _, k, before, _, _, expected, _, key_out in _reference_ticks(config, traffic, seed, samples, device, dtype)
    ]

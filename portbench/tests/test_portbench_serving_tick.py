"""The serving tick's entry (``portbench/traffic/serving_tick.py``) and its
reference (``portbench/reference/tick.py``, ``forecast.py``) against the
port's plain CPU path at a tiny size (30 rollouts x 8 steps x 4
scenarios): a sound run passes, and the comparison that decides
``correct`` fails the lower-precision control and each fault planted
underneath a run: a wrong Kalman gain, a scenario dropped from the mean.
These tests skip the run's look for a card and drive the rest of it
(``harness.run`` on the CPU, the tick eager)."""

import copy
import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELL = "tick-10k-50-kalman4"
# What a sound float32 run of the plain CPU path reads at this size, with
# room: control_gap ~1.4e-5, cost_gap ~1e-6, forecast_gap ~7e-7 N.
CPU_LIMITS = {"control_gap": 1e-3, "cost_gap_p99": 1e-4, "cost_mismatch": 0.0, "exact_mismatch": 0,
              "forecast_gap": 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny():
    cell = harness.Cell(CELL)
    config = copy.deepcopy(cell.config)
    config["mppi"].update(rollouts=30, keep_best_rollouts=6, horizon=0.08)
    cell.workload = dict(cell.workload, warm_cycles=2, min_rate_hz=2, compared_updates=2)
    return cell, config


def run(seed=2147483659, seconds=4.0):
    cell, config = tiny()
    out = harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu", capture=False, config=config)
    assert len(out["compared"]) >= 2, out["compared"]
    return cell, out


def correct(out, limits):
    return harness.verdict(out["numbers"], limits, out["failed"])[0]


def test_the_reference_agrees_with_the_plain_cpu_tick():
    cell, out = run()
    numbers = out["numbers"]
    assert numbers["exact_mismatch"] == 0 and numbers["cost_mismatch"] == 0.0
    assert 0 < numbers["control_gap"] < 1e-4 and numbers["cost_gap_p99"] < 1e-5
    assert 0 < numbers["forecast_gap"] < 1e-5
    assert correct(out, CPU_LIMITS) and correct(out, cell.workload["limits"])
    assert out["failed"] == 0 and out["attempted"] >= 3


def test_the_control_fails():
    """The reference in bfloat16 put in the program's place."""
    cell, config = tiny()
    seed = 3000000077
    loop = cell.loop.Loop(config, cell.traffic, seed, 1.0, "cpu", False)
    samples = [(0, loop.snapshot(), None)]
    loop.cycle()
    samples[0] = (0, samples[0][1], loop.snapshot())
    for _ in range(3):
        loop.cycle()
    before = loop.snapshot()
    loop.cycle()
    samples.append((4, before, loop.snapshot()))
    control = cell.loop.control_samples(config, cell.traffic, seed, samples, "cpu")
    readings = cell.loop.check(config, cell.traffic, seed, control, "cpu")
    numbers = {key: max(r[key] for r in readings) for key in readings[0]}
    assert not harness.verdict(numbers, cell.workload["limits"], 0)[0]
    assert not harness.verdict(numbers, CPU_LIMITS, 0)[0]
    assert numbers["control_gap"] > 1e-3 and numbers["forecast_gap"] > 1e-3


def _wrong_kalman_gain(monkeypatch):
    from assistedmanipulation_tpu_torch.forecast import forecast

    original = forecast.kalman_update

    def kalman_update(spec, state, observation):
        # The gain of a filter that trusts its measurements a quarter as much.
        return original(dataclasses.replace(spec, observation_covariance=4.0 * spec.observation_covariance),
                        state, observation)

    monkeypatch.setattr(forecast, "kalman_update", kalman_update)


def _scenario_dropped(monkeypatch):
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    monkeypatch.setattr(cuda_rollout, "reduce_scenarios", lambda costs, weights=None: torch.mean(costs[:-1], dim=0))


@pytest.mark.parametrize("fault", [_wrong_kalman_gain, _scenario_dropped], ids=["wrong-kalman-gain", "scenario-dropped"])
def test_each_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    cell, out = run(seed=3000000101)
    assert not correct(out, CPU_LIMITS)
    assert not correct(out, cell.workload["limits"])

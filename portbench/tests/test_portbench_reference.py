"""The reference against the port's plain CPU path at a tiny size (30
rollouts x 8 steps), and the comparison that decides ``correct`` shown to
fail: the lower-precision control in the program's place, and each fault a
cell of this kind can have planted underneath a run. These tests skip the
run's look for a card and drive the rest of it (``harness.run`` on the CPU,
the update eager)."""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELLS = ("serve-10k-50", "safety-10k-50")
# What a sound float32 run of the plain CPU path reads at this size, with
# room: control_gap ~1.8e-5 and ~3.1e-5, cost_gap ~9e-7.
CPU_LIMITS = {"control_gap": 1e-3, "cost_gap_p99": 1e-4, "cost_mismatch": 0.0, "exact_mismatch": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(name):
    cell = harness.Cell(name)
    config = copy.deepcopy(cell.config)
    config["mppi"].update(rollouts=30, keep_best_rollouts=6, horizon=0.08)
    cell.workload = dict(cell.workload, warm_cycles=2, min_rate_hz=2, compared_updates=2)
    return cell, config


def run(name, seed=2147483659, seconds=4.0):
    cell, config = tiny(name)
    out = harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu", capture=False, config=config)
    assert len(out["compared"]) >= 2, out["compared"]
    return cell, out


def correct(cell, out, limits):
    return harness.verdict(out["numbers"], limits, out["failed"])[0]


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_plain_cpu_path(name):
    cell, out = run(name)
    numbers = out["numbers"]
    assert numbers["exact_mismatch"] == 0 and numbers["cost_mismatch"] == 0.0
    assert 0 < numbers["control_gap"] < 1e-4 and numbers["cost_gap_p99"] < 1e-5
    assert correct(cell, out, CPU_LIMITS)
    assert out["failed"] == 0 and out["attempted"] >= 3


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    """The reference in bfloat16 put in the program's place."""
    cell, config = tiny(name)
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
    readings = cell.loop.check(config, cell.traffic, seed, cell.loop.control_samples(config, cell.traffic, seed, samples, "cpu"), "cpu")
    numbers = {key: max(r[key] for r in readings) for key in readings[0]}
    assert not harness.verdict(numbers, cell.workload["limits"], 0)[0]
    assert not harness.verdict(numbers, CPU_LIMITS, 0)[0]
    assert numbers["control_gap"] > 1e-3


def _unchanged_state(monkeypatch):
    from assistedmanipulation_tpu_torch import mppi

    original = mppi.Planner.device_update

    def device_update(self, state, *args, **kwargs):
        return state, original(self, state, *args, **kwargs)[1]

    monkeypatch.setattr(mppi.Planner, "device_update", device_update)


def _half_the_batch(monkeypatch):
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout

    original = cuda_rollout.CudaSampler.sample_and_rollout

    def sample_and_rollout(self, *args, **kwargs):
        costs, noise, states = original(self, *args, **kwargs)
        costs = costs.clone()
        costs[costs.shape[0] // 2:] = float("nan")  # left out: the weights are taken over the rest
        return costs, noise, states

    monkeypatch.setattr(cuda_rollout.CudaSampler, "sample_and_rollout", sample_and_rollout)


def _altered_control(monkeypatch):
    from assistedmanipulation_tpu_torch import mppi

    original = mppi.Planner.device_update

    def device_update(self, *args, **kwargs):
        state, info = original(self, *args, **kwargs)
        published = state.optimal_control.clone()
        published[3, 5] += 1.0  # half a percent of the arm torque's range
        return state._replace(optimal_control=published), info

    monkeypatch.setattr(mppi.Planner, "device_update", device_update)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch, _altered_control],
                         ids=["state-unchanged", "half-the-batch", "altered-control"])
def test_each_fault_fails(fault, monkeypatch):
    """The exchange between chips is the fourth fault of the contract; these
    cells run on one chip and have none."""
    fault(monkeypatch)
    cell, out = run("serve-10k-50", seed=3000000101)
    assert not correct(cell, out, CPU_LIMITS)
    assert not correct(cell, out, cell.workload["limits"])

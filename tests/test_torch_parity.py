"""The port's reference-pipeline replayer and replays (assistedmanipulation_
tpu_torch/parity.py, scripts/torch_parity_replay.py), on the CPU.

- The port's replayer is the JAX package's: both driven by the same float64
  numpy point mass (scripts/parity_replay.numpy_plant) from seed 7 over 8
  closed-loop updates record the same noise, costs and published controls,
  bitwise.
- ``run`` (the point mass, 12 updates x 30 rollouts) and ``run_franka``
  (6 updates x 24 rollouts, barrier saturation and NaN poisoning live)
  with the port's planner on the CPU, under the bounds of
  tests/test_reference_replay.py: float64 below 1e-9 (point mass) and
  2e-6 (Franka: the reference rounds its serial float64 sum at
  ulp(V * 1e10)); float32 below 0.03 with the first update below 1e-4
  (point mass), below 0.16 with the first update below 1e-3 (Franka).
"""

import os
import sys

import numpy as np
import pytest
import torch

from assistedmanipulation_tpu import parity as jax_parity
from assistedmanipulation_tpu_torch import parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.parity_replay as jax_replay  # noqa: E402
import scripts.torch_parity_replay as replay  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def test_replayer_matches_jax_bitwise():
    step_fn, cost_fn = jax_replay.numpy_plant()

    def configuration(module):
        return module.ReplayerConfig(
            rollouts=30, keep_best_rollouts=10, time_step=0.01, horizon=0.3, gradient_step=2.0, cost_scale=10.0,
            cost_discount_factor=1.0, covariance=jax_replay.COVARIANCE, control_min=-np.ones(2),
            control_max=np.ones(2), smoothing_window=10, smoothing_order=1,
        )

    port = parity.ReferenceTrajectoryReplayer(configuration(parity), step_fn, cost_fn, seed=7)
    want = jax_parity.ReferenceTrajectoryReplayer(configuration(jax_parity), step_fn, cost_fn, seed=7)
    x = np.zeros(4)
    for k in range(8):
        t = k * 0.05
        np.testing.assert_array_equal(port.update(x, t), want.update(x, t))
        for name in ("costs", "optimal_control", "noise"):
            np.testing.assert_array_equal(getattr(port, name), getattr(want, name), err_msg=name)
        assert port.optimal_cost == want.optimal_cost
        for j in range(10):
            u = port.get(t + j * 0.005)
            np.testing.assert_array_equal(u, want.get(t + j * 0.005))
            x = step_fn(x, u, 0.005)


@pytest.fixture(scope="module")
def point_recording():
    return replay.record_point_mass(12, 30)


@pytest.fixture(scope="module")
def franka_recording():
    return replay.record_franka(6, 24)


def test_point_mass_replay_float64(point_recording):
    result = replay.run(12, 30, "float64", "cpu", point_recording)
    assert result["control_seq_max_error"] < 1e-9, result
    assert all(e < 1e-9 for e in result["per_update_max_error"]), result


def test_point_mass_replay_float32(point_recording):
    result = replay.run(12, 30, "float32", "cpu", point_recording)
    series = result["per_update_max_error"]
    assert result["control_seq_max_error"] < 0.03, result
    assert series[0] < 1e-4, series
    assert all(e < 0.03 for e in series), series


def test_franka_replay_float64_with_saturation_and_poisoning(franka_recording):
    result = replay.run_franka(6, 24, "float64", "cpu", franka_recording)
    assert result["nan_poisoned_rollouts"] > 0, result
    assert result["saturated_rollouts"] > 0, result
    assert result["control_seq_max_error"] < 2e-6, result


def test_franka_replay_float32(franka_recording):
    result = replay.run_franka(6, 24, "float32", "cpu", franka_recording)
    series = result["per_update_max_error"]
    assert series[0] < 1e-3, result
    assert result["control_seq_max_error"] < 0.16, result
    assert all(e < 0.16 for e in series), series


def test_script_prints_its_json(tmp_path, capsys):
    out = tmp_path / "replay.json"
    assert replay.main(["--device", "cpu", "--updates", "2", "--rollouts", "6", "--franka-updates", "1",
                        "--franka-rollouts", "4", "--out", str(out)]) == 0
    import json

    result = json.loads(out.read_text())
    assert result["float64"]["updates"] == 2 and result["franka"]["float32"]["rollouts"] == 6
    assert result["float64"]["control_seq_max_error"] < 1e-9

"""scripts/torch_pose_diagnosis.py on the CPU: the draws gate passes on the
planner's own per-update draws (distinct seed words, successive updates
uncorrelated within 5 sigma; the graph replay is a card check), and the
first tick's operations from the same inputs on one device differ by
nothing. The card runs are in chip_smoke.py phase 17 and the script's own
runs on the card."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.torch_pose_diagnosis as diagnosis  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def test_draws_gate_on_the_cpu():
    report = diagnosis.draws_part(torch.device("cpu"), 40)
    assert report["ok"] and report["distinct_seed_words"] == 40
    assert report["replayed_bitwise_eager"] is None  # no graph on the CPU
    assert report["successive_correlation_max_abs"] < report["gate"]


def test_first_tick_operations_on_one_device_agree():
    noise = diagnosis.injected_noise(0.05, 0)
    assert noise.shape == (1, 50, 30, 12)
    operations = diagnosis.first_tick_operations(torch.device("cpu"), noise)
    assert [name for name, _ in operations][0] == "derive_aux"
    assert all(difference == 0.0 for _, difference in operations)


def test_cuda_is_asked_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diagnosis.main(["--out", str(tmp_path)])


def test_same_draws_at_float64_on_the_cpu(tmp_path):
    """The same_draws part at float64 (the planner and the episode), its CPU
    run in the child process: on one device the traces never part, and the
    first tick's operations agree exactly."""
    noise = diagnosis.injected_noise(0.05, 1, torch.float64)
    assert noise.dtype == torch.float64 and noise.shape == (1, 50, 30, 12)
    child, path = diagnosis.start_cpu_same_draws(0.05, 1, str(tmp_path), torch.float64)
    report = diagnosis.same_draws_part(0.05, torch.device("cpu"), 1, child, path, torch.float64)
    assert report["dtype"] == "float64" and report["ticks"] == 10
    assert report["force_difference"] == 0.0 and report["ee_distance_max"] == 0.0
    assert all(tick is None for tick in report["first_tick_past"].values())
    assert all(difference == 0.0 for _, difference in report["first_tick_operations"])

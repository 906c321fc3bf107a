"""The port's harness checkpoint/resume, on the CPU: the three cases of
tests/test_resume.py for the port (assistedmanipulation_tpu_torch/
harness/cases.py, checkpoint.py).

- A host-engine circle run (0.2 s, 40 ticks, 4 updates) stopped past a
  checkpoint at tick 20 and resumed finishes
  with a CSV tree byte-equal to an uninterrupted run's, apart from
  mppi/update.csv (host-measured update durations), at float64; a CSV made
  after the snapshot is deleted by the resume (the JAX harness leaves it,
  harness/cases.py:351-355 of the JAX package).
- Resume without a checkpoint fails.
- ``checkpoint_interval > 0`` writes snapshots during ``run`` itself, at
  the harness's float32.
"""

import json
import os

import torch

from assistedmanipulation_tpu_torch import config as cfg
from assistedmanipulation_tpu_torch.checkpoint import load_metadata
from assistedmanipulation_tpu_torch.harness import cases
from assistedmanipulation_tpu_torch.harness.runner import TestSuite
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def _patch():
    return {
        "duration": 0.2,
        "engine": "host",
        "actor": {
            "mppi": {"rollouts": 8, "keep_best_rollouts": 3, "horizon": 0.1},
            "controller_rate": 0.05,
        },
    }


def _csv_tree(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if not name.endswith(".csv"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, folder)
            if rel == os.path.join("mppi", "update.csv"):
                continue  # host wall-clock durations differ by run
            with open(path, "rb") as handle:
                out[rel] = handle.read()
    return out


def test_resume_continues_bit_exactly(tmp_path):
    patch, f64 = _patch(), torch.float64
    patch["actor"]["mppi"]["dtype"] = "float64"  # the planner too, with the actor's plant

    # Reference: one uninterrupted run.
    full = tmp_path / "full"
    os.makedirs(full)
    reference = cases.CircleTest(str(full), patch=patch, device="cpu", dtype=f64)
    for _ in range(40):
        reference.step()
    reference.flush_loggers()
    reference.close()

    # Interrupted: 20 ticks, checkpoint, then 5 more ticks of progress (an
    # update among them) that the "crash" loses (flushed to disk so
    # truncation is tested) and a CSV made after the snapshot.
    run = tmp_path / "run"
    os.makedirs(run)
    interrupted = cases.CircleTest(str(run), patch=patch, device="cpu", dtype=f64)
    with open(os.path.join(run, "configuration.json"), "w") as handle:
        json.dump(cfg.to_json(interrupted.configuration), handle, indent=2)
    for _ in range(20):
        interrupted.step()
    interrupted.write_checkpoint(20)
    for _ in range(5):
        interrupted.step()
    interrupted.flush_loggers()
    stale = os.path.join(run, "mppi", "after_the_snapshot.csv")
    with open(stale, "w") as handle:
        handle.write("time\n0.15\n")
    # Simulated kill: no close(); rows past the checkpoint are on disk and
    # must be truncated by resume.
    assert load_metadata(os.path.join(run, "checkpoint.npz"))["dtype"] == "float64"

    assert TestSuite.resume(str(run), device="cpu")
    assert not os.path.exists(stale)

    got = _csv_tree(str(run))
    expected = _csv_tree(str(full))
    assert sorted(got) == sorted(expected)
    for rel in sorted(expected):
        assert got[rel] == expected[rel], f"{rel} differs after resume"


def test_resume_requires_checkpoint(tmp_path):
    assert TestSuite.resume(str(tmp_path), device="cpu") is False


def test_checkpoint_interval_writes_snapshots(tmp_path):
    """checkpoint_interval > 0 snapshots during run() itself."""
    patch = _patch()
    patch["duration"] = 0.12
    patch["checkpoint_interval"] = 0.05
    assert TestSuite.run("circle", str(tmp_path), patch=patch, device="cpu")
    (run_folder,) = [entry.path for entry in os.scandir(tmp_path)]
    path = os.path.join(run_folder, "checkpoint.npz")
    assert os.path.exists(path)
    metadata = load_metadata(path)
    assert metadata["test"] == "circle"
    assert metadata["tick"] >= 20  # the last snapshot (t >= 0.10)
    assert metadata["dtype"] == "float32"
    assert metadata["file_sizes"]

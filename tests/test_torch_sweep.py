"""The port's parameter sweep (assistedmanipulation_tpu_torch/harness/
sweep.py) against the JAX package's, on the CPU.

- ``pointer_to_patch`` and ``parameter_values`` give the JAX functions'
  results on the same pointers and ranges.
- ``parameter_sweep`` over ``reach`` (two values of
  ``/actor/mppi/cost_scale``, the host engine, 20 ticks each at small
  widths) in both packages: the same subfolders, the same
  ``parameters.json`` in each, the same CSV files with the same headers and
  row counts in each, and the same ``sweep.csv`` apart from its wall-time
  column; every combination passed. The values inside the runs' CSVs
  differ (each package draws its own noise: tests/test_torch_harness.py
  holds the harness's values to the JAX package's under injected noise).
"""

import csv
import json
import os

import pytest

from assistedmanipulation_tpu.harness.runner import TestSuite as JaxSuite
from assistedmanipulation_tpu.harness.sweep import parameter_values as jax_parameter_values
from assistedmanipulation_tpu.harness.sweep import pointer_to_patch as jax_pointer_to_patch
from assistedmanipulation_tpu_torch.harness.runner import TestSuite
from assistedmanipulation_tpu_torch.harness.sweep import parameter_values, pointer_to_patch

# The swept parameter, then the inner runs' engine and small widths as
# parameters of one value each, so both packages' sweeps patch them alike.
PARAMETERS = [
    {"pointer": "/actor/mppi/cost_scale", "values": [5.0, 10.0]},
    {"pointer": "/engine", "values": ["host"]},
    {"pointer": "/actor/mppi/rollouts", "values": [8]},
    {"pointer": "/actor/mppi/keep_best_rollouts", "values": [3]},
    {"pointer": "/actor/mppi/horizon", "values": [0.05]},
]


@pytest.mark.parametrize("pointer", ["/actor/mppi/cost_scale", "/a~1b/c~0d", "/x"])
def test_pointer_to_patch_matches_jax(pointer):
    assert pointer_to_patch(pointer, 5.0) == jax_pointer_to_patch(pointer, 5.0)


@pytest.mark.parametrize(
    "parameter", [{"minimum": 1.0, "maximum": 2.0, "step": 0.5}, {"minimum": 0.1, "maximum": 0.3, "step": 0.1},
                  {"values": [3, 7]}]
)
def test_parameter_values_match_jax(parameter):
    assert parameter_values(parameter) == jax_parameter_values(parameter)


def _sweep(suite, out, **kwargs):
    """Run the reach sweep, 0.1 s per combination; its run folder."""
    patch = {"test": "reach", "duration": 0.1, "parameters": json.loads(json.dumps(PARAMETERS))}
    assert suite.run("parameter_sweep", str(out), patch=patch, **kwargs)
    (folder,) = [entry.path for entry in os.scandir(out)]
    return folder


def _layout(folder):
    """{relative path: (header, row count)} of every CSV, and each
    combination's parameters.json."""
    files, parameters = {}, {}
    for dirpath, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, folder)
            if name.endswith(".csv"):
                with open(path) as handle:
                    lines = [line for line in handle.read().splitlines() if line]
                files[rel] = (lines[0], len(lines) - 1)
            elif name == "parameters.json":
                with open(path) as handle:
                    parameters[rel] = json.load(handle)
    return files, parameters


def _summary(folder):
    with open(os.path.join(folder, "sweep.csv")) as handle:
        rows = list(csv.DictReader(handle))
    for row in rows:
        assert float(row.pop("wall_time")) > 0.0
    return rows


def test_reach_sweep_matches_jax(tmp_path):
    want = _sweep(JaxSuite, tmp_path / "jax")
    got = _sweep(TestSuite, tmp_path / "port", device="cpu")
    assert _layout(got) == _layout(want)
    rows = _summary(got)
    assert rows == _summary(want)
    assert [row["passed"] for row in rows] == ["1", "1"]
    assert [float(row["actor.mppi.cost_scale"]) for row in rows] == [5.0, 10.0]
    assert sorted(entry.name for entry in os.scandir(got) if entry.is_dir()) == ["combo_000", "combo_001"]

"""The port's experiment harness against the JAX package's, on the CPU.

- The CLI lists the JAX registry's cases, ``parameter_sweep`` included;
  the sweep, ``checkpoint_interval > 0`` and ``--resume`` run (their
  results are held to the JAX package's in tests/test_torch_sweep.py and
  tests/test_torch_resume.py); without ``--device cpu`` the CLI asks for
  CUDA and, where there is none, raises: nothing falls back.
- The circle case under the host engine, float32 (the harness's dtype):
  both packages' cases are built directly and both actors'
  ``planner.update`` wrapped to pass the same sampled noise
  (``noise_override``); every CSV of the tree within
  |port - jax| <= tol * max(|jax|, 1), the host-measured update durations
  (mppi/update.csv's last column) excepted. tol is 1e-4, except 5e-3 for
  the end-effector accelerations and the forecast tree: in float32 the
  Kalman forecast's finite differences (divided by the 5 ms tick) and the
  accelerations' stiff solve (friction damping up to 1e4 at rest) amplify
  rounding, and the two packages round differently. Measured at this size:
  2.2e-4 (dynamics accelerations) and 1.3e-3 (forecast accelerations;
  forecast wrench 9.3e-4); every other file within 4.2e-5.
- The episode engine for circle, base, reach, slerp (torque on) and
  lagrangian at the sizes of tests/test_harness_episode.py: the same files
  and headers as the JAX harness's tree for the case, and the row counts
  the JAX harness writes (its circle episode run at the same size shows
  them: one row per tick, per update, per update and horizon step).
  The JAX trees of the other cases are their loggers' files as the JAX
  case writes them at construction (each logger writes its header there);
  lagrangian's is circle's (the same case on another plant backend).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from assistedmanipulation_tpu.harness import cases as jax_cases
from assistedmanipulation_tpu.harness.runner import TestSuite as JaxSuite
from assistedmanipulation_tpu_torch.checkpoint import load_metadata
from assistedmanipulation_tpu_torch.harness import cases, runner
from assistedmanipulation_tpu_torch.harness.runner import TestSuite
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
TOL_AMPLIFIED = 5e-3  # accelerations and the forecast tree (see above)
ROLLOUTS, KEEP, HORIZON = 12, 4, 0.1
HOST_DURATION = 0.1
EPISODE_CASES = {
    "circle": 0.1,
    "base": 0.1,
    "reach": 0.1,
    "slerp": 0.1,
    "lagrangian": 0.1,
}


def patch(duration, engine="episode", **extra):
    return {
        "duration": duration,
        "engine": engine,
        "actor": {
            "mppi": {"rollouts": ROLLOUTS, "keep_best_rollouts": KEEP, "horizon": HORIZON},
            "controller_rate": 0.05,
        },
        **extra,
    }


def case_patch(name, duration):
    return patch(duration, torque_enabled=True) if name == "slerp" else patch(duration)


def tree(folder):
    """{relative path: (header, rows as a float array)} of every CSV."""
    out = {}
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if not name.endswith(".csv"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as handle:
                header = handle.readline().strip()
                rows = [line for line in handle.read().splitlines() if line]
            data = np.array([[float(v) for v in row.split(",")] for row in rows]) if rows else np.zeros((0,))
            out[os.path.relpath(path, folder)] = (header, data)
    return out


def expected_rows(rel, ticks, updates, steps, forecast_steps, torque):
    """Rows the JAX harness's episode engine writes per file."""
    if rel.startswith("pid/torque"):
        return ticks if torque else 0
    if rel.startswith("forecast"):
        return updates * forecast_steps
    if rel in ("mppi/gradient.csv", "mppi/optimal_rollout.csv"):
        return updates * steps
    if rel.startswith("mppi") or rel.startswith("objective"):
        return updates
    return ticks


def run_case(suite_cases, name, folder, case_patch_, noise=None, **kwargs):
    """Build a case directly (so its planner can be wrapped), run, close."""
    os.makedirs(folder)
    test = suite_cases.__dict__[type_name(name)](folder=folder, patch=case_patch_, **kwargs)
    if noise is not None:
        planner = test.actor.planner
        update = planner.update

        def injected(state, x, time, ctx=None):
            return update(state, x, time, ctx, noise_override=noise[int(state.update_count)])

        planner.update = injected
    try:
        assert test.run()
    finally:
        test.close()
    return folder


def type_name(name):
    return {
        "circle": "CircleTest", "base": "BaseTest", "reach": "ReachTest", "slerp": "SlerpTest",
        "lagrangian": "LagrangianTest",
    }[name]


def host_noise():
    scale = np.sqrt(np.asarray(cases.ActorConfiguration().mppi.covariance))
    rng = np.random.default_rng(5)
    updates = int(np.ceil(HOST_DURATION / 0.05)) + 1
    steps = int(np.ceil(HORIZON / 0.01))
    return (rng.standard_normal((updates, ROLLOUTS, steps, 12)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax")
    trees = {"host": tree(run_case(jax_cases, "circle", str(root / "host"), patch(HOST_DURATION, "host"),
                                   noise=host_noise()))}
    trees["circle"] = tree(run_case(jax_cases, "circle", str(root / "circle"), patch(EPISODE_CASES["circle"])))
    # lagrangian is the circle case on another plant backend: the same
    # loggers, so the same files and headers (its JAX construction alone
    # runs the autodiff backend op by op for ~13 s).
    trees["lagrangian"] = trees["circle"]
    for name in EPISODE_CASES:
        if name not in trees:
            folder = str(root / name)
            os.makedirs(folder)
            jax_cases.__dict__[type_name(name)](folder=folder, patch=case_patch(name, EPISODE_CASES[name])).close()
            trees[name] = tree(folder)
    return trees


def test_cli_lists_the_jax_registry_but_sweep():
    """The whole JAX registry, the sweep included (the name is kept from
    when the sweep was not ported)."""
    out = subprocess.run(
        [sys.executable, "-m", "assistedmanipulation_tpu_torch.harness", "-l"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert "parameter_sweep" in out
    assert out == JaxSuite.names()


def test_cli_needs_cuda_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main(["--test", "circle", "--out", str(tmp_path)])


def test_unported_parts_raise(tmp_path):
    """The three parts that raised before their port (the name is kept):
    the sweep, ``checkpoint_interval > 0`` and ``--resume`` now run, and
    the episode engine refuses to resume, as in the JAX harness."""
    sweep = {"test": "trajectory", "duration": 0.2, "parameters": [{"pointer": "/unused", "values": [0, 1]}]}
    assert TestSuite.run("parameter_sweep", str(tmp_path / "sweep"), sweep, device="cpu")
    # 15 ticks with a snapshot at tick 10: the resume runs ticks 10-14.
    out = tmp_path / "circle"
    assert TestSuite.run("circle", str(out), patch(0.075, "host", checkpoint_interval=0.05), device="cpu")
    (folder,) = [entry.path for entry in os.scandir(out)]
    assert load_metadata(os.path.join(folder, "checkpoint.npz"))["tick"] == 10
    assert runner.main(["--resume", folder, "--device", "cpu"]) == 0
    assert runner.main(["--resume", str(tmp_path), "--device", "cpu"]) == 1  # no checkpoint there
    with open(os.path.join(folder, "configuration.json")) as handle:
        configuration = json.load(handle)
    with open(os.path.join(folder, "configuration.json"), "w") as handle:
        json.dump({**configuration, "engine": "episode"}, handle)
    with pytest.raises(ValueError, match="resume requires the host engine"):
        TestSuite.resume(folder, device="cpu")


def test_host_engine_circle_matches_jax(jax_trees, tmp_path):
    port = tree(run_case(cases, "circle", str(tmp_path / "port"), patch(HOST_DURATION, "host"),
                         noise=torch.as_tensor(host_noise()), device="cpu"))
    want = jax_trees["host"]
    assert sorted(port) == sorted(want)
    for rel, (header, data) in want.items():
        got_header, got = port[rel]
        assert got_header == header, rel
        assert got.shape == data.shape, (rel, got.shape, data.shape)
        if rel == os.path.join("mppi", "update.csv"):
            got, data = got[:, :2], data[:, :2]  # the last column is host wall time
        amplified = rel.startswith("forecast") or rel.endswith("acceleration.csv")
        err = np.abs(got - data)
        bound = (TOL_AMPLIFIED if amplified else TOL) * np.maximum(np.abs(data), 1.0)
        assert (err <= bound).all(), (rel, float(err.max()))


@pytest.mark.parametrize("name", list(EPISODE_CASES))
def test_episode_engine_tree_matches_jax(jax_trees, tmp_path, name):
    duration = EPISODE_CASES[name]
    assert TestSuite.run(name, str(tmp_path), case_patch(name, duration), device="cpu")
    (folder,) = [entry.path for entry in os.scandir(tmp_path)]
    port, want = tree(folder), jax_trees[name]
    assert sorted(port) == sorted(want)
    ticks = int(round(duration / 0.005))
    counts = dict(ticks=ticks, updates=ticks // 10, steps=int(np.ceil(HORIZON / 0.01)),
                  forecast_steps=30, torque=name == "slerp")
    for rel, (header, data) in want.items():
        got_header, got = port[rel]
        assert got_header == header, rel
        rows = expected_rows(rel, **counts)
        if name == "circle":
            assert data.shape[0] == rows, rel  # the JAX run writes these counts
        assert got.shape[0] == rows, (rel, got.shape[0], rows)
        assert np.isfinite(got).all(), rel
    assert os.path.exists(os.path.join(folder, "configuration.json"))

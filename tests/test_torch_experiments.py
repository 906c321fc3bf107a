"""scripts/torch_experiments.py against scripts/experiments.py (the JAX
package's matrix script, imported by path).

- the trajectories of every row at a few times, the pose row's hold point
  (FK of the huddled state at float32), the planner's configuration and
  every column's wrench forecast, field by field;
- the median-of-seeds protocol: with ``run_cell`` replaced by the same
  fake metrics in both scripts, ``run_cell_seeds`` gives equal dicts;
- an end-to-end ``main`` on the CPU at EXP_DURATION=0.1, one seed, circle x
  {unassisted, kalman_1}: the payload has the JAX script's keys (plus the
  device's), every metric is finite, and EXP_RENDER_ONLY=1 re-renders the
  tables from it;
- EXP_ANIMATE's renders (``regenerate_animations``): one short episode per
  trajectory and the slerp case, a GIF each under --out/artifacts; without
  matplotlib it raises ImportError before any episode.

Tolerances: the trajectories at float64 within 1e-12; the hold point (FK
in float32 in both) within 1e-6 m.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.experiments as jax_ex  # noqa: E402
import scripts.torch_experiments as ex  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

TRAJECTORIES = ("pose", "circle", "figure_eight", "rectangle", "lissajous")
STRATEGIES = ("unassisted", "average", "locf", "kalman_1", "kalman_2")


@pytest.mark.parametrize("name", TRAJECTORIES)
def test_trajectory_matches_jax(name):
    tol = 1e-6 if name == "pose" else 1e-12
    port, jax_trajectory = ex.make_trajectory(name), jax_ex.make_trajectory(name)
    for t in (0.0, 0.37, 2.5, 7.9, 14.2):
        got = port.position(torch.tensor(t, dtype=torch.float64)).double().numpy()
        want = np.asarray(jax_trajectory.position(jnp.asarray(t, jnp.float64)), np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{name} at {t}")


def test_hold_point_configuration_and_strategies_match_jax():
    np.testing.assert_allclose(ex.initial_ee_position(), jax_ex.initial_ee_position(), rtol=0, atol=1e-6)
    port, want = ex.mppi_configuration(), jax_ex.mppi_configuration()
    # The JAX planner's key implementation and mesh axis name have no
    # counterpart in the port's Configuration.
    jax_only = {"rng_impl", "rollout_axis"}
    assert {f.name for f in dataclasses.fields(want)} - {f.name for f in dataclasses.fields(port)} == jax_only
    for field in dataclasses.fields(port):
        got, expected = getattr(port, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(expected):
            assert dataclasses.asdict(got) == dataclasses.asdict(expected), field.name
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(expected), err_msg=field.name)
    for name in STRATEGIES:
        port, want = ex.make_strategy(name), jax_ex.make_strategy(name)
        if want is None:
            assert port is None
            continue
        assert type(port).__name__ == type(want).__name__
        assert dataclasses.asdict(port.configuration) == dataclasses.asdict(want.configuration), name
    assert (ex.FORECAST_DT, ex.FORECAST_HORIZON, ex.REFERENCE) == (
        jax_ex.FORECAST_DT, jax_ex.FORECAST_HORIZON, jax_ex.REFERENCE)


def test_run_cell_seeds_matches_jax(monkeypatch):
    def fake_run_cell(trajectory_name, strategy_name, duration, seed, **_):
        rng = np.random.default_rng(hash((trajectory_name, strategy_name, seed)) % 2**32)
        force, rmse, peak, energy, wall = rng.uniform(0.5, 50.0, 5)
        return {"mean_force": force, "rmse": rmse / 100, "max_force": peak, "final_energy": energy,
                "wall_s": round(wall, 2)}

    monkeypatch.setattr(ex, "run_cell", fake_run_cell)
    monkeypatch.setattr(jax_ex, "run_cell", fake_run_cell)
    for seeds in ([0, 1, 2], [4], [3, 1]):
        for name in ("circle", "pose"):
            assert ex.run_cell_seeds(name, "kalman_1", 15.0, seeds, device="cpu") == jax_ex.run_cell_seeds(
                name, "kalman_1", 15.0, seeds)


def test_main_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("EXP_DURATION", "0.1")
    monkeypatch.setenv("EXP_SEEDS", "0")
    monkeypatch.setenv("EXP_TRAJECTORIES", "circle")
    monkeypatch.setenv("EXP_STRATEGIES", "unassisted,kalman_1")
    assert ex.main(["--device", "cpu", "--out", str(tmp_path)]) == 0
    payload = json.load(open(tmp_path / "torch_experiments.circle.json"))
    jax_payload = json.load(open(os.path.join(ROOT, "experiments.json")))
    assert set(payload) == set(jax_payload) | {"device", "power_limit"}
    assert payload["device"] == "cpu" and payload["seeds"] == [0] and payload["duration"] == 0.1
    cells = payload["results"]["circle"]
    assert list(cells) == ["unassisted", "kalman_1"]
    for cell in cells.values():
        assert set(cell) == set(jax_payload["results"]["circle"]["kalman_1"])
        assert np.isfinite([cell["mean_force"], cell["rmse"], cell["max_force"], cell["final_energy"]]).all()
    table = open(tmp_path / "TORCH_EXPERIMENTS.md").read()
    assert "| circle |" in table and "JAX 12.20" in table and "ref 12.59" in table
    monkeypatch.setenv("EXP_RENDER_ONLY", "1")
    os.remove(tmp_path / "TORCH_EXPERIMENTS.md")
    assert ex.main(["--out", str(tmp_path)]) == 0
    assert open(tmp_path / "TORCH_EXPERIMENTS.md").read() == table


def test_merge_and_departures(tmp_path):
    base = {"duration": 15.0, "seeds": [0, 1, 2], "pose_point": "p", "device": "card", "power_limit": "700.00 W"}
    cell = {"mean_force": 30.0, "rmse": 0.1, "force_range": [29.0, 31.0], "rmse_range": [0.09, 0.11]}
    for name, force in (("circle", 27.0), ("rectangle", 60.0)):
        with open(tmp_path / f"torch_experiments.{name}.json", "w") as handle:
            json.dump({**base, "results": {name: {"unassisted": {**cell, "mean_force": force}}}}, handle)
    merged = ex.merge_payloads(str(tmp_path))
    assert sorted(merged["results"]) == ["circle", "rectangle"] and merged["device"] == "card"
    found = ex.departures(merged["results"], {"circle": {"unassisted": cell}, "rectangle": {"unassisted": cell}})
    # 27.0 lies inside [29 - 4.5, 31 + 4.5]; 60.0 does not.
    assert [(t, s, metric) for t, s, metric, _, _ in found] == [("rectangle", "unassisted", "mean_force")]
    with open(tmp_path / "torch_experiments.json", "w") as handle:
        json.dump({**base, "seeds": [0], "results": {}}, handle)
    with pytest.raises(ValueError, match="duration and seeds"):
        ex.merge_payloads(str(tmp_path))


def test_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.main(["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.run_cell("circle", "kalman_1", 0.05, 0)


def test_regenerate_animations_on_the_cpu(tmp_path):
    """EXP_ANIMATE's renders: one short harness episode per trajectory and
    the slerp case, each drawn by the port's analysis.animate into
    --out/artifacts, nothing else written under --out."""
    written = ex.regenerate_animations(str(tmp_path), ["circle"], 0.05, "cpu")
    names = ["circle_scene.gif", "slerp_scene.gif"]
    assert written == [str(tmp_path / "artifacts" / name) for name in names]
    assert sorted(os.listdir(tmp_path)) == ["artifacts"] and sorted(os.listdir(tmp_path / "artifacts")) == names
    for path in written:
        with open(path, "rb") as handle:
            assert handle.read(6) in (b"GIF87a", b"GIF89a")


def test_animate_needs_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib EXP_ANIMATE raises ImportError before any episode
    runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("EXP_ANIMATE", "1")
    monkeypatch.setattr(ex, "run_cell_seeds", lambda *args, **kwargs: pytest.fail("an episode ran"))
    with pytest.raises(ImportError, match="matplotlib"):
        ex.main(["--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(ImportError, match="matplotlib"):
        ex.regenerate_animations(str(tmp_path), ["circle"], 0.05, "cpu")
    assert not os.listdir(tmp_path)

"""The port's run analysis (assistedmanipulation_tpu_torch/analysis.py)
against the JAX package's, on the CPU.

On the synthetic CSV tree of tests/test_analysis.py (40 ticks of a circle
run), with the optimal cost, update durations and tank energy added so
that every metric has a value:

- ``analyse_single(plot=False)`` and ``analyse_multiple(plot=False)``
  return the JAX package's dicts exactly, and ``analyse_multiple`` writes
  the same summary text files, byte for byte;
- without matplotlib the metrics still work, and a plot asked for raises
  an ImportError that says so;
- with matplotlib: the figure set of ``analyse_single``, ``animate``,
  ``watch`` over a finished tree, ``barchart`` and the CLI.
"""

import json
import os
import sys

import numpy as np
import pytest

from assistedmanipulation_tpu import analysis as jax_analysis
from assistedmanipulation_tpu_torch import analysis

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_analysis import _synthetic_run, _write_csv  # noqa: E402


def _run_tree(folder, seed):
    _synthetic_run(folder)
    rng = np.random.default_rng(seed)
    t = np.arange(40) * 0.005
    _write_csv(os.path.join(folder, "mppi", "optimal_cost.csv"), ["time", "cost"],
               np.stack([t[::10], rng.uniform(1.0, 10.0, 4)], axis=-1))
    _write_csv(os.path.join(folder, "mppi", "update.csv"), ["update", "time", "update_duration"],
               np.stack([np.arange(1, 5), t[::10], rng.uniform(0.01, 0.02, 4)], axis=-1))
    _write_csv(os.path.join(folder, "dynamics", "tank_energy.csv"), ["time", "energy"],
               np.stack([t, 10.0 - rng.uniform(0.0, 1.0, 40).cumsum() / 40], axis=-1))
    _write_csv(os.path.join(folder, "pid", "force", "error.csv"), ["time", "error0", "error1", "error2"],
               np.concatenate([t[:, None], rng.standard_normal((40, 3)) * 0.01], axis=-1))
    return folder


@pytest.fixture()
def runs(tmp_path):
    return [_run_tree(str(tmp_path / "runs" / f"20240101_{name}"), seed) for seed, name in enumerate(("circle", "pose"))]


def test_analyse_single_matches_jax(runs):
    got = analysis.analyse_single(runs[0], plot=False)
    assert got == jax_analysis.analyse_single(runs[0], plot=False)
    assert all(value is not None for value in got.values())
    assert analysis.Run.load(runs[0]).name == jax_analysis.Run.load(runs[0]).name == "Circle"


def test_analyse_multiple_matches_jax(runs, tmp_path):
    parent = os.path.dirname(runs[0])
    got = analysis.analyse_multiple(runs, plot=False)
    texts = {name: open(os.path.join(parent, name)).read()
             for name in ("pid_force_summary.txt", "pid_reference_summary.txt")}
    assert got == jax_analysis.analyse_multiple(runs, plot=False)
    for name, text in texts.items():
        assert open(os.path.join(parent, name)).read() == text, name
    assert len(got) == 2 and all(np.isfinite(row["mean_user_force_N"]) for row in got)


def test_plots_without_matplotlib_raise(runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises
    assert analysis.analyse_single(runs[0], plot=False)["tracking_rmse_m"] > 0.0
    for draw in (lambda: analysis.analyse_single(runs[0]), lambda: analysis.analyse_multiple(runs),
                 lambda: analysis.animate(runs[0])):
        with pytest.raises(ImportError, match="drawing needs matplotlib"):
            draw()


def test_figures_animation_watch_and_cli(runs, tmp_path):
    analysis.analyse_single(runs[0])
    for name in ("error.png", "overview.png", "joints.png"):
        assert os.path.getsize(os.path.join(runs[0], name)) > 1000, name
    gif = analysis.animate(runs[0], stride=20, fps=5)
    assert os.path.getsize(gif) > 1000
    png = analysis.watch(runs[1], interval=0.01, iterations=6)
    assert os.path.getsize(png) > 1000

    experiments = tmp_path / "experiments.json"
    experiments.write_text(json.dumps({"results": {"circle": {"kalman": {"mean_force": 12.0},
                                                              "none": {"mean_force": 27.0}}}}))
    assert os.path.getsize(analysis.barchart(str(experiments), str(tmp_path / "bars.png"))) > 1000
    assert analysis.main(["single", "--no-plot", runs[1]]) == 0
    assert not os.path.exists(os.path.join(runs[1], "overview.png"))
    assert analysis.main(["multiple", "--no-plot", *runs]) == 0
    assert analysis.main(["nothing"]) == 1

"""The rule chip_smoke.py's ``compare`` holds a kernel's smooth costs to,
on a synthetic batch where more than 1% of the rollouts graze a barrier:
there the float32 plain version alone is beyond RTOL / 2 of float64 in
4% of the rollouts. A kernel whose errors are rounding of the same size
passes; one that adds an error of 5 x RTOL in another 3% of the rollouts,
each error below the plain version's worst in the batch, is refused.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

R = 1024
ILL = 0.04  # share of the rollouts that graze a barrier
FAULT = 0.03  # share of the rollouts a faulty kernel gets wrong


def _batch(faulty: bool):
    rng = np.random.default_rng(3)
    truth = 100.0 + 50.0 * rng.random(R)
    ill = rng.random(R) < ILL
    # Rounding: 1e-7 relative everywhere; 1e-3 (the plain version's spread
    # near a barrier) in the ill-conditioned rollouts, drawn independently
    # for the kernel and the plain version.
    spread = np.where(ill, 1e-3, 1e-7)
    plain = truth * (1 + spread * rng.standard_normal(R))
    kernel = truth * (1 + spread * rng.standard_normal(R))
    if faulty:
        wrong = ~ill & (rng.random(R) < FAULT / (1 - ILL))
        kernel = np.where(wrong, truth * (1 + 5 * chip_smoke.RTOL), kernel)
    states = torch.ones((8, 24), dtype=torch.float32)

    def costs(smooth, dtype):
        return torch.tensor(np.stack([np.zeros(R), smooth], axis=1), dtype=dtype)

    return (
        (None, costs(kernel, torch.float32), states),
        (None, costs(plain, torch.float32), states),
        lambda: (None, costs(truth, torch.float64), states.double()),
    )


def test_compare_passes_rounding_in_an_ill_conditioned_batch():
    out = chip_smoke.compare(*_batch(faulty=False))
    assert out["smooth_outliers"] > chip_smoke.OUTLIER_SHARE * R
    assert out["kernel_smooth_beyond_half_rtol_of_float64"] <= (
        out["plain_smooth_beyond_half_rtol_of_float64"] + chip_smoke.OUTLIER_SHARE * R
    )


def test_compare_refuses_a_fault_hidden_in_an_ill_conditioned_batch():
    kernel, plain, exact = _batch(faulty=True)
    worst_plain = float(((plain[1][:, 1].double() - exact()[1][:, 1]).abs() / exact()[1][:, 1]).max())
    assert worst_plain > 5 * chip_smoke.RTOL  # each wrong value is within the plain version's worst
    with pytest.raises(AssertionError, match="beyond .* of float64"):
        chip_smoke.compare(kernel, plain, exact)


def test_experiment_checks_read_a_csv_tree_and_hold_trees_bitwise(tmp_path):
    """Phase 13's helpers: ``csv_rows`` reads a header-only file (the torque
    PID's when the torque channel is off) as no rows; ``check_tree``
    refuses a tree with a missing row; ``tree_bitwise`` refuses one float32
    bit of difference and a differing host leaf."""
    import collections

    folders = {"dynamics": ["joints.csv", "end_effector_position.csv", "tank_energy.csv"], "pid/force": ["control.csv", "reference.csv"],
               "pid/torque": ["control.csv"], "mppi": ["costs.csv", "weights.csv", "optimal_cost.csv", "update.csv"],
               "objective": ["costs.csv"]}
    for folder, names in folders.items():
        os.makedirs(tmp_path / folder)
        for name in names:
            rows = 0 if folder == "pid/torque" else (2 if folder in ("mppi", "objective") else 20)
            with open(tmp_path / folder / name, "w") as handle:
                handle.write("time,a,b,c\n" + "".join(f"{i * 0.005},1.0,2.0,0.5\n" for i in range(rows)))
    assert chip_smoke.csv_rows(str(tmp_path / "pid" / "torque" / "control.csv")).shape == (0, 0)
    metrics = chip_smoke.check_tree(str(tmp_path), 20, 2, "tree")
    assert metrics["rmse"] == 0.0 and metrics["mean_force"] == pytest.approx(np.sqrt(5.25))
    with pytest.raises(AssertionError, match="rows"):
        chip_smoke.check_tree(str(tmp_path), 21, 2, "tree")

    Pair = collections.namedtuple("Pair", "x count")
    a = Pair(torch.tensor([1.0, 2.0]), 3)
    chip_smoke.tree_bitwise(a, Pair(torch.tensor([1.0, 2.0]), 3), "same")
    with pytest.raises(AssertionError):
        chip_smoke.tree_bitwise(a, Pair(torch.tensor([1.0, float(np.nextafter(np.float32(2), 3))]), 3), "bit")
    with pytest.raises(AssertionError):
        chip_smoke.tree_bitwise(a, Pair(torch.tensor([1.0, 2.0]), 4), "leaf")

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


def _small_batch(kernel_error: float, rollouts: int = 33):
    """R = 33 (kernel 2's partial warp pair): every value rounded by 1e-7
    but rollout 5, where the plain float32 version is 2e-5 from float64 and
    the kernel ``kernel_error``."""
    rng = np.random.default_rng(4)
    truth = 100.0 + 50.0 * rng.random(rollouts)
    plain = truth * (1 + 1e-7 * rng.standard_normal(rollouts))
    kernel = truth * (1 + 1e-7 * rng.standard_normal(rollouts))
    plain[5], kernel[5] = truth[5] * (1 + 2e-5), truth[5] * (1 + kernel_error)
    states = torch.ones((8, 24), dtype=torch.float32)

    def costs(smooth, dtype):
        return torch.tensor(np.stack([np.zeros(rollouts), smooth], axis=1), dtype=dtype)

    return (
        (None, costs(kernel, torch.float32), states),
        (None, costs(plain, torch.float32), states),
        lambda: (None, costs(truth, torch.float64), states.double()),
    )


def test_compare_allows_one_grazing_rollout_in_a_small_batch():
    """1% of 33 rollouts is less than one: the share rules allow one, and
    the outlier, 2e-4 from float64 where the plain version is 2e-5, is
    held to float64 by the per-value rule."""
    assert chip_smoke.outlier_allowance(33) == 1.0
    assert chip_smoke.outlier_allowance(1024) == chip_smoke.OUTLIER_SHARE * 1024
    out = chip_smoke.compare(*_small_batch(-2e-4))
    assert out["smooth_outliers"] == 1
    assert out["smooth_rel_err_vs_float64"]["kernel_max"] == pytest.approx(2e-4, rel=1e-2)


def test_compare_refuses_a_wrong_rollout_in_a_small_batch():
    with pytest.raises(AssertionError, match="further from the float64 value"):
        chip_smoke.compare(*_small_batch(5e-2))


def test_partial_pair_check_refuses_a_changed_live_rollout():
    """``check_partial_pair_bitwise`` on the plain version (the CPU's
    wrapper), which no pair layout changes: R = 33 at one and 4 scenarios
    passes; one bit of a live rollout's cost is refused."""
    from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
    from assistedmanipulation_tpu_torch.models import frankaridgeback as fr
    from assistedmanipulation_tpu_torch.models.model_data import frankaridgeback_model
    from assistedmanipulation_tpu_torch.objectives.assisted_manipulation import Configuration

    spec = cr.RolloutSpec(frankaridgeback_model(), Configuration(), fr.Configuration(), 0.01)
    for scenarios in (1, 4):
        inputs = chip_smoke.rollout_kernel_inputs(33, 6, seed=3, device="cpu", scenarios=scenarios)
        costs, states = cr.rollout(spec, *inputs)
        chip_smoke.check_partial_pair_bitwise(spec, inputs, (costs, states))
    flipped = costs.clone()
    flipped.view(torch.int32)[..., 32, 1] ^= 1
    with pytest.raises(AssertionError, match="partial warp pair"):
        chip_smoke.check_partial_pair_bitwise(spec, inputs, (flipped, states))


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

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

"""The warp-pair kernels' rings on the CPU (scripts/emulate_kernels.py):
each CUDA source compiled by g++, each block's 64 threads run as host
threads at once with the mbarriers as atomics, and the outputs held to the
plain PyTorch versions by chip_smoke's rules at 8 steps (the ring of 4
stages wraps once):

- kernel 2 (csrc/rollout.cu, ``pair_rollout_kernel<C>``) at R = 1 (one
  live lane per warp), 33 (a second pair with one live lane) and 64, one
  scenario and 4 in one launch; the 4-scenario launch bitwise 4
  one-scenario launches;
- kernel 3 (``pair_sample_rollout_kernel<true>``) at 33 and 64 rollouts,
  shift 2 with a fresh tail and no shift: non-fresh noise bitwise, fresh
  draws within chip_smoke's tolerance of philox.normal_draws;
- kernel 1 (``pair_sample_rollout_kernel<false>``) at 33 rollouts: noise
  bitwise.

A wrong slot, parity or arrival count in a ring fails a comparison or
hangs; the card's compiler and speed show only on the card. Needs g++
(skipped by name without it).
"""

import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scripts.emulate_kernels as emulate  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

STEPS = 8


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the kernels cannot be emulated")
    out = tmp_path_factory.mktemp("emulate")
    return {
        ("rollout", 1): emulate.build("rollout", 1, out),
        ("rollout", 4): emulate.build("rollout", 4, out),
        "fused_sample_rollout": emulate.build("fused_sample_rollout", out=out),
        "inkernel_rng_sample_rollout": emulate.build("inkernel_rng_sample_rollout", out=out),
    }


@pytest.mark.parametrize("rollouts,scenarios", [(1, 1), (33, 1), (33, 4), (64, 4)])
def test_rollout_pair_matches_plain_version(libraries, rollouts, scenarios):
    rollout = {1: libraries["rollout", 1], 4: libraries["rollout", 4]}
    line = emulate.run_rollout(rollout, rollouts, STEPS, scenarios, seed=rollouts + scenarios)
    assert line["violations_differ"] == 0
    assert line.get("bitwise_to_one_scenario_launches", scenarios == 1)


@pytest.mark.parametrize("rollouts", [33, 64])
@pytest.mark.parametrize("shift,do_shift", [(2, True), (0, False)])
def test_inkernel_pair_matches_plain_version(libraries, rollouts, shift, do_shift):
    line = emulate.run_inkernel(libraries["inkernel_rng_sample_rollout"], rollouts, STEPS, shift, do_shift)
    assert line["violations_differ"] == 0


def test_fused_pair_matches_plain_version(libraries):
    line = emulate.run_fused(libraries["fused_sample_rollout"], 33, STEPS, 2, True)
    assert line["violations_differ"] == 0

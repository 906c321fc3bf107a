"""The fused kernels' horizon limit, on the CPU.

Kernels 1 and 3 keep their (S, 32) per-step table in a block's shared
memory beside their warp pair's state ring, so each takes at most
``FUSED_MAX_STEPS`` = ``INKERNEL_MAX_STEPS`` steps; each library exports
its own limit, which the wrapper checks against these constants when it
loads (on the card: tests/test_torch_cuda.py, chip_smoke.py phase 1). Here:
the wrapper's input check refuses a longer horizon with a message that
names the limit, before any launch; ``build_flagship`` routes one-scenario
horizons past the fused limit to the two-pass sampler, whose kernel takes
one scenario up to 6,878 steps; and the in-kernel-RNG flagship refuses a
horizon past its own. No update runs at these horizons.
"""

import pytest
import torch

from assistedmanipulation_tpu_torch.kernels import cuda_rollout as cr
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)


def _inputs(steps, rollouts=3):
    """Zero inputs of the fused kernels' shapes on the CPU."""
    return (
        torch.zeros(cr.TABLE_WIDTH),
        torch.zeros((steps, cr.TABLE_WIDTH)),
        torch.zeros(3, dtype=torch.int32),
        torch.zeros((steps, 12, rollouts)),
        torch.zeros(rollouts, dtype=torch.bool),
    )


def test_limits_follow_from_shared_memory():
    ring = 4 * 2 * 12 * 32 * 4 + 8 * 8  # 4 stages of (q, v) x 32 lanes, 8 barriers
    assert cr.STATE_RING_BYTES == ring
    assert cr.INKERNEL_MAX_STEPS == (cr.MAX_SHARED_BYTES - ring) // (cr.TABLE_WIDTH * 4) == 1719
    assert cr.FUSED_MAX_STEPS == (cr.MAX_SHARED_BYTES - ring) // (cr.TABLE_WIDTH * 4) == 1719
    assert cr.ROLLOUT_MAX_TABLE_ROWS == (cr.MAX_SHARED_BYTES - ring) // (cr.STEP_TABLE_WIDTH * 4) == 6878
    assert cr.SHARED_MEMORY_LIMITS == {
        "fused_sample_rollout": ("fsr_max_steps", cr.FUSED_MAX_STEPS),
        "inkernel_rng_sample_rollout": ("irs_max_steps", cr.INKERNEL_MAX_STEPS),
        "rollout": ("ro_max_table_rows", cr.ROLLOUT_MAX_TABLE_ROWS),
    }


def test_fused_kernel_refuses_a_horizon_past_its_limit():
    init, table, meta, old, keep = _inputs(cr.FUSED_MAX_STEPS)
    cr._check_kernel_inputs(init, table, meta, old, keep, fresh=torch.zeros_like(old))
    init, table, meta, old, keep = _inputs(cr.FUSED_MAX_STEPS + 1)
    with pytest.raises(ValueError, match=f"fused kernel .* at most {cr.FUSED_MAX_STEPS} steps"):
        cr._check_kernel_inputs(init, table, meta, old, keep, fresh=torch.zeros_like(old))


def test_inkernel_kernel_refuses_a_horizon_past_its_limit():
    seed, scale = torch.zeros(2, dtype=torch.int32), torch.ones(12)
    init, table, meta, old, keep = _inputs(cr.INKERNEL_MAX_STEPS)
    cr._check_kernel_inputs(init, table, meta, old, keep, seed=seed, scale=scale)
    init, table, meta, old, keep = _inputs(cr.INKERNEL_MAX_STEPS + 1)
    with pytest.raises(ValueError, match=f"in-kernel-RNG kernel .* at most {cr.INKERNEL_MAX_STEPS} steps"):
        cr._check_kernel_inputs(init, table, meta, old, keep, seed=seed, scale=scale)
    build_flagship(4, cr.INKERNEL_MAX_STEPS, device="cpu", inkernel_rng=True)
    with pytest.raises(ValueError, match=f"at most {cr.INKERNEL_MAX_STEPS}"):
        build_flagship(4, cr.INKERNEL_MAX_STEPS + 1, device="cpu", inkernel_rng=True)


@pytest.mark.parametrize("steps,fused", [(50, True), (cr.FUSED_MAX_STEPS, True), (cr.FUSED_MAX_STEPS + 1, False),
                                          (cr.INKERNEL_MAX_STEPS + 1, False)])
def test_build_flagship_routes_long_horizons_to_the_two_pass_sampler(steps, fused):
    flagship = build_flagship(4, steps, device="cpu")
    # ceil(steps * 0.01 / 0.01) may round up a step, as in the JAX planner.
    assert flagship.planner.steps in (steps, steps + 1)
    assert flagship.planner.sampler.fused_assembly is fused
    assert not flagship.planner.sampler.inkernel_rng
    if not fused:
        with pytest.raises(ValueError, match=f"fused kernel takes at most {cr.FUSED_MAX_STEPS}"):
            build_flagship(4, steps, device="cpu", fused_assembly=True)

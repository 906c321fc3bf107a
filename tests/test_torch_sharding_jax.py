"""The port's ``build_flagship(sampler_shards=2)`` step by step against the
JAX package's ``build_flagship(sampler_shards=2)`` (Pallas in interpret
mode, threefry bits), on the CPU at float32.

Each update starts both packages from the same JAX state (its lane-layout
noise converted with ``interop.lane_noise_to_logical(..., shards=2)``: each
JAX shard pads its 100 rollouts to a 128-lane tile on its own) and feeds
the port each JAX shard's fresh draws, ``fold_in(split key, i)`` at that
shard's lane shape, as ``fresh=``: the fused path, and the two-pass path at
2 scenarios. Noise bitwise, violation counts exact, the rest at
test_torch_flagship's tolerances (costs 2e-5, weights 1e-5 absolute,
controls 1e-5 relative + 2e-4): the JAX twin contracts the weighted noise
sum in one product, the port adds the shards' partials in shard order.
The rest of the sharding tests: tests/test_torch_sharding.py.
"""

from assistedmanipulation_tpu.parallel.flagship import build_flagship as jax_build_flagship
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from test_torch_flagship import TIMES, _step_by_step  # noqa: E402

STEPS = 4
ROLLOUTS = 198  # 200 with the statics: 2 shards of 100, each padded to 128 lanes on the JAX side


def _jax_flagship(**options):
    return jax_build_flagship(
        rollouts=ROLLOUTS, steps=STEPS, backend="pallas", sublanes=1, interpret=True,
        rng_impl="threefry2x32", sampler_shards=2, **options,
    )


def test_sharded_flagship_matches_jax_fused():
    jax_flagship = _jax_flagship()
    assert jax_flagship.planner.sampler.shards == 2
    flagship = build_flagship(rollouts=ROLLOUTS, steps=STEPS, device="cpu", sampler_shards=2)
    (state, _), = _step_by_step(jax_flagship, [flagship], TIMES[:3], shards=2)
    assert flagship.planner.sampler.shards.count == 2
    assert state.noise.shape == (STEPS, 12, ROLLOUTS + 2)


def test_sharded_scenario_flagship_matches_jax_two_pass():
    jax_flagship = _jax_flagship(scenarios=2)
    flagship = build_flagship(rollouts=ROLLOUTS, steps=STEPS, device="cpu", scenarios=2, sampler_shards=2)
    assert not flagship.planner.sampler.fused_assembly
    _step_by_step(jax_flagship, [flagship], TIMES[:2], shards=2)

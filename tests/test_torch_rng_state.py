"""The planner's randomness is part of its state's value: an update is a
function of its ``PlannerState``, as in the JAX package, whose key is data
in the state split by every update (assistedmanipulation_tpu/mppi.py:355-360,
:466-469). The port keeps two uint32 key words on the host and splits them
with its own Philox (``philox.split_key``); the fused and two-pass samplers
seed ``torch.randn`` with the update's seed words, the in-kernel sampler
takes them as its Philox key. Checked on the CPU for all three flagships at
a tiny size: two updates from one state are bitwise equal, successive
updates draw different noise, and a round trip through ``interop``
continues the stream bitwise. The JAX key's data survives ``interop`` too.
"""

import jax
import numpy as np
import pytest
import torch

from assistedmanipulation_tpu_torch import interop
from assistedmanipulation_tpu_torch.kernels import philox
from assistedmanipulation_tpu_torch.parallel.flagship import build_flagship
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

ROLLOUTS, STEPS = 14, 4
FLAGSHIPS = {
    "fused": {},
    "two_pass": {"fused_assembly": False},
    "inkernel_rng": {"inkernel_rng": True},
}


def _flagship(kind):
    return build_flagship(ROLLOUTS, STEPS, device="cpu", **FLAGSHIPS[kind])


def _assert_bitwise(got, want):
    assert type(got) is type(want)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a, b), name
        assert a.dtype == b.dtype, name


def _warm(flagship, updates=2):
    """A state a few updates in, so elite rows and the shift take part."""
    state, ctx = flagship.init(seed=5), flagship.make_ctx()
    for k in range(updates):
        state, _ = flagship.update(state, flagship.x0, 0.01 * k, ctx)
    return state


@pytest.mark.parametrize("kind", sorted(FLAGSHIPS))
def test_two_updates_from_one_state_are_bitwise_equal(kind):
    flagship = _flagship(kind)
    state, ctx = _warm(flagship), flagship.make_ctx()
    key = state.rng.clone()
    first = flagship.update(state, flagship.x0, 0.03, ctx)
    second = flagship.update(state, flagship.x0, 0.03, ctx)
    assert torch.equal(state.rng, key)  # the update did not touch its input
    for got, want in zip(first, second):
        _assert_bitwise(got, want)
    assert torch.equal(first[0].rng, philox.split_key(key)[0])


@pytest.mark.parametrize("kind", sorted(FLAGSHIPS))
def test_successive_updates_draw_different_noise(kind):
    """Two successive updates from the same costs and time: every row that
    takes fresh noise draws other values the second time."""
    flagship = _flagship(kind)
    state, ctx = flagship.init(seed=5), flagship.make_ctx()
    first, _ = flagship.update(state, flagship.x0, 0.0, ctx)
    again, _ = flagship.update(first._replace(costs=state.costs), flagship.x0, 0.0, ctx)
    fresh_rows = ~flagship.planner._sample_meta(state, torch.tensor(0.0))[4]
    fresh_rows[:2] = False  # the static rollouts
    assert int(fresh_rows.sum()) > ROLLOUTS // 2
    drawn_first = first.noise[:, :10, fresh_rows]  # dofs 10 and 11 have zero variance
    drawn_again = again.noise[:, :10, fresh_rows]
    assert bool((drawn_first != 0).all()) and bool((drawn_again != 0).all())
    assert not bool((drawn_first == drawn_again).any())
    assert not torch.equal(philox.split_key(state.rng)[1], philox.split_key(first.rng)[1])


@pytest.mark.parametrize("kind", sorted(FLAGSHIPS))
def test_interop_round_trip_continues_the_stream(kind):
    flagship = _flagship(kind)
    state, ctx = _warm(flagship), flagship.make_ctx()
    arrays = interop.planner_state_to_numpy(state)
    assert arrays["rng"].dtype == np.uint32 and arrays["rng"].shape == (2,)
    back = interop.planner_state_from_numpy(arrays, flagship.planner.rollout_count, device="cpu")
    assert back.rng.device.type == "cpu" and torch.equal(back.rng, state.rng)
    for _ in range(2):
        state, info = flagship.update(state, flagship.x0, 0.05, ctx)
        back, back_info = flagship.update(back, flagship.x0, 0.05, ctx)
        _assert_bitwise(back, state)
        _assert_bitwise(back_info, info)


def test_key_split_is_philox_at_counter_zero_and_keys_come_from_seeds():
    """Random123's known answer for Philox4x32-10 at counter 0, key 0
    (kat_vectors: 6627e8d5 e169c58d bc57ac4c 9b00dbd8): the first two words
    are the next key, the last two the seed words as int32. A planner's
    first key is the JAX layout of ``jax.random.key(seed)``'s data, and
    ``interop`` carries a JAX key's data as the port's key."""
    key, words = philox.split_key(torch.tensor([0, 0]))
    assert key.tolist() == [0x6627E8D5, 0xE169C58D] and key.dtype == torch.int64
    assert words.dtype == torch.int32
    assert (words.numpy().view(np.uint32) == [0xBC57AC4C, 0x9B00DBD8]).all()
    for seed in (0, 7, 2**32 + 9):
        jax_words = np.asarray(jax.random.key_data(jax.random.key(seed, impl="threefry2x32")))
        assert philox.key_from_seed(seed).tolist() == jax_words.tolist()
    flagship = _flagship("fused")
    arrays = interop.planner_state_to_numpy(flagship.init(seed=0))
    jax_key = np.asarray(jax.random.key_data(jax.random.key(3, impl="threefry2x32")))
    back = interop.planner_state_from_numpy({**arrays, "rng": jax_key}, ROLLOUTS + 2, device="cpu")
    assert back.rng.tolist() == [0, 3]

"""The port's counter-based normal draws (kernels/philox.py), the plain twin
of the in-kernel-RNG CUDA kernel's generator.

- Philox4x32-10 against the known-answer vectors of Random123 (Salmon et
  al., SC'11), exactly.
- The uniform mapping bitwise against the JAX kernel's own expression
  (pallas_rollout.py:477-484) evaluated with jax.lax on the same bits.
- Box-Muller within 4 ulps of a float64 numpy evaluation from the same
  float32 uniforms, the angle pi x with x = 2 u2 (the CUDA kernel's
  sincospif argument).
- The draws pass the 5-sigma mean/std/skew gate of scripts/tpu_crosscheck.py
  at 1.2M draws, and a rollout's draws do not depend on the rollout count.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from assistedmanipulation_tpu_torch.kernels import philox
from torch_threads import one_torch_thread  # noqa: E402,F401  (a module fixture)

KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32_10(counter, key)
    assert [int(word) for word in got] == list(want)


def _words(seed, steps, rollouts):
    key = philox._key_words(seed)
    r = torch.arange(rollouts)[None, None, :]
    s = torch.arange(steps)[:, None, None]
    c = torch.arange(philox.CALLS)[None, :, None]
    return torch.stack(philox.philox4x32_10((r, s, c, 0), key), dim=2)  # (S, 3, 4, R)


def test_philox_counters_broadcast_like_single_calls():
    """Element (s, c, w, r) of the batched call is word w of the call on
    counter (r, s, c, 0)."""
    seed = torch.tensor([7, -9], dtype=torch.int32)
    words = _words(seed, 3, 5)
    key = philox._key_words(seed)
    for r, s, c in ((0, 0, 0), (4, 2, 1), (3, 1, 2)):
        single = philox.philox4x32_10((r, s, c, 0), key)
        assert [int(w) for w in words[s, c, :, r]] == [int(w) for w in single]


def test_uniforms_match_the_jax_kernel_expression():
    bits = np.random.default_rng(0).integers(0, 2**32, size=4096, dtype=np.uint64)
    bits[:4] = [0, 1, 0x1FF, 0xFFFFFFFF]
    mantissa = jax.lax.bitwise_or(
        jax.lax.shift_right_logical(jnp.asarray(bits, jnp.uint32), jnp.uint32(9)),
        jnp.uint32(0x3F800000),
    )
    want = np.asarray(2.0 - jax.lax.bitcast_convert_type(mantissa, jnp.float32))
    got = philox.uniforms(torch.tensor(bits.astype(np.int64))).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() > 0.0 and got.max() == 1.0


@pytest.mark.parametrize("seed", [(123, -77), (0, 0)])
def test_box_muller_within_ulps_of_float64(seed):
    seed = torch.tensor(seed, dtype=torch.int32)
    steps, rollouts = 20, 500
    z = philox.normal_draws(seed, steps, rollouts, torch.ones(12)).numpy()
    u = philox.uniforms(_words(seed, steps, rollouts)).reshape(steps, 6, 2, rollouts).numpy()
    radius = np.sqrt(-2.0 * np.log(u[:, :, 0].astype(np.float64)))
    theta = np.pi * (2.0 * u[:, :, 1]).astype(np.float64)
    want = np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=2).reshape(steps, 12, rollouts)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(z - want) <= 4 * ulp).all()


def test_draws_pass_the_distribution_gate():
    """1.2M draws: per dof, mean, std and skew within 5 sigma of N(0,
    scale^2); a zero-scale dof stays exactly zero."""
    scale = torch.tensor([0.5, 1.0, 2.0, 0.1, 1.0, 1.0, 3.0, 1.0, 1.0, 0.2, 0.0, 0.0])
    z = philox.normal_draws(torch.tensor([2024, 11], dtype=torch.int32), 100, 1000, scale)
    assert z.shape == (100, 12, 1000) and z.dtype == torch.float32
    for d in range(12):
        x = z[:, d].double().flatten().numpy()
        n, expected = x.size, float(scale[d])
        if expected == 0:
            assert not x.any()
            continue
        mean, std = x.mean(), x.std()
        skew = ((x - mean) ** 3).mean() / std**3
        assert abs(mean) <= 5 * expected / np.sqrt(n)
        assert abs(std - expected) <= 5 * expected / np.sqrt(2 * n)
        assert abs(skew) <= 5 * np.sqrt(6.0 / n)


def test_a_rollouts_draws_do_not_depend_on_the_rollout_count():
    seed = torch.tensor([5, 6], dtype=torch.int32)
    scale = torch.linspace(0.1, 1.0, 12)
    many = philox.normal_draws(seed, 7, 300, scale)
    few = philox.normal_draws(seed, 7, 100, scale)
    assert torch.equal(many[:, :, :100], few)
    other = philox.normal_draws(torch.tensor([5, 7], dtype=torch.int32), 7, 100, scale)
    assert not torch.equal(other, few)


def test_seed_words_come_from_the_generator():
    """Two int32 words per call; the same generator state gives the same
    words, the next call others."""
    generator = torch.Generator().manual_seed(3)
    state = generator.get_state()
    first = philox.seed_words(generator)
    second = philox.seed_words(generator)
    assert first.dtype == torch.int32 and first.shape == (2,)
    assert not torch.equal(first, second)
    generator.set_state(state)
    assert torch.equal(philox.seed_words(generator), first)

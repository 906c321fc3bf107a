"""Counter-based normal draws for the in-kernel-RNG sampler: the plain
PyTorch twin of csrc/philox.cuh (counterpart of the TPU kernel's
``pltpu.prng_seed`` / ``prng_random_bits``, its ``uniform()`` and its
Box-Muller lines, assistedmanipulation_tpu/kernels/pallas_rollout.py:473-497).

The TPU's hardware generator cannot be reproduced off the TPU, so the port
writes its own: Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11; the generator behind cuRAND's and PyTorch's
Philox). The same bits come out of this module on any device and out of the
CUDA kernel.

- Key: the update's 2 seed words. Counter: (rollout r, step s, call c, 0),
  c = 0, 1, 2; each call gives 4 words, so a (rollout, step) has 12.
- Uniform i = 4c + w (w the word index) is u1 of Box-Muller pair p at
  i = 2p and u2 at i = 2p + 1, the TPU kernel's draw order.
- A rollout's draws depend only on (seed, r, s): not on the rollout count
  or the block layout. A rollout shard draws under its own words
  (``shard_seed``, the JAX sampler's ``fold_in(key, shard)``), r counting
  within the shard.
- Conversion: u = 2 - bitcast((bits >> 9) | 0x3F800000) in (0, 1], as the
  TPU kernel's; r = sqrt(-2 log u1) in float32; dof 2p = r cos(pi x), dof
  2p + 1 = r sin(pi x) with x = 2 u2 (exact in float32), cos and sin in
  float64 rounded to float32 (the CUDA kernel's ``sincospif``, within an
  ulp of them); then times the dof's scale. The TPU kernel takes theta =
  float32(2 pi) u2 instead: the same distribution, not the same bits.

Words are held as uint32 values in int64 tensors. A 32 x 32-bit product
overflows int64, so ``_mulhilo`` splits one factor into 16-bit halves. The
same rounds run on Python integers for the planner's key (``split_key``),
which lives on the host: an update derives its seed words without device
work or a sync.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
CALLS = 3  # Philox calls per (rollout, step): 12 words, 6 Box-Muller pairs
MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the uint32 words ``b``."""
    x = a * (b >> 16)  # < 2^48
    y = a * (b & 0xFFFF)  # < 2^48
    z = ((x & 0xFFFF) << 16) + y  # < 2^49
    return (x >> 16) + (z >> 32), z & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (4 uint32 word tensors, or ints) under
    ``key`` (2 uint32 words, tensors or ints). Returns 4 int64 tensors of
    uint32 values, broadcast over the inputs."""
    c = (torch.as_tensor(word, dtype=torch.int64) for word in counter)
    k = (torch.as_tensor(word, dtype=torch.int64) for word in key)
    return torch.broadcast_tensors(*_rounds(*c, *k))


def _rounds(c0, c1, c2, c3, k0, k1):
    """The 10 Philox rounds on uint32 words held in int64 tensors or Python
    integers."""
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 uniforms in (0, 1] by mantissa
    fill: 2 - bitcast((bits >> 9) | 0x3F800000), pallas_rollout.py:475-484."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return 2.0 - mantissa.view(torch.float32)


def _key_words(seed: torch.Tensor):
    words = seed.to(torch.int64) & MASK32
    return words[0], words[1]


def normal_draws(seed: torch.Tensor, steps: int, rollouts: int, scale: torch.Tensor) -> torch.Tensor:
    """(S, 12, R) N(0, diag(scale^2)) draws of one update in ``scale``'s
    dtype and device: ``seed`` (2,) int32 seed words, ``scale`` (12,) per-dof
    standard deviations. Element (s, d, r) is what the CUDA kernel draws for
    rollout r at step s."""
    device = scale.device
    key = _key_words(seed.to(device))
    r = torch.arange(rollouts, dtype=torch.int64, device=device)[None, None, :]
    s = torch.arange(steps, dtype=torch.int64, device=device)[:, None, None]
    c = torch.arange(CALLS, dtype=torch.int64, device=device)[None, :, None]
    words = torch.stack(philox4x32_10((r, s, c, 0), key), dim=2)  # (S, 3, 4, R)
    u = uniforms(words).reshape(steps, 6, 2, rollouts)
    radius = torch.sqrt(-2.0 * torch.log(u[:, :, 0]))
    angle = math.pi * (2.0 * u[:, :, 1]).double()  # pi x, x = 2 u2 exact
    z = torch.stack([radius * torch.cos(angle).float(), radius * torch.sin(angle).float()], dim=2)
    z = z.reshape(steps, 12, rollouts)
    return z.to(scale.dtype) * scale[None, :, None]


def key_from_seed(seed: int) -> torch.Tensor:
    """A planner's first key: (2,) int64 on the host holding the uint32
    words (seed >> 32, seed), as ``jax.random.key(seed)``'s data."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64)


def split_key(key: torch.Tensor):
    """(next key, seed words) of one update from the planner's (2,) host
    key, the counterpart of the JAX planner's ``jax.random.split``
    (assistedmanipulation_tpu/mppi.py:466-469): the 4 words of
    Philox4x32-10 at counter 0 under the key; the first two are the next
    key ((2,) int64), the last two this update's seed words ((2,) int32,
    the in-kernel sampler's Philox key and the seed of the others'
    ``torch.randn``). Python integers only: no device work, no sync."""
    following, words = split_key_words(key.tolist())
    return torch.tensor(following, dtype=torch.int64), torch.tensor(words, dtype=torch.int32)


def split_key_words(key) -> tuple:
    """``split_key`` on the key's two words as numbers: ((next key's two
    uint32 words), (the update's two seed words as int32)), Python integers
    a caller can write into buffers of its own."""
    k0, k1 = (int(word) & MASK32 for word in key)
    w0, w1, w2, w3 = _rounds(0, 0, 0, 0, k0, k1)
    return (w0, w1), tuple(w - (1 << 32) if w >= 1 << 31 else w for w in (w2, w3))  # seed words as int32


# The fourth counter word of the shard words (``shard_seed``): the draws
# take counters (r, s, c, 0) under the same key, so no shard's words repeat
# a draw's bits.
SHARD_COUNTER = 1


def shard_seed(seed: torch.Tensor, shard: int) -> torch.Tensor:
    """The (2,) int32 seed words of rollout shard ``shard`` from an update's
    (2,) host seed words: the counterpart of the JAX sampler's
    ``fold_in(key, shard)`` (assistedmanipulation_tpu/kernels/pallas_rollout.py:
    1338, :1346), so a shard's draws depend on (seed, shard) alone, never on
    where the shard runs. ``shard`` is the shard's coordinate on the rollout
    axis. Shard 0 keeps the update's words, so an unsharded sampler (one
    shard) draws what it always drew; shard i > 0 takes the first two words
    of Philox4x32-10 at counter (i, 0, 0, SHARD_COUNTER) under the seed
    words. Python integers only: no device work, no sync."""
    if shard == 0:
        return seed
    k0, k1 = (int(word) & MASK32 for word in seed.tolist())
    w0, w1, _, _ = _rounds(shard, 0, 0, SHARD_COUNTER, k0, k1)
    return torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in (w0, w1)], dtype=torch.int32)


def seed_bits(seed: torch.Tensor) -> int:
    """The 64 bits of the (2,) host seed words, as the fused and two-pass
    samplers seed their ``torch.randn`` generator with them."""
    w0, w1 = (int(word) & MASK32 for word in seed.tolist())
    return (w0 << 32) | w1


def seed_words(generator: torch.Generator) -> torch.Tensor:
    """(2,) int32 seed words drawn from ``generator`` on its own device with
    one small call and no host sync (the counterpart of
    ``jax.random.bits(key, (2,))``, pallas_rollout.py:1247-1249): kernel
    inputs for the checks and timings; the planner splits its words from
    its key (``split_key``)."""
    return torch.randint(
        -(2**31), 2**31, (2,), dtype=torch.int32, generator=generator, device=generator.device
    )

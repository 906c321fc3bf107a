"""The planner's key chain, copied from
``assistedmanipulation_tpu_torch/kernels/philox.py`` (``key_from_seed``,
``split_key``, ``seed_bits``) at commit 761f38a: Philox4x32-10 on Python
integers. The benchmark works each update's seed words out from ``--seed``
with it, and never reads them from the program."""

from __future__ import annotations

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: int):
    product = a * b
    return product >> 32, product & MASK32


def _rounds(c0, c1, c2, c3, k0, k1):
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_from_seed(seed: int) -> tuple:
    """A planner's first key: the uint32 words (seed >> 32, seed)."""
    return (seed >> 32) & MASK32, seed & MASK32


def split_key(key: tuple) -> tuple:
    """(next key, this update's seed words), both pairs of uint32 words."""
    w0, w1, w2, w3 = _rounds(0, 0, 0, 0, *key)
    return (w0, w1), (w2, w3)


def seed_bits(words: tuple) -> int:
    """The 64 bits a sampler seeds its ``torch.randn`` generator with."""
    return (words[0] << 32) | words[1]


def update_words(seed: int, updates: int) -> list:
    """The seed words of updates 0 .. ``updates`` - 1 from ``--seed``, and
    the key each update starts from: [(key, words), ...]."""
    key, out = key_from_seed(seed), []
    for _ in range(updates):
        following, words = split_key(key)
        out.append((key, words))
        key = following
    return out

"""``jax.random``'s threefry2x32 generator, bit for bit, in torch ops.

The router's tiebreak chain (``key_{i+1}, sub_i = split(key_i)``, then
``uniform(sub_i, (K,))``) and the per-seed state keys are threefry draws
in the JAX package; without the same bits, whole-run parity cannot be
tested. This module reproduces JAX 0.9's default configuration
(``jax_threefry_partitionable=True``):

  * ``split`` is ``_threefry_split_foldlike``: the key hashes the 64-bit
    counters 0..num-1 (split into hi/lo words) and the two output words
    of counter i form new key i;
  * random bits are ``_threefry_random_bits_partitionable``: counter i of
    the flattened shape gives ``bits1 ^ bits2``;
  * ``uniform`` keeps the top 23 bits as the mantissa of a float in
    [1, 2) and subtracts 1.

uint32 values are held in int64 tensors and masked after every add, so
the arithmetic is exact on any device. Keys have shape (..., 2): every
function is vectorised over the leading axes (the router's state axis).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor: the 64-bit
    seed's high and low words. Seeds are limited to [0, 2**32)."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed={seed}: need 0 <= seed < 2**32")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 holding uint32 values, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _hash_counters(key: Tensor, shape: tuple):
    """(bits1, bits2) of shape key.shape[:-1] + shape: the key hashes the
    flattened index of every element of ``shape`` (iota_2x32_shape)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    expand = (Ellipsis,) + (None,) * len(shape)
    k1, k2 = key[..., 0][expand], key[..., 1][expand]
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2) new keys."""
    bits1, bits2 = _hash_counters(key, (num,))
    return torch.stack([bits1, bits2], dim=-1)


def random_bits(key: Tensor, shape: tuple) -> Tensor:
    """32 random bits per element: (..., 2) keys -> (..., *shape) int64."""
    bits1, bits2 = _hash_counters(key, tuple(shape))
    return bits1 ^ bits2


def uniform(key: Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in
    [minval, maxval): (..., *shape) f32. As in JAX, the [0, 1) floats are
    scaled by (maxval - minval) (an f32 difference) and shifted by minval
    with one rounding, as XLA's fused multiply-add does (the f32 product is
    exact in f64), then floored at minval."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000          # exponent of 1.0
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:            # the affine map is exact
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def gumbel(key: Tensor, shape: tuple) -> Tensor:
    """``jax.random.gumbel(key, shape)`` (its default "low" mode):
    -log(-log(u)) with u uniform in [tiny, 1), f32."""
    u = uniform(key, shape, minval=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))

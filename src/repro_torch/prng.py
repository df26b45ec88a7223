"""The parts of `jax.random` the reference draws through, bit for bit.

The reference samples with `jax.random` under its default implementation,
threefry2x32 with `jax_threefry_partitionable` on. A seeded request must
give the reference's tokens, not only its distribution, so this module
rebuilds that stream in torch integer ops:

* `key_data(seed)`: the (2,) key data of `jax.random.key(seed)`,
  [0, seed mod 2**32] (a 32-bit seed has no high word);
* `fold_in(key, d)`: threefry2x32(key, (0, d)), the new key's two words;
* `random_bits(key, n)`: per key row, the 32-bit draws of
  `jax.random.bits(key, (n,))`, which are hi ^ lo of
  threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)) at each flat index i;
* `uniform`, `gumbel` and `categorical` on top of them, as
  `jax.random` builds them (mode "low").

A key is its data: a (..., 2) int64 tensor of two 32-bit words. Torch has
no `<<` for uint32 on the CPU and shifts int32 arithmetically, so every
word is carried in int64 and masked back to 32 bits after each add and
left shift. Only threefry2x32, JAX's default, is rebuilt: a key is always
2 words wide. Every function is plain tensor ops on the key's device, with
no host sync, so a CUDA graph can capture them. The integer draws are
bitwise JAX's; the float steps after them (`log`) can differ from XLA's by
an ulp, so Gumbel noise agrees to about 1e-6.
"""
from __future__ import annotations

import numpy as np
import torch

KEY_WIDTH = 2                 # words of a threefry2x32 key
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA          # the key schedule's third word: k0 ^ k1 ^ this
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The 20-round threefry2x32 block cipher of JAX's default PRNG on
    32-bit words held in int64 (all four broadcast together). Returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key_data(seed: int) -> torch.Tensor:
    """The (2,) key data of jax.random.key(seed): [0, seed mod 2**32]."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def as_key_data(key) -> torch.Tensor:
    """A key's data as the (..., 2) int64 words this module works on, from
    uint32 key data (numpy or torch) or int64 words."""
    if isinstance(key, np.ndarray):
        key = torch.from_numpy(key.astype(np.int64) & _MASK)
    key = torch.as_tensor(key)
    if key.shape[-1:] != (KEY_WIDTH,):
        raise ValueError(f"key data must end in {KEY_WIDTH} words, got "
                         f"shape {tuple(key.shape)}")
    return key.to(torch.int64) & _MASK


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in over a batch: key (..., 2) with data (...) (a
    tensor, or an int for every key), taken as uint32. Returns (..., 2)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & _MASK
    else:
        # a fill, not a host-to-device copy: a CUDA graph captures it
        data = torch.full_like(key[..., 0], int(data) & _MASK)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """Per key row, the n 32-bit draws of jax.random.bits(key, (n,)), as
    jax.vmap over the rows gives them: key (B, 2) -> (B, n) int64 words.
    n < 2**32, so every counter's high word is 0."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    y0, y1 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(idx), idx)
    return y0 ^ y1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from 32-bit words: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32, minval, maxval) per key row:
    (B, 2) -> (B, n) f32, max(minval, f * (maxval - minval) + minval) with
    the bounds and their difference rounded to f32 first, as JAX's are."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(random_bits(key, n))
    return torch.clamp(f * float(hi - lo) + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.gumbel(key, (n,)) per key row (mode "low"):
    -log(-log(uniform(tiny, 1))), (B, 2) -> (B, n) f32."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key_b, logits[b]) per row: the argmax of the
    logits plus Gumbel noise. key (B, 2), logits (B, V) -> (B,) int64."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits.to(torch.float32), dim=-1)

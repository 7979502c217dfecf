"""Threefry-2x32 random bits in torch, equal to the JAX package's.

The fabric-loss mask of fault injection (``routing._drop_mask``) must
park exactly the records the JAX package parks, or superstep counts under
loss diverge from the reference.  The JAX package draws it with
``jax.random`` (the threefry2x32 generator, partitionable bit layout):

  * ``PRNGKey(s)`` is the key ``(0, s)``;
  * ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  * ``bits(k, (L,))[i]`` is ``x0 ^ x1`` where ``(x0, x1) =
    threefry2x32(k, (0, i))``;
  * ``uniform`` keeps the top 23 bits as a float32 mantissa in [1, 2) and
    subtracts 1.

Here a 32-bit word is an int64 tensor masked to 32 bits (torch's uint32
has no arithmetic), so every op stays on the tensors' device and reads
nothing on the host: a mask keyed on a device counter can be captured in a
CUDA graph.  Keys are ``(..., 2)`` tensors and broadcast.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block (20 rounds) of ``key`` (``(..., 2)``) on the
    counter words ``(x0, x1)``; all int64 holding 32-bit words, broadcast
    together.  Returns the two output words."""
    k0, k1 = key[..., 0] & _M32, key[..., 1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``: ``(0, seed)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` (``(..., 2)``) with ``data`` (an int
    or an integer tensor broadcasting against ``key[..., 0]``) folded in."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    zero = torch.zeros_like(data)
    y0, y1 = threefry2x32(key, zero, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` as int64 words: ``(..., n)`` for a
    ``(..., 2)`` key."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: float32 in [0, 1), ``(..., n)``."""
    bits = ((random_bits(key, n) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0

"""Plain PyTorch version of the flip_corrupt kernel, bit-exact with the JAX
package's oracle ``repro.kernels.flip_corrupt.ref.flip_corrupt_ref``.

The counter hash is uint32 arithmetic that wraps mod 2^32.  PyTorch's uint32
coverage is partial and a product of two 32-bit words does not fit in int64
(0xFFFFFFFF * 0x9E3779B9 > 2^63), so words are held in int64 and every
product is taken by the constant's 16-bit halves, each partial product below
2^48, and masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 words x in [0, 2^32) and a 32-bit c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit murmur-style finalizer (the reference's ``mix32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_u32(idx: torch.Tensor, seed: int, plane: int) -> torch.Tensor:
    """Counter-hash word for (element index, seed, bit plane) as int64 in
    [0, 2^32); `seed` is the int32 seed, reinterpreted as uint32."""
    add = ((seed & _M32) * 0x85EBCA6B + plane * 0xC2B2AE35) & _M32
    return mix32(mix32((_mul32(idx, 0x9E3779B9) + add) & _M32))


def flip_threshold(p) -> int:
    """floor(clip(float32(p), 0, 1) * 2^24), computed in float32 as the
    reference's ``flip_threshold`` does: 0 never flips, 1 always flips."""
    p32 = np.clip(np.float32(p), np.float32(0.0), np.float32(1.0))
    return int(np.float32(p32 * np.float32(1 << 24)))


def flip_corrupt_ref(codes: torch.Tensor, scale, p, seed: int, *,
                     bits: int) -> torch.Tensor:
    """codes (...) int8 -> corrupted, dequantized f32 of the same shape.

    The hash index of an element is its flat index, which equals the
    reference's ``row * C + col`` over the ``(-1, C)`` view."""
    shape = codes.shape
    flat = codes.reshape(-1).to(torch.int64)
    idx = torch.arange(flat.numel(), dtype=torch.int64,
                       device=codes.device) & _M32
    thr = flip_threshold(p)
    mask = torch.zeros_like(flat)
    for b in range(bits):
        flip = (hash_u32(idx, int(seed), b) >> 8) < thr
        mask = mask | (flip.to(torch.int64) << b)
    x = (flat & ((1 << bits) - 1)) ^ mask
    if bits == 1:
        val = (2 * x - 1).to(torch.float32)
    else:
        x = torch.where((x & (1 << (bits - 1))) != 0, x - (1 << bits), x)
        val = x.to(torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return (val * scale).reshape(shape)

"""Plain PyTorch version of the flip_corrupt kernel, bit-exact with the JAX
package's oracle ``repro.kernels.flip_corrupt.ref.flip_corrupt_ref``.

``flip_corrupt_grid_ref`` is the batched form, the function the kernel
computes: every leaf at every grid point, broadcast over the points;
``flip_corrupt_ref`` is its one-point, one-leaf call.

The counter hash is uint32 arithmetic that wraps mod 2^32.  PyTorch's uint32
coverage is partial and a product of two 32-bit words does not fit in int64
(0xFFFFFFFF * 0x9E3779B9 > 2^63), so words are held in int64 and every
product is taken by the constant's 16-bit halves, each partial product below
2^48, and masked back to 32 bits.
"""

from __future__ import annotations

from typing import Sequence

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


def flip_threshold(p) -> int:
    """floor(clip(float32(p), 0, 1) * 2^24), as the reference's
    ``flip_threshold`` computes it in float32: 0 never flips, 1 always
    flips.  The product by 2^24 is exact in float32, so it is taken on the
    float32 value in Python."""
    return int(min(max(float(np.float32(p)), 0.0), 1.0) * float(1 << 24))


def flip_corrupt_grid_ref(leaves: Sequence, ps: Sequence,
                          seeds: Sequence[Sequence[int]]) -> list:
    """Each leaf corrupted and dequantized at each of G grid points.

    leaves: (codes, scale, bits) triples, codes int8 of any shape with
    `bits` significant bits, scale a float32 scalar; ps: G flip
    probabilities; seeds: G rows of one int32 seed per leaf.  Returns one
    float32 tensor (G, *codes.shape) per leaf, whose row g is the leaf at
    (ps[g], seeds[g][leaf]).  The hash index of an element is its flat
    index, which equals the reference's ``row * C + col`` over the
    ``(-1, C)`` view."""
    g = len(ps)
    outs = []
    for j, (codes, scale, bits) in enumerate(leaves):
        dev = codes.device
        thr = torch.tensor([flip_threshold(p) for p in ps], dtype=torch.int64,
                           device=dev).view(g, 1)
        key = _mul32(torch.tensor([int(row[j]) & _M32 for row in seeds],
                                  dtype=torch.int64, device=dev),
                     0x85EBCA6B).view(g, 1)
        flat = codes.reshape(1, -1).to(torch.int64)
        idx = torch.arange(flat.shape[1], dtype=torch.int64, device=dev)
        base = (_mul32(idx & _M32, 0x9E3779B9).view(1, -1) + key) & _M32
        mask = torch.zeros_like(base)
        for b in range(bits):
            r = mix32(mix32((base + b * 0xC2B2AE35) & _M32))
            mask = mask | (((r >> 8) < thr).to(torch.int64) << b)
        x = (flat & ((1 << bits) - 1)) ^ mask
        if bits == 1:
            val = (2 * x - 1).to(torch.float32)
        else:
            x = torch.where((x & (1 << (bits - 1))) != 0, x - (1 << bits), x)
            val = x.to(torch.float32)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        outs.append((val * scale).reshape(g, *codes.shape))
    return outs


def flip_corrupt_ref(codes: torch.Tensor, scale, p, seed: int, *,
                     bits: int) -> torch.Tensor:
    """codes (...) int8 -> corrupted, dequantized f32 of the same shape: the
    one-point, one-leaf call of ``flip_corrupt_grid_ref``."""
    return flip_corrupt_grid_ref([(codes, scale, bits)], [p], [[seed]])[0][0]

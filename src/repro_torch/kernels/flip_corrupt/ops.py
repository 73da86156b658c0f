"""Wrapper of the flip_corrupt CUDA kernel (``csrc/flip_corrupt.cu``).

``flip_corrupt(codes, scale, bits, p, seed)`` flips each of the `bits`
stored bits of every int8 code independently with probability p, from the
counter hash seeded by `seed`, sign-extends and dequantizes to float32 of
the codes' shape.  CPU tensors take the plain version in ``ref.py``; CUDA
tensors launch the kernel on the current stream or raise.  The flip
threshold is computed here, on the host, exactly as the reference does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.flip_corrupt.ref import (flip_corrupt_ref,
                                                  flip_threshold)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


@functools.cache
def _fn():
    fn = _build.load("flip_corrupt").flip_corrupt_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _I, _U, _U, _P]
    fn.restype = _I
    return fn


def flip_corrupt(codes: torch.Tensor, scale: torch.Tensor, bits: int, p,
                 seed: int) -> torch.Tensor:
    """Fused flip -> sign-extend -> dequantize of b-bit integer codes.

    codes: int8 of any shape with `bits` (1..8) significant bits; scale: a
    float32 scalar tensor on the codes' device; p: flip probability (a
    python float); seed: an int32 (python int).  Returns f32 of
    codes.shape."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is not an int32")
    scale = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    if not common.on_card(codes, scale):
        return flip_corrupt_ref(codes, scale, p, seed, bits=bits)
    if codes.dtype != torch.int8 or not codes.is_contiguous():
        raise TypeError(f"codes must be contiguous int8, got {codes.dtype}")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got {tuple(scale.shape)}")
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if codes.numel() == 0:
        return out
    rc = _fn()(codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
               codes.numel(), bits, int(seed) & 0xFFFFFFFF,
               flip_threshold(p), common.stream_of(codes))
    common.check_launch(rc, "flip_corrupt")
    common.launches["flip_corrupt"] += 1
    return out

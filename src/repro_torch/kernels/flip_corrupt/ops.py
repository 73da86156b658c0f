"""Wrapper of the flip_corrupt CUDA kernel (``csrc/flip_corrupt.cu``).

``flip_corrupt_grid(leaves, ps, seeds)`` flips each of the `bits` stored
bits of every int8 code of every leaf independently with probability p,
from the counter hash seeded by the leaf's seed, sign-extends and
dequantizes to float32, at each of G grid points, in one launch (the
reference's sweep vmaps this over its (p, trial) points).
``flip_corrupt(codes, scale, bits, p, seed)`` is its one-point, one-leaf
call.  CPU tensors take the plain version in ``ref.py``; CUDA tensors
launch the kernel on the current stream or raise.  The flip thresholds are
computed here, on the host, exactly as the reference does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.flip_corrupt.ref import (flip_corrupt_grid_ref,
                                                  flip_threshold)

# What one launch takes (csrc/flip_corrupt.cu kMaxLeaves, kMaxPoints): the
# parameter struct carries every leaf's pointers and every point's
# threshold and seeds by value.  Larger calls take one launch per block of
# leaves and points (``launch_plan``).
MAX_LEAVES = 4
MAX_POINTS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("flip_corrupt")
    lib.flip_corrupt_launch.argtypes = [_I, _P, _I, _P, _P, ctypes.c_longlong,
                                        _P]
    lib.flip_corrupt_launch.restype = _I
    lib.flip_corrupt_wave.argtypes = []
    lib.flip_corrupt_wave.restype = _I
    return lib


@functools.cache
def _wave(device_index: int) -> int:
    """Blocks of the one-group kernel the card holds at once: a launch of
    more takes two groups of codes a thread.  Raises when the card could
    not be read."""
    with torch.cuda.device(device_index):
        wave = _lib().flip_corrupt_wave()
    if wave <= 0:
        raise RuntimeError(f"flip_corrupt: occupancy query failed ({wave})")
    return wave


def launch_plan(n_leaves: int, n_points: int) -> list:
    """The launches of a call: (first leaf, end leaf, first point, end
    point) for each block of at most MAX_LEAVES leaves and MAX_POINTS
    points; one launch whenever the call fits."""
    return [(l0, min(l0 + MAX_LEAVES, n_leaves), g0,
             min(g0 + MAX_POINTS, n_points))
            for l0 in range(0, n_leaves, MAX_LEAVES)
            for g0 in range(0, n_points, MAX_POINTS)]


def _check(leaves: list, ps: list, seeds: list) -> None:
    if len(seeds) != len(ps):
        raise ValueError(f"{len(seeds)} seed rows for {len(ps)} points")
    for row in seeds:
        if len(row) != len(leaves):
            raise ValueError(f"a seed row holds {len(row)} seeds for "
                             f"{len(leaves)} leaves")
    flat = [seed for row in seeds for seed in row]
    for seed in (min(flat), max(flat)) if flat else ():
        if not -(1 << 31) <= seed < (1 << 31):
            raise ValueError(f"seed {seed} is not an int32")
    for codes, scale, bits in leaves:
        if not 1 <= bits <= 8:
            raise ValueError(f"bits must be in [1, 8], got {bits}")
        if codes.dtype != torch.int8 or not codes.is_contiguous():
            raise TypeError(f"codes must be contiguous int8, got "
                            f"{codes.dtype}")
        if scale.numel() != 1:
            raise ValueError(f"scale must hold one value, got "
                             f"{tuple(scale.shape)}")


def _scale(scale, device: torch.device) -> torch.Tensor:
    if (isinstance(scale, torch.Tensor) and scale.dtype == torch.float32
            and scale.device == device):
        return scale
    return torch.as_tensor(scale, dtype=torch.float32, device=device)


def flip_corrupt_grid(leaves: Sequence, ps: Sequence,
                      seeds: Sequence[Sequence[int]]) -> list:
    """Fused flip -> sign-extend -> dequantize of several leaves of b-bit
    integer codes at G grid points.

    leaves: (codes, scale, bits) triples: int8 codes of any shape with
    `bits` (1..8) significant bits, a float32 scalar scale, all on one
    device; ps: G flip probabilities (python floats); seeds: G rows of one
    int32 seed (python int) per leaf.  Returns one float32 tensor
    (G, *codes.shape) per leaf; row g is the leaf at (ps[g], seeds[g])."""
    leaves = [(codes, _scale(scale, codes.device), int(bits))
              for codes, scale, bits in leaves]
    ps = [float(p) for p in ps]
    seeds = [[int(seed) for seed in row] for row in seeds]
    _check(leaves, ps, seeds)
    if not leaves:
        return []
    if not common.on_card(*(t for leaf in leaves for t in leaf[:2])):
        return flip_corrupt_grid_ref(leaves, ps, seeds)
    g = len(ps)
    outs = [torch.empty((g, *codes.shape), dtype=torch.float32,
                        device=codes.device) for codes, _, _ in leaves]
    thr = [flip_threshold(p) for p in ps]
    index = leaves[0][0].device.index
    wave = _wave(torch.cuda.current_device() if index is None else index)
    stream = common.stream_of(leaves[0][0])
    for l0, l1, g0, g1 in launch_plan(len(leaves), g):
        if all(leaves[j][0].numel() == 0 for j in range(l0, l1)):
            continue
        desc = []
        for j in range(l0, l1):
            codes, scale, bits = leaves[j]
            desc += [codes.data_ptr(),
                     outs[j].data_ptr() + g0 * codes.numel() * 4,
                     scale.data_ptr(), codes.numel(), bits]
        seed_words = [row[j] & 0xFFFFFFFF for row in seeds[g0:g1]
                      for j in range(l0, l1)]
        rc = _lib().flip_corrupt_launch(
            l1 - l0, (ctypes.c_longlong * len(desc))(*desc), g1 - g0,
            (ctypes.c_uint * (g1 - g0))(*thr[g0:g1]),
            (ctypes.c_uint * len(seed_words))(*seed_words), wave, stream)
        common.check_launch(rc, "flip_corrupt")
        common.launches["flip_corrupt"] += 1
    return outs


def flip_corrupt(codes: torch.Tensor, scale: torch.Tensor, bits: int, p,
                 seed: int) -> torch.Tensor:
    """Fused flip -> sign-extend -> dequantize of b-bit integer codes: the
    one-point, one-leaf call of ``flip_corrupt_grid``.

    codes: int8 of any shape with `bits` (1..8) significant bits; scale: a
    float32 scalar tensor on the codes' device; p: flip probability (a
    python float); seed: an int32 (python int).  Returns f32 of
    codes.shape."""
    return flip_corrupt_grid([(codes, scale, bits)], [p], [[seed]])[0][0]

"""Wrapper of the bundle_update CUDA kernel (``csrc/bundle_update.cu``).

``bundle_update(m, c, h, lr)`` takes bundles or prototypes m (n, D),
per-example coefficients c (B, n) and queries h (B, D), all float32, and
returns the (n, D) float32 rows of m + lr * c^T h, each divided by its norm
plus 1e-12: one training minibatch step.  CPU tensors take the plain
version in ``ref.py``; CUDA tensors launch the kernel on the current stream
or raise.  The kernel is one cooperative launch with a grid barrier, so
all its blocks must be resident: ``update_geometry`` cuts (n, D) into
tiles and ``launch_blocks`` starts as many blocks as there are tiles, or
as many as the card holds at once, each then walking several tiles.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.bundle_update.ref import bundle_update_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

# the compiled kernel of csrc/bundle_update.cu: kCols columns a tile,
# kThreads threads, at most 32 bundle rows (kJ) a tile
COLS, THREADS, MAX_KJ = 64, 256, 32


@dataclass(frozen=True)
class UpdateGeometry:
    """The tiles of one call.  kj: bundle rows a tile holds (the kernel's
    template); tile t covers columns [COLS (t % col_blocks), + COLS) of
    rows [kj (t // col_blocks), + kj); partial_shape: the (n, col_blocks)
    sums of squares scratch."""
    kj: int
    col_blocks: int
    tiles: int
    threads: int
    partial_shape: tuple


@functools.lru_cache(maxsize=None)
def update_geometry(n: int, b: int, d: int) -> UpdateGeometry:
    """Tiles of ``bundle_update`` at (n, B, D), for n, D >= 1: kj is n
    rounded up to a multiple of 4, at most MAX_KJ; B changes nothing (the
    batch is walked inside each tile)."""
    kj = min(MAX_KJ, -(-n // 4) * 4)
    col_blocks = -(-d // COLS)
    return UpdateGeometry(kj=kj, col_blocks=col_blocks,
                          tiles=col_blocks * -(-n // kj), threads=THREADS,
                          partial_shape=(n, col_blocks))


def launch_blocks(geo: UpdateGeometry, capacity: int) -> int:
    """Blocks of the launch: one a tile, at most `capacity` (the kernel's
    resident blocks per SM times the SMs), which the grid barrier needs all
    resident.  Raises when the card's capacity could not be read."""
    if capacity <= 0:
        raise RuntimeError(f"bundle_update: occupancy query failed "
                           f"({capacity})")
    return min(geo.tiles, capacity)


@functools.cache
def _lib():
    lib = _build.load("bundle_update")
    lib.bundle_update_launch.argtypes = [_P, _P, _P, ctypes.c_float, _P, _P,
                                         _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.bundle_update_launch.restype = _I
    lib.bundle_update_capacity.argtypes = [_I]
    lib.bundle_update_capacity.restype = _I
    return lib


@functools.cache
def _capacity(device_index: int, kj: int) -> int:
    with torch.cuda.device(device_index):
        return _lib().bundle_update_capacity(kj)


def bundle_update(m: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                  lr) -> torch.Tensor:
    """L2-normalised scatter-add update l2n(m + lr * c^T h)."""
    if not common.on_card(m, c, h):
        return bundle_update_ref(m, c, h, lr)
    for t, name in ((m, "m"), (c, "c"), (h, "h")):
        common.require(t, name, (torch.float32,), 2)
    n, d = m.shape
    b = h.shape[0]
    if c.shape != (b, n) or h.shape[1] != d:
        raise ValueError(f"m {tuple(m.shape)}, c {tuple(c.shape)} and "
                         f"h {tuple(h.shape)} do not fit (n, D), (B, n), "
                         f"(B, D)")
    out = torch.empty_like(m)
    if n == 0 or d == 0:
        return out
    geo = update_geometry(n, b, d)
    index = m.device.index
    blocks = launch_blocks(geo, _capacity(
        torch.cuda.current_device() if index is None else index, geo.kj))
    partial = torch.empty(geo.partial_shape, dtype=torch.float32,
                          device=m.device)
    rc = _lib().bundle_update_launch(
        m.data_ptr(), c.data_ptr(), h.data_ptr(), float(lr), out.data_ptr(),
        partial.data_ptr(), b, d, n, geo.kj, geo.col_blocks, geo.tiles,
        blocks, geo.threads, common.stream_of(m))
    common.check_launch(rc, "bundle_update")
    common.launches["bundle_update"] += 1
    return out

"""Wrapper of the hdc_encode CUDA kernel (``csrc/hdc_encode.cu``).

``hdc_encode(x, proj, bias, center, kind)`` takes raw features x (B, F),
the projection proj (F, D), bias and center (D,), all float32, and returns
the (B, D) float32 encodings l2n(l2n(nonlin(x proj)) - center), as
``repro.kernels.hdc_encode.ops.hdc_encode`` does.  CPU tensors take the
plain version in ``ref.py``; CUDA tensors launch the kernel (a 3xTF32
wgmma product with the nonlinearity and per-block sums of squares in its
epilogue, then one thread-block cluster a row for both normalisations) on
the current stream or raise.  Nothing is padded: the kernel masks ragged
B, F and D.  ``encode_geometry`` computes every launch dimension from
(B, F, D); the C entry checks it against the compiled tiles.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.hdc_encode.ref import KINDS, hdc_encode_plain

_P = ctypes.c_void_p
_I = ctypes.c_int

# the compiled tiles of csrc/hdc_encode.cu (kBM, kBN, kBK, kStages,
# kThreads, its dynamic shared memory: the W ring and three parts
# buffers of two TF32 parts, kNormThreads, kNormPer, kMaxCluster)
BM, BN, BK, STAGES, THREADS = 64, 80, 32, 8, 512
SMEM_BYTES = (STAGES * BK * BN + 3 * 2 * BN * BK) * 4
NORM_THREADS, NORM_PER, MAX_CLUSTER = 256, 8, 8
# columns a normalisation block holds in registers
NORM_COLS = NORM_THREADS * NORM_PER
# normalisation blocks a launch starts; their clusters loop over the rows
NORM_MAX_BLOCKS = 4096
_GRID_Y = 65535
# rows a launch takes: row indices, up to B plus a grid's stride, are int32
MAX_ROWS = 2**31 - 1 - NORM_MAX_BLOCKS


@dataclass(frozen=True)
class EncodeGeometry:
    """The two launches of one call.  gemm_grid: (row blocks of BM rows,
    column blocks of BN columns); partial_shape: the (B, column blocks)
    sums of squares the product writes; cluster blocks of norm_threads
    threads normalise a row, block rank r owning columns [r chunk,
    (r + 1) chunk), and the norm_rows clusters of the launch take rows
    i, i + norm_rows, ....  There is no split-K: every element sums
    over all F features in one block, in order."""
    gemm_grid: tuple
    gemm_threads: int
    smem_bytes: int
    stages: int
    partial_shape: tuple
    cluster: int
    norm_rows: int
    norm_threads: int
    chunk: int


@functools.lru_cache(maxsize=None)
def encode_geometry(b: int, f: int, d: int) -> EncodeGeometry:
    """Launch geometry of ``hdc_encode`` at (B, F, D), for B, D >= 1.  Only
    the row dimensions depend on B: the column blocks, the cluster and the
    per-element order of the sum come from F and D, so a row's bits do not
    depend on the batch it is encoded in.  Raises where a grid would not
    launch."""
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows exceed the {MAX_ROWS} a launch takes; "
                         f"encode in batches (encode_batched)")
    col_blocks = -(-d // BN)
    if col_blocks > _GRID_Y:
        raise ValueError(f"D = {d} needs {col_blocks} column blocks, more "
                         f"than the {_GRID_Y} a grid takes")
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * NORM_COLS < d:
        cluster *= 2
    norm_rows = min(b, NORM_MAX_BLOCKS // cluster)
    return EncodeGeometry(
        gemm_grid=(-(-b // BM), col_blocks), gemm_threads=THREADS,
        smem_bytes=SMEM_BYTES, stages=STAGES, partial_shape=(b, col_blocks),
        cluster=cluster, norm_rows=norm_rows, norm_threads=NORM_THREADS,
        chunk=-(-d // cluster))


@functools.cache
def _fn():
    fn = _build.load("hdc_encode").hdc_encode_launch
    fn.argtypes = [_P] * 6 + [_I] * 14 + [_P]
    fn.restype = _I
    return fn


def hdc_encode(x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
               center: torch.Tensor, kind: str = "cos") -> torch.Tensor:
    """Fused encoder: (B, F), (F, D), (D,), (D,) -> (B, D) float32."""
    if kind not in KINDS:
        raise ValueError(f"unknown encoder kind: {kind}")
    if (x.ndim != 2 or proj.ndim != 2 or proj.shape[0] != x.shape[1]
            or bias.shape != proj.shape[1:] or center.shape != bias.shape):
        raise ValueError(f"x {tuple(x.shape)}, proj {tuple(proj.shape)}, "
                         f"bias {tuple(bias.shape)} and center "
                         f"{tuple(center.shape)} do not fit (B, F), (F, D), "
                         f"(D,), (D,)")
    if not common.on_card(x, proj, bias, center):
        return hdc_encode_plain(x, proj, bias, center, kind)
    common.require(x, "x", (torch.float32,), 2)
    common.require(proj, "proj", (torch.float32,), 2)
    common.require(bias, "bias", (torch.float32,), 1)
    common.require(center, "center", (torch.float32,), 1)
    b, f = x.shape
    d = proj.shape[1]
    if b == 0 or d == 0:
        return torch.empty((b, d), dtype=torch.float32, device=x.device)
    geo = encode_geometry(b, f, d)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    partial = torch.empty(geo.partial_shape, dtype=torch.float32,
                          device=x.device)
    # W lands by TMA when its rows are whole 16-byte units
    tma = int(d % 4 == 0 and proj.data_ptr() % 16 == 0)
    rc = _fn()(x.data_ptr(), proj.data_ptr(), bias.data_ptr(),
               center.data_ptr(), out.data_ptr(), partial.data_ptr(), b, f, d,
               KINDS.index(kind), tma, *geo.gemm_grid, geo.gemm_threads,
               geo.smem_bytes, geo.stages, geo.cluster, geo.norm_rows,
               geo.norm_threads, geo.chunk, common.stream_of(x))
    common.check_launch(rc, "hdc_encode")
    common.launches["hdc_encode"] += 1
    return out

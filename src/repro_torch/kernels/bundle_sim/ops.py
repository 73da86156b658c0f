"""Wrapper of the bundle_sim CUDA kernel (``csrc/bundle_sim.cu``).

``bundle_similarity(h, m)`` takes queries h (B, D) in float32 or bfloat16
and pre-normalised bundles m (n, D) in float32, and returns the (B, n)
float32 cosine similarities.  CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel on the current stream or raise.
``bundle_sim_geometry`` computes the launch from (B, D, n): a thread-block
cluster splits each row along D, and only the number of clusters grows
with B; the C entry checks it again.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.bundle_sim.ref import bundle_similarity_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

# the compiled kernel of csrc/bundle_sim.cu: kThreads threads (8 consumer
# warps, warp w on columns [32 w, 32 w + 32) of every pass, and a producer
# warp), kRows rows a tile (one MMA), kPass columns a pass, kStageBytes a
# stage of h, kMaxCluster, kMaxStages, kSmemMax (dynamic), the compiled
# bundle chunks (kC: n-tiles of the MMA's 8 bundles, and 2 bundles more in
# FMAs where kC % 8 == 2), the partial sets (kRedSets) and slot rows
# (kSlotRows) of the reduction
THREADS, ROWS, PASS = 288, 16, 256
MAX_CLUSTER, MAX_STAGES, SMEM_MAX = 8, 4, 232_448 - 128
KC_SIZES = (2, 8, 10, 16, 18, 24, 26, 32)
RED_SETS, SLOT_ROWS = 4, 2 * (ROWS + MAX_CLUSTER)
STAGE_BYTES = ROWS * PASS * 4
# clusters a launch starts when the caller gives no capacity: one block per
# SM on an H100 SXM's 132 SMs (the wrapper asks the card instead)
NUM_SMS = 132
_GRID_Y = 65535
# rows a launch takes: a row index, up to B plus a tile, is an int32
MAX_ROWS = 2**31 - 1 - ROWS


@dataclass(frozen=True)
class SimGeometry:
    """One launch.  grid: (cluster * clusters, bundle_chunks).  A cluster
    of `cluster` blocks splits every row along D, block rank r owning the
    columns [r chunk, (r + 1) chunk), walked in `passes` passes of PASS
    columns (in pass p, warp w takes the columns p PASS + 32 w + [0, 32)
    of every row of the tile).  The
    `clusters` clusters take the row tiles of ROWS rows g, g + clusters,
    ...; grid y chunk y holds the bundles [y kc, (y + 1) kc).  A block
    holds its kc x chunk slice of M and `stages` stages of h in
    `smem_bytes` of shared memory."""
    grid: tuple
    threads: int
    cluster: int
    chunk: int
    passes: int
    rows: int
    tiles: int
    clusters: int
    kc: int
    bundle_chunks: int
    stages: int
    smem_bytes: int


def smem_bytes(kc: int, chunk: int, stages: int) -> int:
    """A block's dynamic shared memory (csrc/bundle_sim.cu smem_bytes): 1 KB
    of alignment slack, M's chunk (kc rounded up to 8 rows x chunk floats),
    the stages, and the partial sums, a row's kc + 1 padded to whole
    float4s."""
    return (1024 + 4 * -(-kc // 8) * 8 * chunk + stages * STAGE_BYTES
            + 4 * (RED_SETS * ROWS + SLOT_ROWS) * ((kc + 4) // 4 * 4))


@functools.lru_cache(maxsize=None)
def bundle_sim_geometry(b: int, d: int, n: int,
                        max_clusters: Optional[int] = None) -> SimGeometry:
    """Launch geometry of ``bundle_sim`` at (B, D, n), for B, D, n >= 1,
    starting at most `max_clusters` clusters (None: NUM_SMS // cluster).

    The chunk (a multiple of PASS near D / 8), the cluster (the ranks the
    chunk needs to cover D), the bundle chunk kc (the largest that fits in
    shared memory with two stages, then evened out over the chunks of n)
    and the stages come from D and n; B sets only the row tiles and the
    clusters, so a row's sums do not depend on the batch.  Raises where the
    grid would not launch."""
    if min(b, d, n) < 1:
        raise ValueError(f"bundle_sim needs B, D, n >= 1, got {(b, d, n)}")
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows exceed the {MAX_ROWS} a launch takes")
    chunk = -(-(-(-d // MAX_CLUSTER)) // PASS) * PASS
    cluster = -(-d // chunk)
    fit = [kc for kc in KC_SIZES if smem_bytes(kc, chunk, 2) <= SMEM_MAX]
    if not fit:
        raise ValueError(f"D = {d} needs a chunk of {chunk} columns, more "
                         f"than a block's shared memory holds for "
                         f"{KC_SIZES[0]} bundles")
    bundle_chunks = -(-n // fit[-1])
    if bundle_chunks > _GRID_Y:
        raise ValueError(f"n = {n} needs {bundle_chunks} bundle chunks, "
                         f"more than the {_GRID_Y} a grid takes")
    kc = min(k for k in KC_SIZES if k >= -(-n // bundle_chunks))
    stages = min(MAX_STAGES,
                 (SMEM_MAX - smem_bytes(kc, chunk, 0)) // STAGE_BYTES)
    cap = NUM_SMS // cluster if max_clusters is None else max_clusters
    if cap < 1:
        raise RuntimeError(f"bundle_sim: the card holds {cap} clusters of "
                           f"{cluster} blocks")
    tiles = -(-b // ROWS)
    clusters = min(tiles, cap)
    return SimGeometry(
        grid=(cluster * clusters, bundle_chunks), threads=THREADS,
        cluster=cluster, chunk=chunk, passes=chunk // PASS, rows=ROWS,
        tiles=tiles, clusters=clusters, kc=kc, bundle_chunks=bundle_chunks,
        stages=stages, smem_bytes=smem_bytes(kc, chunk, stages))


@functools.cache
def _lib():
    lib = _build.load("bundle_sim")
    lib.bundle_sim_launch.argtypes = [_P, _P, _P] + [_I] * 12 + [_P]
    lib.bundle_sim_launch.restype = _I
    lib.bundle_sim_capacity.argtypes = [_I] * 4
    lib.bundle_sim_capacity.restype = _I
    return lib


@functools.cache
def _capacity(device_index: int, kc: int, bf16: bool, cluster: int,
              smem: int) -> int:
    """Clusters of this launch the card holds at once."""
    with torch.cuda.device(device_index):
        return _lib().bundle_sim_capacity(kc, int(bf16), cluster, smem)


@functools.lru_cache(maxsize=None)
def _launch_args(device_index: int, b: int, d: int, n: int,
                 bf16: bool) -> tuple:
    """The geometry arguments of the C entry at (B, D, n) on this device:
    the clusters are capped at what the card holds at once."""
    base = bundle_sim_geometry(1, d, n)
    cap = _capacity(device_index, base.kc, bf16, base.cluster,
                    base.smem_bytes)
    if cap < 1:
        raise RuntimeError(f"bundle_sim: occupancy query failed ({cap})")
    geo = bundle_sim_geometry(b, d, n, cap)
    return (geo.kc, geo.chunk, geo.cluster, geo.clusters, geo.bundle_chunks,
            geo.tiles, geo.stages, geo.smem_bytes)


def bundle_similarity(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Cosine similarities of queries against pre-normalised bundles."""
    if not common.on_card(h, m):
        return bundle_similarity_ref(h, m)
    common.require(h, "h", (torch.float32, torch.bfloat16), 2)
    common.require(m, "m", (torch.float32,), 2)
    b, d = h.shape
    n = m.shape[0]
    if m.shape[1] != d:
        raise ValueError(f"h {tuple(h.shape)} and m {tuple(m.shape)} differ in D")
    out = torch.empty((b, n), dtype=torch.float32, device=h.device)
    if b == 0 or n == 0:
        return out
    bf16 = h.dtype == torch.bfloat16
    index = h.device.index
    args = _launch_args(torch.cuda.current_device() if index is None
                        else index, b, d, n, bf16)
    rc = _lib().bundle_sim_launch(h.data_ptr(), m.data_ptr(), out.data_ptr(),
                                  b, d, n, int(bf16), *args,
                                  common.stream_of(h))
    common.check_launch(rc, "bundle_sim")
    common.launches["bundle_sim"] += 1
    return out

"""Launch geometry of the nearest-profile score stage (``csrc/score_stage.cuh``).

The score stage computes 2 <A_b, P_c> - ||P_c||^2 - ||A_b||^2 for
activations A (B, n) and profiles P (C, n).  It is the whole of
``profile_decode`` and the second launch of ``loghd_head``; both wrappers
build their launch from ``score_geometry``, and the C entries check it again
(``score::valid``).

A block is 8 warps; a warp covers WARP_V = 32 profiles (four MMA n-tiles of
8) and walks row tiles of TILE_ROWS = 16 rows.  The warps are ``wc`` warp
columns (fitted to C) by ``wr = 8 // wc`` warp rows; a block covers
``vb = 32 wc`` profiles and ``rows = 16 wr t`` rows (``t`` row tiles a
warp).  The k-steps of 8 (``ks``)
and the chunks of n follow from n alone, so a row's sums do not depend on B
or on the rest of the geometry.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

# the compiled constants of csrc/score_stage.cuh: kThreads, kWarps, kWarpV,
# kTileRows, kMaxWarpTiles, kStagePitch, kHoldSteps, kChunkSteps, kSmemMax
# and the compiled k-steps (SCORE_STEPS)
THREADS, WARPS, WARP_V, TILE_ROWS = 256, 8, 32, 16
MAX_WARP_TILES = 8
STAGE_PITCH = WARP_V + 4
HOLD_STEPS, CHUNK_STEPS = 4, 8
KS_SIZES = (2, 3, 4, 8)
SMEM_MAX = 232_448 - 1024
# blocks the card holds at once when the caller gives no capacity: two
# blocks on each of an H100 SXM's 132 SMs (the wrappers ask the card)
NUM_SMS, BLOCKS_PER_SM = 132, 2
# a warp takes more row tiles only while the grid keeps this many times the
# blocks the card holds at once (at 512 rows of the LM head with bf16
# profiles, 396 blocks at once, on an H100: 4 row tiles a warp took
# 126.6 us, 8 took 129.4, 2 took 133.3)
WAVES = 8
GRID_Y = 65535
# rows a launch takes: row indices, up to the last block's end, are int32
MAX_ROWS = 2**31 - 1 - 2 * TILE_ROWS * MAX_WARP_TILES


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def steps_for(n: int) -> int:
    """k-steps of 8 in a chunk of n (score::steps_for): the smallest of 2,
    3, 4 that holds n, else chunks of CHUNK_STEPS."""
    return next((k for k in KS_SIZES[:-1] if 8 * k >= n), CHUNK_STEPS)


def rows_held(rows: int, b: int) -> int:
    """Rows of A a block holds (score::rows_held): its rows, or B rounded up
    to a tile if fewer."""
    return min(rows, _cdiv(b, TILE_ROWS) * TILE_ROWS)


def smem_bytes(vb: int, n: int, p_esize: int, held: int,
               a_esize: int) -> int:
    """A block's dynamic shared memory (score::smem_bytes): P's span and the
    `held` rows of A, each rounded up to 16 bytes, and a staging tile of
    TILE_ROWS x STAGE_PITCH floats a warp."""
    return (-(-vb * n * p_esize // 16) * 16 + -(-held * n * a_esize // 16) * 16
            + 4 * WARPS * TILE_ROWS * STAGE_PITCH)


@dataclass(frozen=True)
class ScoreGeometry:
    """One launch of the score stage: grid (row_blocks, v_blocks) of
    `threads`; block (x, y) covers rows [x rows, (x + 1) rows) and profiles
    [y vb, (y + 1) vb).  Warp w is warp column w % wc and warp row w // wc:
    it covers profiles (w % wc) 32 + [0, 32) of the block's span and the row
    tiles w // wc, w // wc + wr, ... (< wr t) of the block's rows.  n is
    zero-padded to n_pad = 8 ks chunks."""
    grid: tuple
    threads: int
    ks: int
    chunks: int
    n_pad: int
    wc: int
    wr: int
    t: int
    rows: int
    vb: int
    smem_bytes: int

    def launch_args(self) -> tuple:
        """The geometry arguments of the C entries, in their order."""
        return (self.ks, self.chunks, self.wc, self.t, *self.grid,
                self.smem_bytes)


@functools.lru_cache(maxsize=None)
def score_geometry(b: int, c: int, n: int, a_esize: int, p_esize: int,
                   capacity: Optional[int] = None) -> ScoreGeometry:
    """Launch geometry of the score stage at (B, C, n) with A and P elements
    of `a_esize` and `p_esize` bytes (4 or 2), for a card that holds
    `capacity` blocks at once (None: NUM_SMS x BLOCKS_PER_SM).

    ks and the chunks come from n; wc is the smallest power of two up to 8
    whose 32 wc profiles hold C (smaller where a span of P does not fit in
    shared memory); t doubles (up to 8 / wr) while the grid keeps WAVES x
    `capacity` blocks.  Raises where a launch cannot run."""
    if min(b, c, n) < 1:
        raise ValueError(f"the score stage needs B, C, n >= 1, got "
                         f"{(b, c, n)}")
    if a_esize not in (2, 4) or p_esize not in (2, 4):
        raise ValueError(f"elements of {a_esize} and {p_esize} bytes: "
                         f"float32 or bfloat16")
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows exceed the {MAX_ROWS} a launch takes")
    cap = NUM_SMS * BLOCKS_PER_SM if capacity is None else capacity
    if cap < 1:
        raise RuntimeError(f"score stage: the card holds {cap} blocks")
    ks = steps_for(n)
    chunks = _cdiv(n, 8 * ks)
    n_pad = 8 * ks * chunks
    tiles = _cdiv(b, TILE_ROWS)
    top = 1
    while top < WARPS and WARP_V * top < c:
        top *= 2
    # fewer warp columns where a span of n-wide profiles does not fit
    for e in range(top.bit_length() - 1, -1, -1):
        wc = 1 << e
        wr = WARPS // wc
        v_blocks = _cdiv(c, WARP_V * wc)
        t = 1
        while (2 * t * wr <= MAX_WARP_TILES and t * wr < tiles
               and v_blocks * _cdiv(tiles, 2 * t * wr) >= WAVES * cap):
            t *= 2
        rows = TILE_ROWS * wr * t
        row_blocks = _cdiv(b, rows)
        vb = WARP_V * wc
        smem = smem_bytes(vb, n, p_esize, rows_held(rows, b), a_esize)
        if smem <= SMEM_MAX:
            break
    else:
        raise ValueError(f"n = {n} needs {smem} bytes of shared memory for "
                         f"one block, more than the {SMEM_MAX} it has")
    v_blocks = _cdiv(c, vb)
    if v_blocks > GRID_Y:
        raise ValueError(f"C = {c} needs {v_blocks} blocks of {vb} profiles, "
                         f"more than the {GRID_Y} a grid takes")
    return ScoreGeometry(
        grid=(row_blocks, v_blocks), threads=THREADS, ks=ks, chunks=chunks,
        n_pad=n_pad, wc=wc, wr=wr, t=t, rows=rows, vb=vb,
        smem_bytes=smem)

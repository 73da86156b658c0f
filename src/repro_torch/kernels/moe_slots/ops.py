"""Wrapper of the moe_slots CUDA kernel (``csrc/moe_slots.cu``).

``moe_slots(flat_experts, n_experts, cap)`` takes the (N,) int64 expert ids
of the token-major flattened MoE choices and returns ``(slots, keep)``:
``slot[i]`` counts the choices j < i with the same expert, ``keep = slot <
cap``, and ``slots = where(keep, slot, cap - 1)``, (N,) int64 and (N,)
bool.  CPU and meta tensors take the plain version in ``ref.py`` (the
one-hot and its cumsum); CUDA tensors launch the kernel on the current
stream or raise.  The kernel is two launches over tiles of ``TILE``
choices, one tile a block up to ``MAX_BLOCKS`` blocks and more tiles a
block beyond, with a (blocks, E) int32 scratch of per-block expert counts
between them, the second launched as a programmatic dependent of the
first (``common.pdl``); it takes up to ``MAX_EXPERTS`` experts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.moe_slots.ref import moe_slots_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# the compiled kernel of csrc/moe_slots.cu: choices a tile, at most this
# many blocks and experts
TILE, MAX_BLOCKS, MAX_EXPERTS = 2048, 256, 256


def moe_slots_blocks(n: int) -> int:
    """Blocks of a call over n choices: one a tile of TILE, and where the
    tiles outnumber MAX_BLOCKS, an equal run of tiles a block."""
    tiles = -(-n // TILE)
    if tiles == 0:
        return 0
    per = -(-tiles // MAX_BLOCKS)
    return -(-tiles // per)


@functools.cache
def _lib():
    lib = _build.load("moe_slots")
    lib.moe_slots_launch.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P]
    lib.moe_slots_launch.restype = _I
    return lib


def moe_slots(flat_experts: torch.Tensor, n_experts: int, cap: int):
    """(slots (N,) int64, keep (N,) bool) of the (N,) int64 expert ids."""
    if flat_experts.is_meta or not common.on_card(flat_experts):
        # the dry run's meta tensors hold no data: the plain expression
        # gives the shapes
        return moe_slots_ref(flat_experts, n_experts, cap)
    common.require(flat_experts, "flat_experts", (torch.int64,), 1)
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_slots takes 1 to {MAX_EXPERTS} experts, "
                         f"not {n_experts}")
    if cap < 1:
        raise ValueError(f"moe_slots: capacity {cap} < 1")
    n = flat_experts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"moe_slots: {n} choices, at most 2^31 - 1")
    slots = torch.empty_like(flat_experts)
    keep = torch.empty(n, dtype=torch.bool, device=flat_experts.device)
    if n == 0:
        return slots, keep
    blocks = moe_slots_blocks(n)
    counts = torch.empty((blocks, n_experts), dtype=torch.int32,
                         device=flat_experts.device)
    rc = _lib().moe_slots_launch(
        flat_experts.data_ptr(), slots.data_ptr(), keep.data_ptr(),
        counts.data_ptr(), n, n_experts, cap, blocks,
        int(common.pdl_enabled()), common.stream_of(flat_experts))
    common.check_launch(rc, "moe_slots")
    common.launches["moe_slots"] += 1
    return slots, keep

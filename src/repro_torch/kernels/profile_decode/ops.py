"""Wrapper of the profile_decode CUDA kernel (``csrc/profile_decode.cu``).

``profile_decode_scores(acts, profiles)`` takes activations (B, n) and
profiles (C, n), both float32 or both bfloat16, and returns the (B, C)
float32 scores -||A_b - P_c||^2 in the expanded form
2 A.P - ||P||^2 - ||A||^2.  CPU tensors take the plain version in ``ref.py``;
CUDA tensors launch the kernel on the current stream or raise.  The argmax
over C stays outside, as in the JAX package.

``profile_decode_geometry`` computes the launch (the score stage of
``kernels/score_stage.py``); n may be as large as one block's shared memory
holds (several hundred at the classifier's row counts).  With ``pdl=True``
the kernel is launched as a programmatic dependent of the kernel before it
on the stream: its launch and its read of the profiles run under that
kernel's tail.  The caller asks for it only where that kernel does not write
``profiles`` (the predict path: ``bundle_sim``, which writes ``acts``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common, score_stage
from repro_torch.kernels.profile_decode.ref import profile_decode_scores_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


def profile_decode_geometry(b: int, n: int, c: int, bf16: bool = False,
                            capacity=None) -> score_stage.ScoreGeometry:
    """Launch geometry at (B, n, C) for float32 (or bfloat16) activations
    and profiles, on a card that holds `capacity` blocks at once (None: the
    H100 default of ``score_stage``)."""
    esize = 2 if bf16 else 4
    return score_stage.score_geometry(b, c, n, esize, esize, capacity)


@functools.cache
def _lib():
    lib = _build.load("profile_decode")
    lib.profile_decode_launch.argtypes = [_P, _P, _P] + [_I] * 12 + [_P]
    lib.profile_decode_launch.restype = _I
    lib.profile_decode_capacity.argtypes = [_I] * 3
    lib.profile_decode_capacity.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _launch_args(device_index: int, b: int, n: int, c: int,
                 bf16: bool) -> tuple:
    """The geometry arguments of the C entry at (B, n, C) on this device,
    with the blocks the card holds at once of the kernel this n compiles."""
    base = profile_decode_geometry(1, n, c, bf16)
    with torch.cuda.device(device_index):
        cap = _lib().profile_decode_capacity(base.ks, int(bf16),
                                             base.smem_bytes)
    if cap < 1:
        raise RuntimeError(f"profile_decode: occupancy query failed ({cap})")
    return profile_decode_geometry(b, n, c, bf16, cap).launch_args()


def profile_decode_scores(acts: torch.Tensor, profiles: torch.Tensor,
                          pdl: bool = False) -> torch.Tensor:
    """-||A - P_c||^2 decode scores.  acts (B, n), profiles (C, n) -> (B, C).

    pdl: launch as a programmatic dependent of the kernel launched just
    before on the stream, which must not write `profiles` (ignored on the
    CPU, and while ``common.pdl`` is off)."""
    if not common.on_card(acts, profiles):
        return profile_decode_scores_ref(acts, profiles)
    common.require(acts, "acts", _DTYPES, 2)
    common.require(profiles, "profiles", _DTYPES, 2)
    if acts.dtype != profiles.dtype:
        raise TypeError(f"acts {acts.dtype} and profiles {profiles.dtype} differ")
    b, n = acts.shape
    c = profiles.shape[0]
    if profiles.shape[1] != n:
        raise ValueError(f"acts {tuple(acts.shape)} and profiles "
                         f"{tuple(profiles.shape)} differ in n")
    out = torch.empty((b, c), dtype=torch.float32, device=acts.device)
    if b == 0 or c == 0:
        return out
    if n == 0:
        return out.zero_()
    bf16 = acts.dtype == torch.bfloat16
    index = acts.device.index
    args = _launch_args(torch.cuda.current_device() if index is None
                        else index, b, n, c, bf16)
    rc = _lib().profile_decode_launch(
        acts.data_ptr(), profiles.data_ptr(), out.data_ptr(), b, c, n,
        int(bf16), *args, int(pdl and common.pdl_enabled()),
        common.stream_of(acts))
    common.check_launch(rc, "profile_decode")
    common.launches["profile_decode"] += 1
    return out

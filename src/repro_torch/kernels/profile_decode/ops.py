"""Wrapper of the profile_decode CUDA kernel (``csrc/profile_decode.cu``).

``profile_decode_scores(acts, profiles)`` takes activations (B, n) and
profiles (C, n), both float32 or both bfloat16, and returns the (B, C)
float32 scores -||A_b - P_c||^2 in the expanded form
2 A.P - ||P||^2 - ||A||^2.  CPU tensors take the plain version in ``ref.py``;
CUDA tensors launch the kernel on the current stream or raise.  The argmax
over C stays outside, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.profile_decode.ref import profile_decode_scores_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    fn = _build.load("profile_decode").profile_decode_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def profile_decode_scores(acts: torch.Tensor,
                          profiles: torch.Tensor) -> torch.Tensor:
    """-||A - P_c||^2 decode scores.  acts (B, n), profiles (C, n) -> (B, C)."""
    if not common.on_card(acts, profiles):
        return profile_decode_scores_ref(acts, profiles)
    dtypes = (torch.float32, torch.bfloat16)
    common.require(acts, "acts", dtypes, 2)
    common.require(profiles, "profiles", dtypes, 2)
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
    rc = _fn()(acts.data_ptr(), profiles.data_ptr(), out.data_ptr(), b, c, n,
               int(acts.dtype == torch.bfloat16), common.stream_of(acts))
    common.check_launch(rc, "profile_decode")
    common.launches["profile_decode"] += 1
    return out

"""Wrapper of the bundle_sim CUDA kernel (``csrc/bundle_sim.cu``).

``bundle_similarity(h, m)`` takes queries h (B, D) in float32 or bfloat16
and pre-normalised bundles m (n, D) in float32, and returns the (B, n)
float32 cosine similarities.  CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel on the current stream or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.bundle_sim.ref import bundle_similarity_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    fn = _build.load("bundle_sim").bundle_sim_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


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
    rc = _fn()(h.data_ptr(), m.data_ptr(), out.data_ptr(), b, d, n,
               int(h.dtype == torch.bfloat16), common.stream_of(h))
    common.check_launch(rc, "bundle_sim")
    common.launches["bundle_sim"] += 1
    return out

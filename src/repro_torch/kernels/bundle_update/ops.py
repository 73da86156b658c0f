"""Wrapper of the bundle_update CUDA kernel (``csrc/bundle_update.cu``).

``bundle_update(m, c, h, lr)`` takes bundles or prototypes m (n, D),
per-example coefficients c (B, n) and queries h (B, D), all float32, and
returns the (n, D) float32 rows of m + lr * c^T h, each divided by its norm
plus 1e-12: one training minibatch step.  CPU tensors take the plain
version in ``ref.py``; CUDA tensors launch the kernel on the current stream
or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.bundle_update.ref import bundle_update_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("bundle_update")
    lib.bundle_update_launch.argtypes = [_P, _P, _P, ctypes.c_float, _P, _P,
                                         _I, _I, _I, _P]
    lib.bundle_update_launch.restype = _I
    lib.bundle_update_parts.argtypes = [_I]
    lib.bundle_update_parts.restype = _I
    return lib


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
    lib = _lib()
    partial = torch.empty((n, lib.bundle_update_parts(d)),
                          dtype=torch.float32, device=m.device)
    rc = lib.bundle_update_launch(m.data_ptr(), c.data_ptr(), h.data_ptr(),
                                  float(lr), out.data_ptr(),
                                  partial.data_ptr(), b, d, n,
                                  common.stream_of(m))
    common.check_launch(rc, "bundle_update")
    common.launches["bundle_update"] += 1
    return out

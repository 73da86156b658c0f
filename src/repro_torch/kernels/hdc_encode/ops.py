"""Wrapper of the hdc_encode CUDA kernel (``csrc/hdc_encode.cu``).

``hdc_encode(x, proj, bias, center, kind)`` takes raw features x (B, F),
the projection proj (F, D), bias and center (D,), all float32, and returns
the (B, D) float32 encodings l2n(l2n(nonlin(x proj)) - center), as
``repro.kernels.hdc_encode.ops.hdc_encode`` does.  CPU tensors take the
plain version in ``ref.py``; CUDA tensors launch the kernel (the product,
the nonlinearity and both row normalisations) on the current stream or
raise.  Nothing is padded: the kernel masks ragged B, F and D.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.hdc_encode.ref import KINDS, hdc_encode_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
# rows a launch takes: the product's grid has one row of blocks per 32 rows
MAX_ROWS = 65535 * 32


@functools.cache
def _fn():
    fn = _build.load("hdc_encode").hdc_encode_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
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
    if b > MAX_ROWS:
        raise ValueError(f"{b} rows exceed the {MAX_ROWS} a launch takes; "
                         f"encode in batches (encode_batched)")
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b == 0 or d == 0:
        return out
    rc = _fn()(x.data_ptr(), proj.data_ptr(), bias.data_ptr(),
               center.data_ptr(), out.data_ptr(), b, f, d, KINDS.index(kind),
               common.stream_of(x))
    common.check_launch(rc, "hdc_encode")
    common.launches["hdc_encode"] += 1
    return out

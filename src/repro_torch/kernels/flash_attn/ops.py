"""Wrapper of the flash_attn CUDA kernels (``csrc/flash_attn.cu``).

``flash_attn(q, k, v, scale, causal=, q0=)`` is causal (or full) attention
over q (B, S, H, d), k (B, T, KVH, d), v (B, T, KVH, dv), returning (B, S,
H * dv): query i sees key j iff j < T and, when causal, j <= q0 + i; query
head h reads KV head h // (H // KVH).  It is a ``torch.autograd.Function``
whose forward saves the float32 log-sum-exp and whose backward is a kernel
too.  CPU tensors take the plain version in ``ref.py`` (forward and
backward alike, so the CPU tests reach the Function); CUDA tensors launch
the kernels on the current stream or raise.  ``takes`` is the rule by
which ``models.attention._sdpa`` sends a call here: CUDA bf16 tensors
whose (d, dv) is one of the compiled ``PAIRS``.

The kernels read q, k, v and dO through TMA tensor maps, so each needs its
last dimension contiguous, its other strides multiples of 8 elements and
a 16-byte aligned pointer; a tensor that is not so is copied first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.flash_attn.ref import (flash_attn_bwd_ref,
                                                flash_attn_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# the (d, dv) widths compiled in csrc/flash_attn.cu: granite and the GQA
# configs at 64, qwen3 / jamba / mistral at 128, MLA's 192 / 128
PAIRS = ((64, 64), (128, 128), (192, 128))
TILE = 128   # the forward's query rows a block; lse rows padded to it


def takes(q, k, v) -> bool:
    """True when ``_sdpa`` should call the kernel: CUDA tensors, all bf16,
    whose widths are a compiled pair."""
    return (q.device.type == "cuda" and common.kernel_device(q.device)
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and (q.shape[-1], v.shape[-1]) in PAIRS)


@functools.cache
def _lib():
    lib = _build.load("flash_attn")
    lib.flash_attn_fwd.argtypes = ([_P] * 5 + [_I] * 7 + [_L] * 9
                                   + [_I, _I, _F, _I, _P])
    lib.flash_attn_fwd.restype = _I
    lib.flash_attn_bwd.argtypes = ([_P] * 10 + [_I] * 7 + [_L] * 12
                                   + [_I, _I, _F, _I, _P])
    lib.flash_attn_bwd.restype = _I
    return lib


def _mapped(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where a TMA tensor map can read it, else a copy."""
    ok = (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _strides(t: torch.Tensor) -> list:
    return list(t.stride()[:3])


def s_pad(s: int) -> int:
    return -(-s // TILE) * TILE


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.ndim != 4:
            raise TypeError(f"flash_attn: {name} must be 4-D bf16, got "
                            f"{t.dtype} {tuple(t.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d
            or h % k.shape[2]):
        raise ValueError(f"flash_attn: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (d, v.shape[3]) not in PAIRS:
        raise ValueError(f"flash_attn: widths {(d, v.shape[3])} not in "
                         f"{PAIRS}")


def _fwd(q, k, v, scale: float, causal: bool, q0: int):
    if not common.on_card(q, k, v):
        o, lse = flash_attn_ref(q, k, v, scale, causal=causal, q0=q0)
        return o.to(v.dtype), lse
    _check(q, k, v)
    q, k, v = _mapped(q), _mapped(k), _mapped(v)
    b, s, h, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((b, s, h * dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_pad(s)), dtype=torch.float32, device=q.device)
    rc = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s, t, h, kvh, d, dv, *_strides(q), *_strides(k),
        *_strides(v), q0, int(causal), scale, s_pad(s), common.stream_of(q))
    common.check_launch(rc, "flash_attn_fwd")
    common.launches["flash_attn_fwd"] += 1
    return o, lse


def _bwd(do, q, k, v, o, lse, scale: float, causal: bool, q0: int):
    if not common.on_card(do, q, k, v):
        grads = flash_attn_bwd_ref(do, q, k, v, o, lse, scale,
                                   causal=causal, q0=q0)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
    q, k, v = _mapped(q), _mapped(k), _mapped(v)
    b, s, h, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    do = _mapped(do.to(q.dtype).reshape(b, s, h, dv))
    dev = q.device
    delta = torch.empty((b, h, s_pad(s)), dtype=torch.float32, device=dev)
    dq = torch.zeros((b, s, h, d), dtype=torch.float32, device=dev)
    dk = torch.empty((b, t, kvh, d), dtype=q.dtype, device=dev)
    dvv = torch.empty((b, t, kvh, dv), dtype=q.dtype, device=dev)
    rc = _lib().flash_attn_bwd(
        do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), b, s, t, h, kvh, d, dv,
        *_strides(do), *_strides(q), *_strides(k), *_strides(v), q0,
        int(causal), scale, s_pad(s), common.stream_of(q))
    common.check_launch(rc, "flash_attn_bwd")
    common.launches["flash_attn_bwd"] += 1
    return dq.to(q.dtype), dk, dvv


class FlashAttn(torch.autograd.Function):
    """o = flash_attn(q, k, v); the backward recomputes the probabilities
    from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q0):
        o, lse = _fwd(q, k, v, scale, causal, q0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, q0)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(do, q, k, v, o, lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attn(q, k, v, scale: float, *, causal: bool = True,
               q0: int = 0) -> torch.Tensor:
    """(B, S, H * dv) attention of q over k, v (module docstring)."""
    return FlashAttn.apply(q, k, v, float(scale), bool(causal), int(q0))

"""Wrapper of the loghd_head CUDA kernel (``csrc/loghd_head.cu``).

``loghd_head_logits(h, m, p)`` takes hidden states h (B, D) and bundles
m (n, D), each float32 or bfloat16, and vocab profiles p (V, n) in float32
or bfloat16, and returns the (B, V) float32 logits -||h m^T - p_v||^2 of
the LogHD vocab head.  CPU tensors take the plain version in ``ref.py``;
CUDA tensors launch the kernel (two launches, counted as one) on the
current stream or raise.  Both routes check the same arguments.

Both routes widen every input to float32 before any arithmetic.  The
kernel reads bf16 profiles as stored and widens them in registers, which is
exact, so it gives the same logits as the JAX dispatch's cast of the
profiles to float32 (``repro.api.dispatch.loghd_head_scores``) without
materialising that cast; ``chip_smoke.py`` compares both forms on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.loghd_head.ref import loghd_head_logits_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 64                  # bundles the kernel holds (kMaxN in the source)
_ROWS_PER_BLOCK = 64        # the kernel's grid-y rows (kRowsPerBlock)


@functools.cache
def _fn():
    fn = _build.load("loghd_head").loghd_head_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(h: torch.Tensor, m: torch.Tensor, p: torch.Tensor) -> None:
    for t, name in ((h, "h"), (m, "m"), (p, "p")):
        common.require(t, name, _DTYPES, 2)
    (b, d), (n, d2), (v, n2) = h.shape, m.shape, p.shape
    if d != d2 or n != n2:
        raise ValueError(f"h {tuple(h.shape)}, m {tuple(m.shape)} and "
                         f"p {tuple(p.shape)} do not fit (B, D), (n, D), "
                         f"(V, n)")
    if d == 0:
        raise ValueError("loghd_head needs D > 0")
    if not 0 < n <= MAX_N:
        raise ValueError(f"loghd_head takes 1 to {MAX_N} bundles, not {n}")
    if -(-b // _ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"loghd_head takes at most {65535 * _ROWS_PER_BLOCK} "
                         f"rows, not {b}")


def loghd_head_logits(h: torch.Tensor, m: torch.Tensor,
                      p: torch.Tensor) -> torch.Tensor:
    """Fused LogHD vocab head: (B, D), (n, D), (V, n) -> (B, V) float32."""
    _check(h, m, p)
    if not common.on_card(h, m, p):
        return loghd_head_logits_ref(h, m, p)
    (b, d), n, v = h.shape, m.shape[0], p.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=h.device)
    if b == 0 or v == 0:
        return out
    a = torch.empty((b, n), dtype=torch.float32, device=h.device)
    bf = [int(t.dtype == torch.bfloat16) for t in (h, m, p)]
    rc = _fn()(h.data_ptr(), m.data_ptr(), p.data_ptr(), a.data_ptr(),
               out.data_ptr(), b, d, n, v, *bf, common.stream_of(h))
    common.check_launch(rc, "loghd_head")
    common.launches["loghd_head"] += 1
    return out

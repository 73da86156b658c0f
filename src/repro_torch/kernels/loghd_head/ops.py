"""Wrapper of the loghd_head CUDA kernel (``csrc/loghd_head.cu``).

``loghd_head_logits(h, m, p)`` takes hidden states h (B, D) and bundles
m (n, D), each float32 or bfloat16, and vocab profiles p (V, n) in float32
or bfloat16, and returns the (B, V) float32 logits -||h m^T - p_v||^2 of
the LogHD vocab head.  CPU tensors take the plain version in ``ref.py``;
CUDA tensors launch the kernel (the A stage, then the score stage as its
programmatic dependent; counted as one launch) on the current stream or
raise.  Both routes check the same arguments.  ``loghd_head_geometry``
computes the launch from (B, D, n, V); the C entry checks it again.

Both routes widen every input to float32 before any arithmetic.  The
kernel reads bf16 profiles as stored and widens them in registers, which is
exact, so it gives the same logits as the JAX dispatch's cast of the
profiles to float32 (``repro.api.dispatch.loghd_head_scores``) without
materialising that cast; ``chip_smoke.py`` compares both forms on the card.
The (B, n) activations A live in the same allocation as the logits, behind
them: one ``torch.empty`` a call.

Training: ``loghd_head_autograd`` is the same call made differentiable, a
``torch.autograd.Function`` whose forward is this wrapper (one launch on
the card) and whose backward is float32 torch ops on the A that the
forward kept.  The JAX package has no backward kernel: ``jax.grad``
differentiates the jnp expansion around the Pallas call, so the products
of the backward are ``torch.matmul`` here as they are XLA's there.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build, common, score_stage
from repro_torch.kernels.loghd_head.ref import loghd_head_parts_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 64                  # bundles the kernel holds (kMaxN in the source)
ACT_THREADS = 256           # threads of an A-stage block (kActThreads)
# from ACT_ROWS_MIN rows (kActRowsMin) an A-stage block takes ACT_TILE rows
# x ACT_TILE bundles, below it one row and one bundle
ACT_ROWS_MIN, ACT_TILE = 64, 4


@dataclass(frozen=True)
class HeadGeometry:
    """One call: the A stage's grid of `act_threads`-thread blocks, each
    `act_tile` rows x `act_tile` bundles, writing `scratch` float32 values
    of A; then the score stage over V profiles
    (``score_stage.ScoreGeometry``)."""
    act_grid: tuple
    act_threads: int
    act_tile: int
    scratch: int
    score: score_stage.ScoreGeometry


@functools.lru_cache(maxsize=None)
def loghd_head_geometry(b: int, d: int, n: int, v: int, p_bf16: bool = True,
                        capacity: Optional[int] = None) -> HeadGeometry:
    """Launch geometry at (B, D, n, V) with bf16 (or float32) profiles, on a
    card that holds `capacity` score-stage blocks at once (None: the H100
    default of ``score_stage``).  Raises where a launch cannot run."""
    if min(b, d, n, v) < 1:
        raise ValueError(f"loghd_head needs B, D, n, V >= 1, got "
                         f"{(b, d, n, v)}")
    if n > MAX_N:
        raise ValueError(f"loghd_head takes 1 to {MAX_N} bundles, not {n}")
    score = score_stage.score_geometry(b, v, n, 4, 2 if p_bf16 else 4,
                                       capacity)
    tile = 1 if b < ACT_ROWS_MIN else ACT_TILE
    return HeadGeometry(act_grid=(-(-b // tile), -(-n // tile)),
                        act_threads=ACT_THREADS, act_tile=tile,
                        scratch=b * n, score=score)


@functools.cache
def _lib():
    lib = _build.load("loghd_head")
    lib.loghd_head_launch.argtypes = [_P] * 5 + [_I] * 15 + [_P]
    lib.loghd_head_launch.restype = _I
    lib.loghd_head_capacity.argtypes = [_I] * 3
    lib.loghd_head_capacity.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _launch_args(device_index: int, b: int, d: int, n: int, v: int,
                 p_bf16: bool) -> tuple:
    """The score stage's geometry arguments of the C entry on this device,
    with the blocks the card holds at once of the kernel this n compiles."""
    base = loghd_head_geometry(1, d, n, v, p_bf16).score
    with torch.cuda.device(device_index):
        cap = _lib().loghd_head_capacity(base.ks, int(p_bf16),
                                         base.smem_bytes)
    if cap < 1:
        raise RuntimeError(f"loghd_head: occupancy query failed ({cap})")
    return loghd_head_geometry(b, d, n, v, p_bf16, cap).score.launch_args()


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
    if b > score_stage.MAX_ROWS:
        raise ValueError(f"loghd_head takes at most {score_stage.MAX_ROWS} "
                         f"rows, not {b}")


def _head(h: torch.Tensor, m: torch.Tensor, p: torch.Tensor) -> tuple:
    """(logits (B, V), A (B, n)), both float32: the kernel for CUDA
    tensors, the plain version for CPU tensors.  On the card A is the
    kernel's own scratch, a view behind the logits in one buffer."""
    _check(h, m, p)
    if not common.on_card(h, m, p):
        return loghd_head_parts_ref(h, m, p)
    (b, d), n, v = h.shape, m.shape[0], p.shape[0]
    if b == 0 or v == 0:
        return (torch.empty((b, v), dtype=torch.float32, device=h.device),
                torch.zeros((b, n), dtype=torch.float32, device=h.device))
    p_bf16 = p.dtype == torch.bfloat16
    index = h.device.index
    args = _launch_args(torch.cuda.current_device() if index is None
                        else index, b, d, n, v, p_bf16)
    buf = torch.empty(b * v + b * n, dtype=torch.float32, device=h.device)
    out = buf[:b * v].view(b, v)
    acts = buf[b * v:].view(b, n)
    rc = _lib().loghd_head_launch(
        h.data_ptr(), m.data_ptr(), p.data_ptr(), acts.data_ptr(),
        out.data_ptr(), b, d, n, v, int(h.dtype == torch.bfloat16),
        int(m.dtype == torch.bfloat16), int(p_bf16), *args,
        int(common.pdl_enabled()), common.stream_of(h))
    common.check_launch(rc, "loghd_head")
    common.launches["loghd_head"] += 1
    return out, acts


def loghd_head_logits(h: torch.Tensor, m: torch.Tensor,
                      p: torch.Tensor) -> torch.Tensor:
    """Fused LogHD vocab head: (B, D), (n, D), (V, n) -> (B, V) float32."""
    return _head(h, m, p)[0]


class _HeadFn(torch.autograd.Function):
    """The head with its gradient.  With g = dL/dlogits (B, V) and the
    logits 2 A P^T - ||P_v||^2 - ||A_b||^2, A = h M^T:
    dA = 2 g P - 2 (sum_v g) A,  dP = 2 g^T A - 2 (sum_b g) P,
    dh = dA M,  dM = dA^T h; each in float32, cast to its input's dtype."""

    @staticmethod
    def forward(ctx, h, m, p):
        out, acts = _head(h, m, p)
        # a copy, not a view: a view would keep the (B, V) logits buffer
        # alive until the backward
        ctx.save_for_backward(h, m, p, acts.clone())
        return out

    @staticmethod
    def backward(ctx, g):
        h, m, p, a = ctx.saved_tensors
        need_h, need_m, need_p = ctx.needs_input_grad
        g = g.float()
        pf = p.float()
        dh = dm = dp = None
        if need_h or need_m:
            da = 2.0 * (g @ pf) - 2.0 * g.sum(dim=1, keepdim=True) * a
            if need_h:
                dh = (da @ m.float()).to(h.dtype)
            if need_m:
                dm = (da.T @ h.float()).to(m.dtype)
        if need_p:
            dp = (2.0 * (g.T @ a)
                  - 2.0 * g.sum(dim=0)[:, None] * pf).to(p.dtype)
        return dh, dm, dp


def loghd_head_autograd(h: torch.Tensor, m: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    """``loghd_head_logits`` that autograd differentiates: the same one
    launch forward (the plain version for CPU tensors), and the backward of
    ``_HeadFn`` when grad mode is on and an input requires a gradient;
    otherwise the plain call, which keeps nothing for a backward."""
    if torch.is_grad_enabled() and (h.requires_grad or m.requires_grad
                                    or p.requires_grad):
        return _HeadFn.apply(h, m, p)
    return loghd_head_logits(h, m, p)

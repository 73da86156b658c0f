"""How a reference computes its products: exactly in float32, or with the
operands rounded first, the control's "one precision below".

A product ``a @ b`` of the references goes through ``Arith.mm`` (or takes
its operands through ``Arith.r``).  ``EXACT`` leaves them as they are and
runs the product in full float32, with the card's TF32 switched off.
``TF32`` rounds both operands to TF32 (10 explicit mantissa bits, round
to nearest even), which is what the card does to a float32 product with
TF32 on.  ``FP8`` scales each operand by its absolute maximum into
float8 e4m3 (3 mantissa bits), rounds, and scales back, as a per-tensor
fp8 product does.  The products are accumulated in float32 in every
case.  The rounding is written out rather than left to the card's switch,
so a control computes the same on the CPU and the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

E4M3_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _straight_through(t: torch.Tensor, rounded: torch.Tensor
                      ) -> torch.Tensor:
    """`rounded` forward; the gradient passes to `t` unrounded (the
    backward's products then read the rounded operands autograd kept)."""
    return t + (rounded - t).detach() if t.requires_grad else rounded


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even
    (finite inputs)."""
    t = t.float()
    bits = t.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return _straight_through(t, bits.view(torch.float32))


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 values through float8 e4m3 with one scale a tensor: the
    absolute maximum maps to e4m3's largest value, 448."""
    t = t.float()
    if t.numel() == 0:
        return t
    d = t.detach()
    scale = torch.clamp(d.abs().amax(), min=1e-30) / E4M3_MAX
    return _straight_through(
        t, (d / scale).to(torch.float8_e4m3fn).float() * scale)


@dataclasses.dataclass(frozen=True)
class Arith:
    """The rounding a reference applies to every product's operands."""
    name: str
    r: Callable[[torch.Tensor], torch.Tensor]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.r(a), self.r(b))


EXACT = Arith("float32", exact)
TF32 = Arith("tf32", round_tf32)
FP8 = Arith("fp8", round_fp8)
BY_NAME = {a.name: a for a in (EXACT, TF32, FP8)}


@contextlib.contextmanager
def full_float32():
    """Full float32 products on the card inside the block (TF32 off), the
    caller's settings restored after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved

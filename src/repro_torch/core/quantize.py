"""Post-training quantization (QuantHD-style; paper Sec. IV-A); port of
``repro.core.quantize``.

  b = 1:  bipolar sign quantization, q in {0, 1} encoding {-1, +1} * scale
  b > 1:  symmetric uniform, q in [-(2^(b-1)), 2^(b-1) - 1], w ~ q * scale

Codes are int8 with b significant bits, so stored-bit faults act on the
exact bit pattern.  Differences from torch's defaults that matter for
bitwise parity with the reference: the standard deviation is the population
one (``correction=0``, jnp.std's default), ``torch.round`` rounds half to
even like ``jnp.round``, and ``w / scale`` stays in float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: integer codes + scalar scale + bit width."""
    codes: torch.Tensor       # int8, values within the b-bit signed range
    scale: torch.Tensor       # f32 scalar
    bits: int


# sigma-clipping per bit width (MSE-optimal clip grows with precision)
_CLIP_SIGMA = {2: 1.7, 3: 2.2, 4: 2.8, 5: 3.2, 6: 3.6, 7: 3.9, 8: 4.2}


def quantize(w: torch.Tensor, bits: int) -> QTensor:
    """Uniform symmetric per-tensor quantization to `bits` bits.

    The scale's mean / std reductions sum in another order than XLA's, so
    it can differ from the reference's by an ulp; the codes are bitwise the
    reference's for an equal scale (``codes_for_scale``)."""
    if not 1 <= bits <= 8:
        raise ValueError("bits must be in [1, 8]")
    w = w.to(torch.float32)
    if bits == 1:
        scale = torch.mean(torch.abs(w))
    else:
        qmax = float(2 ** (bits - 1) - 1)
        sigma = torch.std(w, correction=0) + 1e-12
        scale = torch.minimum(torch.max(torch.abs(w)),
                              _CLIP_SIGMA[bits] * sigma) / qmax
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    return QTensor(codes_for_scale(w, scale, bits), scale, bits)


def codes_for_scale(w: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """int8 codes of `w` at a given scale: the sign bit for 1 bit, else
    clamp(round(w / scale)) with round-half-to-even, in float32."""
    if bits == 1:
        return (w >= 0).to(torch.int8)
    qmax = float(2 ** (bits - 1) - 1)
    codes = torch.clamp(torch.round(w.to(torch.float32) / scale), -qmax - 1,
                        qmax)
    return codes.to(torch.int8)


def dequantize(q: QTensor) -> torch.Tensor:
    if q.bits == 1:
        return (2.0 * q.codes.to(torch.float32) - 1.0) * q.scale
    return q.codes.to(torch.float32) * q.scale


def quantize_tree(tree: dict, bits: int, *, skip=()) -> dict:
    """Quantize every float leaf of a (nested) dict; keys in `skip` and
    non-float leaves pass through."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = quantize_tree(leaf, bits, skip=skip)
        elif (name in skip or not isinstance(leaf, torch.Tensor)
              or not leaf.is_floating_point()):
            out[name] = leaf
        else:
            out[name] = quantize(leaf, bits)
    return out

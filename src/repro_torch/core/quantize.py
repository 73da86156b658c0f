"""Post-training quantization (QuantHD-style; paper Sec. IV-A); port of
``repro.core.quantize``.

  b = 1:  bipolar sign quantization, q in {0, 1} encoding {-1, +1} * scale
  b > 1:  symmetric uniform, q in [-(2^(b-1)), 2^(b-1) - 1], w ~ q * scale

Codes are int8 with b significant bits, so stored-bit faults act on the
exact bit pattern.  Differences from torch's defaults that matter for
bitwise parity with the reference: ``torch.round`` rounds half to even like
``jnp.round``, and ``w / scale`` stays in float32.

The scale is computed on the host in numpy, as the reference computes it
when ``quantize`` runs eagerly on XLA's CPU backend: the mean is the sum
times float32(1/N) (``jnp.mean`` folds its static count into a reciprocal),
the variance is the sum of squares divided by float32(N), and every sum
adds in XLA's order (``xla_sum``).  So a leaf on the card gets the same
scale, bit for bit, as on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: integer codes + scalar scale + bit width."""
    codes: torch.Tensor       # int8, values within the b-bit signed range
    scale: torch.Tensor       # f32 scalar
    bits: int


# sigma-clipping per bit width (MSE-optimal clip grows with precision)
_CLIP_SIGMA = {2: 1.7, 3: 2.2, 4: 2.8, 5: 3.2, 6: 3.6, 7: 3.9, 8: 4.2}


# XLA's CPU backend rewrites a reduction over a dimension longer than this
# into reduce-windows of this width (its tree-reduction rewriter)
_XLA_WINDOW = 32


def _sequential_sum(x: np.ndarray) -> np.ndarray:
    """float32 sums along the last axis, adding left to right (a running
    sum rounds after every addition, unlike numpy's pairwise reduce)."""
    return np.cumsum(x, axis=-1, dtype=np.float32)[..., -1]


def xla_sum(x: np.ndarray) -> np.float32:
    """Sum of a float32 array in the order XLA's CPU backend adds it.

    While a dimension is longer than 32, the reduction becomes a
    reduce-window: every dimension longer than 32 is cut into windows of 32
    (zero-padded half before, half after), shorter ones form one window,
    and each window is summed in row-major order of its elements.  The last
    array, with every dimension at most 32, is summed in row-major order.
    XLA's LLVM back end may vectorize that last loop when the whole
    reduction is one small fused loop; that order is not reproduced."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return np.float32(0.0)
    while any(d > _XLA_WINDOW for d in x.shape):
        wins = [min(d, _XLA_WINDOW) for d in x.shape]
        pads = [(-d % w // 2, -d % w - -d % w // 2)
                for d, w in zip(x.shape, wins)]
        x = np.pad(x, pads)
        outs = [d // w for d, w in zip(x.shape, wins)]
        x = x.reshape([v for o, w in zip(outs, wins) for v in (o, w)])
        nd = len(outs)
        x = x.transpose(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
        x = _sequential_sum(x.reshape(outs + [-1]))
    return np.float32(_sequential_sum(x.reshape(-1)))


def quantize_scale(w: np.ndarray, bits: int) -> np.float32:
    """The reference's per-tensor scale of a float32 array, with its
    reductions in XLA's order (see the module docstring)."""
    w = np.asarray(w, np.float32)
    inv_n = np.float32(1.0 / w.size)
    if bits == 1:
        return np.float32(xla_sum(np.abs(w)) * inv_n)
    qmax = np.float32(2 ** (bits - 1) - 1)
    centered = w - np.float32(xla_sum(w) * inv_n)
    sigma = np.sqrt(np.float32(xla_sum(centered * centered)
                               / np.float32(w.size))) + np.float32(1e-12)
    scale = np.minimum(np.abs(w).max(),
                       np.float32(_CLIP_SIGMA[bits]) * sigma) / qmax
    return np.float32(1.0) if scale <= 0 else np.float32(scale)


def quantize(w: torch.Tensor, bits: int) -> QTensor:
    """Uniform symmetric per-tensor quantization to `bits` bits.

    The scale is the reference's (``quantize_scale``, one copy of `w` to
    the host); the codes are computed on `w`'s device."""
    if not 1 <= bits <= 8:
        raise ValueError("bits must be in [1, 8]")
    w = w.to(torch.float32)
    scale = torch.tensor(quantize_scale(w.detach().cpu().numpy(), bits),
                         device=w.device)
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


def dequantize_tree(tree):
    """Every QTensor of a tree (dicts, lists, tuples, typed models) back to
    float32; other leaves pass through, as ``jax.tree.map`` with QTensor as
    a leaf does in the reference."""
    if isinstance(tree, QTensor):
        return dequantize(tree)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequantize_tree(v) for v in tree)
    aux = getattr(tree, "aux_fields", None)
    if aux is not None and dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: dequantize_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.name not in aux})
    return tree


def quantization_mse(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-trip error mean((w - dequantize(quantize(w, bits)))^2), a
    float32 scalar on w's device; the mean is taken on the host as the
    reference's is (``xla_sum`` times float32(1/N))."""
    w = w.to(torch.float32)
    d = (w - dequantize(quantize(w, bits))).detach().cpu().numpy()
    mse = np.float32(xla_sum(d * d) * np.float32(1.0 / d.size))
    return torch.tensor(mse, device=w.device)

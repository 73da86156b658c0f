"""Int8 gradient compression for the all-reduce, with error feedback (port
of ``repro.optim.grad_compress``).

``compressed_psum`` quantizes the local gradient plus the carried error to
int8 codes, one absmax scale per block of 256 values, sums the dequantized
values over the process group with ``all_reduce`` and returns their mean;
the quantization residual is the new error, carried to the next step,
which keeps the update unbiased to first order.  As in the reference the
dequantized values are what is summed (each rank's scales differ), so the
sum's bytes are float32; the codes are what a transport would send.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_reduce_sum, group_size

__all__ = ["compressed_psum", "init_error_buffers", "quantize_feedback",
           "recip_f32"]


def recip_f32(n: int) -> float:
    """float32(1 / n): XLA compiles a division by a constant into the
    product by it, and the reference runs compiled (inside ``shard_map``)."""
    return float(np.float32(1.0 / n))


def _quantize_block(x: torch.Tensor, block: int):
    """Per-block absmax int8: (codes (nb, block), scale (nb, 1), x rebuilt
    from them).  ``torch.round`` rounds half to even, as ``jnp.round``
    does, the scale is the compiled reference's product by float32(1/127),
    and every step stays in float32, so the codes and the rebuilt values
    are the reference's bit for bit."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) * recip_f32(127)
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = codes.to(torch.float32) * scale
    return codes, scale, deq.reshape(-1)[:x.numel()].reshape(x.shape)


def quantize_feedback(grad: torch.Tensor, error: torch.Tensor,
                      block: int = 256):
    """(dequantized grad + error, new error): the local half of
    ``compressed_psum``.

    The new error is g - codes * scale rounded once, as the compiled
    reference computes it (XLA contracts the product and the difference
    into one fused multiply-add): in float64 both steps are exact (a code
    has 7 bits, a scale 24, and the difference cancels to within a few bits
    of the scale), so the one rounding to float32 is the fused one."""
    g = grad.to(torch.float32) + error
    codes, scale, deq = _quantize_block(g, block)
    wide = (codes.double() * scale.double()).reshape(-1)[:g.numel()]
    return deq, (g.double() - wide.reshape(g.shape)).to(torch.float32)


def compressed_psum(grad, group, error, block: int = 256):
    """Error-feedback int8 all-reduce of `grad` over `group` (None: the
    world's).  Returns (mean over the shards, new_error); without a process
    group the shards are this rank's alone.

    `grad` and `error` are one tensor (one shard a rank, the common case)
    or equal-length lists of this rank's shards (one error buffer a shard,
    as each device keeps its own in the reference); the shards'
    reconstructions are summed in list order before the ``all_reduce``,
    and the mean is over every rank's shards (the list form returns the
    list of new errors)."""
    many = isinstance(grad, (list, tuple))
    grads, errors = (grad, error) if many else ([grad], [error])
    if len(grads) != len(errors):
        raise ValueError(f"{len(grads)} shards and {len(errors)} error "
                         f"buffers")
    pairs = [quantize_feedback(g, e, block) for g, e in zip(grads, errors)]
    total = pairs[0][0]
    for deq, _ in pairs[1:]:
        total = total + deq
    n = len(pairs) * group_size(group)
    mean = all_reduce_sum(total, group) * recip_f32(n)
    new_errors = [e for _, e in pairs]
    return mean, (new_errors if many else new_errors[0])


def init_error_buffers(grads):
    """Zero float32 error buffers shaped like each gradient of a tensor or
    a (nested) dict, list or tuple of them."""
    if isinstance(grads, dict):
        return {k: init_error_buffers(g) for k, g in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(init_error_buffers(g) for g in grads)
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)

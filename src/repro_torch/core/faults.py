"""Stored-bit fault injection (paper Sec. IV-A, Fig. 3-6); port of the parts
of ``repro.core.faults`` the fault sweep needs.

Every stored bit of the model flips independently with probability p.
Integer (QTensor) leaves are corrupted by the ``flip_corrupt`` kernel
(``repro_torch.api.dispatch.corrupt_materialize_grid``); float leaves get IEEE-754
flips here, from a packed 32-plane mask drawn from a ``torch.Generator``.
The threefry ``flip_bits_int`` path and the fault-model zoo come later.
"""

from __future__ import annotations

import torch

# Leaves that are never corrupted: encoder (shared, not part of the model
# budget), structural indices, and codebooks (hardwired in the decoder).
STRUCTURAL_LEAVES = ("keep", "codebook", "proj", "bias", "enc")


def fault_skip_set(scope: str) -> tuple:
    """Leaf names protected from flips under `scope`: "all" protects the
    structural leaves only, "hv" also the profiles and sigma_inv."""
    skip = ("keep", "codebook")
    if scope == "hv":
        return skip + ("profiles", "sigma_inv")
    if scope != "all":
        raise ValueError(f"unknown fault scope: {scope}")
    return skip


def packed_flip_mask(p: float, shape, nbits: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Random nbits-bit words (int64) with bit i set w.p. p: one bernoulli
    plane per bit position, all drawn at once on the generator's device."""
    dev = generator.device
    planes = torch.rand((nbits, *shape), generator=generator, device=dev) < p
    weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        nbits, device=dev).view(nbits, *([1] * len(shape)))
    return (planes.to(torch.int64) * weights).sum(dim=0)


def flip_bits_f32(w: torch.Tensor, p: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Flip each of the 32 IEEE-754 bits of `w` independently w.p. p."""
    mask = packed_flip_mask(p, w.shape, 32, generator)
    mask = torch.where(mask >= (1 << 31), mask - (1 << 32), mask)
    u = w.to(torch.float32).contiguous().view(torch.int32)
    return (u ^ mask.to(device=w.device, dtype=torch.int32)).view(torch.float32)

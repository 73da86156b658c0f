"""Stored-bit fault injection (paper Sec. IV-A, Fig. 3-6); port of
``repro.core.faults``.

Every stored bit of the model flips independently with probability p.
Integer (QTensor) leaves hold b-bit two's-complement codes, corrupted as
b-bit memory words; float leaves are corrupted on their IEEE-754 bit
pattern.  Words are held in int32 (masked to b bits; a float32 leaf's bits
as ``view(torch.int32)``), because torch has no ``bitwise_not`` for its
unsigned types; the stored codes stay int8 (b <= 8) or int16 (b <= 16).

Randomness comes from a **draw**: an object with ``mask(p, shape, nbits)``
(packed int32 words, bit i set w.p. p) and ``bernoulli(p, shape)`` (a bool
tensor).  ``GeneratorDraw`` is the default, a ``torch.Generator`` whose
stream each call continues; tests inject draws that replay another
package's masks.  A tree walk takes one seed per leaf (an int, a
``torch.Generator`` or a draw), in the tree's order.

The sweep's kernel route (``repro_torch.api.dispatch
.corrupt_materialize_grid``) corrupts integer leaves with the
``flip_corrupt`` counter hash instead, and float leaves with
``flip_bits_f32`` on a generator seeded with the leaf's seed.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch.core.quantize import QTensor

# Leaves that are never corrupted: encoder (shared, not part of the model
# budget), structural indices, and codebooks (hardwired in the decoder).
STRUCTURAL_LEAVES = ("keep", "codebook", "proj", "bias", "enc")

WORD_BITS = 32
# the uniforms packed_flip_mask holds at once, beyond one plane's
PLANE_FLOATS = 1 << 16


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
    """Random nbits-bit words (int32) with bit i set w.p. p, on the
    generator's device: one bernoulli plane per bit position, OR-ed into
    the word.  Planes are drawn in groups whose uniforms fit in
    ``PLANE_FLOATS`` floats (one plane at a time for a leaf of that size or
    more), so the transient memory is O(prod(shape) + PLANE_FLOATS) while a
    small leaf costs a few launches, not a few per plane.

    On the CPU every grouping consumes the generator's stream as one
    ``(nbits, *shape)`` draw does."""
    if nbits > WORD_BITS:
        raise ValueError(f"packed_flip_mask: nbits={nbits} does not fit the "
                         f"{WORD_BITS}-bit int32 word")
    dev = generator.device
    group = max(1, min(nbits, PLANE_FLOATS // max(math.prod(shape), 1)))
    lift = [1] * len(shape)
    mask = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(0, nbits, group):
        g = min(group, nbits - i)
        planes = torch.rand((g, *shape), generator=generator, device=dev) < p
        shifts = torch.arange(i, i + g, dtype=torch.int32,
                              device=dev).view(g, *lift)
        mask |= (planes.to(torch.int32) << shifts).sum(0, dtype=torch.int32)
    return mask


class GeneratorDraw:
    """The default draw: a ``torch.Generator`` whose stream every call
    continues.  ``seeded(seed, device)`` makes a fresh one on `device`, so a
    leaf's draws are a pure function of its seed, the severity and the
    shape."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "GeneratorDraw":
        return cls(torch.Generator(device=device).manual_seed(int(seed)))

    def mask(self, p: float, shape, nbits: int) -> torch.Tensor:
        return packed_flip_mask(p, shape, nbits, self.generator)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device) < p


def as_draw(seed, device):
    """A leaf's draw from its seed slot: a draw passes through, a
    ``torch.Generator`` is wrapped, an int seeds a generator on `device`."""
    if hasattr(seed, "mask"):
        return seed
    if isinstance(seed, torch.Generator):
        return GeneratorDraw(seed)
    return GeneratorDraw.seeded(seed, device)


def word_dtypes(bits: int) -> tuple:
    """(word dtype, signed storage dtype) for `bits`-bit codes: int32 words
    for every width, int8 storage up to 8 bits and int16 up to 16.  Wider
    codes raise."""
    if bits <= 8:
        return torch.int32, torch.int8
    if bits <= 16:
        return torch.int32, torch.int16
    raise ValueError(
        f"integer fault injection supports at most 16-bit codes "
        f"(int16 storage); got a {bits}-bit QTensor")


def codes_to_words(q: QTensor) -> torch.Tensor:
    """A QTensor's codes as b-bit memory words in int32 (high bits zero):
    the words every integer fault model corrupts."""
    wdtype, _ = word_dtypes(q.bits)
    return q.codes.to(wdtype) & ((1 << q.bits) - 1)


def words_to_codes(u: torch.Tensor, q: QTensor) -> QTensor:
    """Read corrupted b-bit words back as a QTensor: sign-extended from bit
    b-1 into the storage dtype (b = 1 stays 0/1)."""
    b = q.bits
    _, sdtype = word_dtypes(b)
    if b == 1:
        return QTensor(u.to(sdtype), q.scale, 1)
    ext = torch.where((u & (1 << (b - 1))) != 0, u | ~((1 << b) - 1), u)
    return QTensor(ext.to(sdtype), q.scale, b)


def flip_bits_int(q: QTensor, p: float, draw) -> QTensor:
    """Flip each of the b stored bits of every code independently w.p. p:
    XOR a random b-bit mask into the words and read them back."""
    draw = as_draw(draw, q.codes.device)
    u = codes_to_words(q)
    mask = draw.mask(p, tuple(q.codes.shape), q.bits).to(u.device)
    return words_to_codes(u ^ mask, q)


def f32_words(w: torch.Tensor) -> torch.Tensor:
    """A float leaf's float32 bit patterns as int32."""
    return w.to(torch.float32).contiguous().view(torch.int32)


def flip_bits_f32(w: torch.Tensor, p: float, draw) -> torch.Tensor:
    """Flip each of the 32 IEEE-754 bits of `w` independently w.p. p."""
    draw = as_draw(draw, w.device)
    mask = draw.mask(p, tuple(w.shape), WORD_BITS).to(w.device)
    return (f32_words(w) ^ mask).view(torch.float32)


def corrupt_tree(tree: dict, severity, seeds: Sequence, qtensor_fn: Callable,
                 float_fn: Callable, *, skip=()) -> dict:
    """Corrupt every stored leaf of a flat dict of leaves.

    ``seeds`` holds one seed per leaf in the dict's order (an int, a
    ``torch.Generator`` or a draw; ``as_draw`` makes the leaf's draw on its
    device).  Leaves named in `skip` pass through, QTensor leaves go to
    ``qtensor_fn(q, severity, draw)``, float leaves to ``float_fn(w,
    severity, draw)``, other integer leaves (keep, codebook) pass through.
    The JAX package gives its leaves keys in sorted-name order; map them by
    name, not by position."""
    seeds = list(seeds)
    if len(seeds) != len(tree):
        raise ValueError(f"{len(seeds)} seeds for {len(tree)} leaves "
                         f"{list(tree)}")
    out = {}
    for (name, leaf), seed in zip(tree.items(), seeds):
        if isinstance(leaf, dict):
            raise TypeError(f"leaf {name!r} is a dict: corrupt_tree walks a "
                            f"flat dict of tensors and QTensors")
        if name in skip:
            out[name] = leaf
        elif isinstance(leaf, QTensor):
            out[name] = qtensor_fn(leaf, severity,
                                   as_draw(seed, leaf.codes.device))
        elif leaf.is_floating_point():
            out[name] = float_fn(leaf, severity, as_draw(seed, leaf.device))
        else:
            out[name] = leaf
    return out


def flip_tree(tree: dict, p: float, seeds: Sequence, *, skip=()) -> dict:
    """iid flips in every stored leaf of a flat dict (``corrupt_tree`` with
    ``flip_bits_int`` and ``flip_bits_f32``)."""
    return corrupt_tree(tree, p, seeds, flip_bits_int, flip_bits_f32,
                        skip=skip)


def corrupt_model(d: dict, p: float, seeds: Sequence,
                  scope: str = "all") -> dict:
    """iid flips in the stored parts of a model's field dict.

    ``seeds`` holds one seed per leaf without ``enc``, in the dict's order.
    scope "all" corrupts every stored leaf (bundles / prototypes and the
    activation profiles, the paper's protocol); "hv" only the hypervector
    memory (profiles and sigma_inv protected).  Both protect the keep
    indices and the codebook; ``enc`` passes through."""
    rest = {k: v for k, v in d.items() if k != "enc"}
    out = flip_tree(rest, p, seeds, skip=fault_skip_set(scope))
    if "enc" in d:
        out["enc"] = d["enc"]
    return out

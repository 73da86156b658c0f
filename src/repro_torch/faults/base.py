"""Fault-model base class and the stored-leaf tree walker (port of
``repro.faults.base``).

A fault model is a parameterized corruption of a model's stored memory.
Its parameters (asymmetry ratios, burst row width, per-read drift rate,
...) are fixed at construction; the one knob every model shares is
**severity**, a scalar whose meaning is the model's own: a per-bit flip
probability for ``iid`` and ``asymmetric``, a row-hit probability for
``burst``, a stuck-cell probability for ``stuck_at``, a read count for
``drift``.  Severity 0 is always the identity.

Models are frozen dataclasses, so equal parameters compare and hash equal.
Each corrupts memory words: ``corrupt_words(u, nbits, severity, draw)``
takes int32 words of ``nbits`` significant bits (a QTensor's b-bit codes,
or a float32 leaf's 32 bits) and returns the words read back.  The tree
walk, one seed per leaf and the ``skip`` protection are
``repro_torch.core.faults.corrupt_tree``'s, shared with ``flip_tree``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Sequence

import torch

from repro_torch.core.faults import (WORD_BITS, as_draw, codes_to_words,
                                     corrupt_tree, f32_words, words_to_codes)
from repro_torch.core.quantize import QTensor

__all__ = ["FaultModel", "corrupt_tree"]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Base class for registered device-noise models.

    Subclasses are frozen dataclasses whose fields are the model's
    parameters; they implement ``corrupt_words`` (or override the two leaf
    hooks ``corrupt_qtensor(q, severity, draw)`` and ``corrupt_f32(w,
    severity, draw)``).  A `draw` may also be an int seed or a
    ``torch.Generator`` (``core.faults.as_draw``).  ``kernel_eligible``
    marks the models whose corruption is plain iid bit flips: only those
    take the ``flip_corrupt`` kernel in ``api.dispatch
    .corrupt_materialize``; every other model runs in torch ops on the
    model's device."""

    name: ClassVar[str] = "base"
    kernel_eligible: ClassVar[bool] = False

    def corrupt_words(self, u: torch.Tensor, nbits: int, severity,
                      draw) -> torch.Tensor:
        raise NotImplementedError

    def corrupt_qtensor(self, q: QTensor, severity, draw) -> QTensor:
        draw = as_draw(draw, q.codes.device)
        return words_to_codes(
            self.corrupt_words(codes_to_words(q), q.bits, severity, draw), q)

    def corrupt_f32(self, w: torch.Tensor, severity, draw) -> torch.Tensor:
        draw = as_draw(draw, w.device)
        return self.corrupt_words(f32_words(w), WORD_BITS, severity,
                                  draw).view(torch.float32)

    def corrupt(self, tree: dict, severity, seeds: Sequence, *,
                skip=()) -> dict:
        """Corrupt every stored leaf of a flat dict at ``severity``, one
        seed per leaf in the dict's order (``corrupt_tree``)."""
        return corrupt_tree(tree, severity, seeds, self.corrupt_qtensor,
                            self.corrupt_f32, skip=skip)

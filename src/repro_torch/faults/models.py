"""The built-in device-noise models (port of ``repro.faults.models``).

  ``iid``         every stored bit flips independently w.p. severity (the
                  paper's Sec. IV-A protocol); kernel eligible.
  ``asymmetric``  0->1 upsets at severity * p01_scale and 1->0 upsets at
                  severity * p10_scale, drawn independently per bit plane
                  (voltage-scaled SRAM / ReRAM).
  ``burst``       a bernoulli draw per row of ``row_size`` consecutive
                  words (over the flattened leaf, so rows cross matrix
                  rows) gates a ``burst_rate`` flip plane; severity is the
                  row-hit probability (word-line faults).
  ``stuck_at``    each bit is stuck w.p. severity, ``stuck0_frac`` of them
                  at 0 (stuck-at-0 wins the overlap); one seed's map is the
                  same on every read, so re-applying it is idempotent.
  ``drift``       each read flips each bit w.p. ``per_read_p``; severity is
                  the read count, and the flip parity after r reads is
                  p_eff(r) = (1 - (1 - 2p)^r) / 2, one iid draw at p_eff.

Each model draws its masks from the leaf's draw in a fixed order:
asymmetric m01 then m10, burst the row gate then the flips, stuck_at m0
then m1.  The probabilities are clipped to [0, 1] and rounded to float32
as the reference's ``jnp.clip`` gives them.  Severity 0 is the identity
for every model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from repro_torch.faults.base import FaultModel

__all__ = ["IIDFlip", "AsymmetricFlip", "BurstFlip", "StuckAt", "DriftFlip"]


def _prob(x: float) -> float:
    """`x` clipped to [0, 1], as a float32 value."""
    return float(np.float32(min(max(float(x), 0.0), 1.0)))


def _mask(draw, p: float, u: torch.Tensor, nbits: int) -> torch.Tensor:
    return draw.mask(p, tuple(u.shape), nbits).to(u.device)


@dataclasses.dataclass(frozen=True)
class IIDFlip(FaultModel):
    """Independent bit flips at rate = severity (the paper's protocol):
    the words of ``core.faults.flip_bits_int`` / ``flip_bits_f32``, and
    kernel eligible, so a sweep with ``fault_model="iid"`` takes the
    ``flip_corrupt`` kernel exactly as the default sweep does."""

    name: ClassVar[str] = "iid"
    kernel_eligible: ClassVar[bool] = True

    def corrupt_words(self, u, nbits, severity, draw):
        return u ^ _mask(draw, float(severity), u, nbits)


@dataclasses.dataclass(frozen=True)
class AsymmetricFlip(FaultModel):
    """A stored 0 reads back 1 w.p. ``severity * p01_scale``, a stored 1
    reads back 0 w.p. ``severity * p10_scale``.  The defaults model SRAM
    under a scaled supply, where discharge (1->0) dominates; ``iid`` is
    the case p01 == p10."""

    p01_scale: float = 0.25
    p10_scale: float = 1.0

    name: ClassVar[str] = "asymmetric"

    def __post_init__(self):
        if self.p01_scale < 0 or self.p10_scale < 0:
            raise ValueError("asymmetric scales must be >= 0")

    def corrupt_words(self, u, nbits, severity, draw):
        m01 = _mask(draw, _prob(severity * self.p01_scale), u, nbits)
        m10 = _mask(draw, _prob(severity * self.p10_scale), u, nbits)
        return u ^ ((~u & m01) | (u & m10))


@dataclasses.dataclass(frozen=True)
class BurstFlip(FaultModel):
    """Row-correlated bursts: memory is rows of ``row_size`` consecutive
    words, each hit w.p. severity, and within a hit row every bit flips
    w.p. ``burst_rate``.  The marginal rate is ``severity * burst_rate``,
    concentrated in the hit rows."""

    row_size: int = 128
    burst_rate: float = 0.5

    name: ClassVar[str] = "burst"

    def __post_init__(self):
        if self.row_size < 1:
            raise ValueError("row_size must be >= 1")
        if not 0.0 <= self.burst_rate <= 1.0:
            raise ValueError("burst_rate must be in [0, 1]")

    def _row_gate(self, shape, severity, draw, device) -> torch.Tensor:
        """Bool gate of `shape`: one draw per row of the flattened leaf."""
        n = math.prod(shape)
        hit = draw.bernoulli(float(severity), (-(-n // self.row_size),))
        return hit.to(device).repeat_interleave(self.row_size)[:n].reshape(
            shape)

    def corrupt_words(self, u, nbits, severity, draw):
        gate = self._row_gate(tuple(u.shape), severity, draw, u.device)
        flips = _mask(draw, self.burst_rate, u, nbits)
        return u ^ torch.where(gate, flips, torch.zeros_like(flips))


@dataclasses.dataclass(frozen=True)
class StuckAt(FaultModel):
    """Persistent stuck cells: each bit is stuck w.p. severity,
    ``stuck0_frac`` of them reading 0 and the rest 1; stuck-at-0 wins the
    overlap, so the two maps are disjoint and re-applying the model with
    the same seed changes nothing."""

    stuck0_frac: float = 0.5

    name: ClassVar[str] = "stuck_at"

    def __post_init__(self):
        if not 0.0 <= self.stuck0_frac <= 1.0:
            raise ValueError("stuck0_frac must be in [0, 1]")

    def corrupt_words(self, u, nbits, severity, draw):
        m0 = _mask(draw, _prob(severity * self.stuck0_frac), u, nbits)
        m1 = _mask(draw, _prob(severity * (1.0 - self.stuck0_frac)), u,
                   nbits) & ~m0
        return (u & ~m0) | m1


@dataclasses.dataclass(frozen=True)
class DriftFlip(FaultModel):
    """Read-disturb drift: each read flips each bit w.p. ``per_read_p``;
    severity is the read count r, and the corruption is one iid draw at
    p_eff(r) = (1 - (1 - 2 p)^r) / 2, which is 0 at r = 0 and saturates at
    1/2.  Not kernel eligible, as in the reference."""

    per_read_p: float = 0.002

    name: ClassVar[str] = "drift"

    def __post_init__(self):
        if not 0.0 <= self.per_read_p < 0.5:
            raise ValueError("per_read_p must be in [0, 0.5) — at 0.5 a "
                             "single read already scrambles every bit")

    def p_eff(self, reads) -> float:
        """Cumulative flip probability after ``reads`` reads, computed in
        float32 as 0.5 (1 - exp(r log(1 - 2p))).

        >>> DriftFlip(per_read_p=0.01).p_eff(0.0)
        0.0
        """
        base = torch.tensor(1.0 - 2.0 * self.per_read_p, dtype=torch.float32)
        r = torch.tensor(float(reads), dtype=torch.float32)
        return float(0.5 * (1.0 - torch.exp(r * torch.log(base))))

    def corrupt_words(self, u, nbits, severity, draw):
        return u ^ _mask(draw, self.p_eff(severity), u, nbits)

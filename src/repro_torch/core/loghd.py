"""LogHD configuration and memory accounting (paper Algorithm 1); port of
``repro.core.loghd``.

  memory:  O(C*D)  ->  O(n*D + C*n)  =  O(D log_k C)   for D >> C
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import codebook as cb


@dataclasses.dataclass(frozen=True)
class LogHDConfig:
    """Hyperparameters for the LogHD class-axis compressor.

    ``n_bundles`` is derived: ceil(log_k C) + ``extra_bundles``.

    >>> LogHDConfig(n_classes=26, k=2, extra_bundles=2).n_bundles
    7
    """
    n_classes: int
    k: int = 2                       # alphabet size (paper: k in {2, 3})
    extra_bundles: int = 0           # eps redundancy (Sec. III-G)
    alpha: float = 1.0               # capacity surrogate exponent
    refine_epochs: int = 100         # T (paper: 100)
    lr: float = 3e-4                 # eta (paper: 3e-4)
    refine_batch: int = 64
    metric: str = "l2"               # decode metric: l2 | cos | maha
    codebook_method: str = "auto"
    bipolar_init: bool = False
    seed: int = 0
    class_sharding: int = 1
    data_sharding: int = 1

    @property
    def n_bundles(self) -> int:
        return cb.min_bundles(self.n_classes, self.k) + self.extra_bundles


def memory_bits(n_classes: int, dim: int, n_bundles: int, bits: int,
                profile_bits: Optional[int] = None) -> int:
    """n bundles of length D plus C profiles of length n, in bits.

    >>> memory_bits(26, 10_000, 5, 1)
    50130
    """
    pb = bits if profile_bits is None else profile_bits
    return n_bundles * dim * bits + n_classes * n_bundles * pb


def conventional_memory_bits(n_classes: int, dim: int, bits: int) -> int:
    """Baseline storage C * D * bits: the denominator of every budget
    fraction.

    >>> conventional_memory_bits(26, 10_000, 1)
    260000
    """
    return n_classes * dim * bits


def max_bundles_for_budget(budget_fraction: float, n_classes: int, dim: int,
                           k: int, *, strict: bool = True) -> int:
    """Largest n with  n*D + C*n  <=  x * C * D, floored at ceil(log_k C)
    (raises below the floor unless ``strict=False``, which clamps).

    >>> max_bundles_for_budget(0.4, 26, 10_000, 2)
    10
    >>> max_bundles_for_budget(0.0001, 26, 10_000, 2, strict=False)
    5
    """
    n = int(budget_fraction * n_classes * dim / (dim + n_classes))
    floor = cb.min_bundles(n_classes, k)
    if n < floor:
        if strict:
            raise ValueError(
                f"budget fraction {budget_fraction} allows n={n} bundles but "
                f"unique k={k} codes for C={n_classes} classes need at least "
                f"ceil(log_{k} {n_classes}) = {floor}; pass strict=False to "
                f"clamp")
        return floor
    return n

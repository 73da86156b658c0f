"""Hybrid class- and feature-axis compression (paper Sec. IV-D, Fig. 1c/6);
port of ``repro.core.hybrid``.

A trained LogHD model's bundles get SparseHD-style dimension-wise
sparsification (one keep-mask shared by all bundles), and the activation
profiles are re-estimated from the sparsified activations.

Memory:  n * (1-S) * D + C * n   words (+ D mask bits).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.loghd import LogHDConfig


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """LogHD config plus the feature-axis sparsity applied to its bundles."""
    loghd: LogHDConfig
    sparsity: float = 0.5
    saliency: str = "spread"


def sparsity_for_budget(budget_fraction: float, n_classes: int, dim: int,
                        n_bundles: int) -> float:
    """S with  n*(1-S)*D + C*n  <=  x * C*D  (same precision both sides),
    rounded to float32 as the reference's ``jnp.clip`` rounds it."""
    keep = (budget_fraction * n_classes * dim - n_classes * n_bundles) / (
        n_bundles * dim)
    return float(np.clip(np.float32(1.0 - keep), 0.0, 1.0))

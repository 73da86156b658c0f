"""SparseHD baseline math: feature-axis (dimension-wise) sparsification;
port of ``repro.core.sparsehd``.

The same set of dimensions is dropped from every class prototype, chosen by
a saliency score; the compact model stores C prototypes of length
D' = (1-S) * D plus one shared D-bit keep-mask, then retrains with OnlineHD
in the kept space.

  "spread"   max_c H[c, d] - min_c H[c, d]   (exact on every device)
  "variance" var_c H[c, d]                    (population variance)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparseHDConfig:
    """Hyperparameters for the SparseHD feature-axis baseline."""
    n_classes: int
    sparsity: float = 0.5           # S: fraction of dimensions dropped
    saliency: str = "spread"
    retrain_epochs: int = 100
    lr: float = 3e-4
    batch_size: int = 64
    seed: int = 0


def dimension_saliency(protos: torch.Tensor,
                       kind: str = "spread") -> torch.Tensor:
    """Per-dimension saliency score over class prototypes: (C, D) -> (D,)."""
    if kind == "spread":
        return protos.amax(dim=0) - protos.amin(dim=0)
    if kind == "variance":
        return torch.var(protos, dim=0, correction=0)
    raise ValueError(f"unknown saliency: {kind}")


def keep_indices(protos: torch.Tensor, sparsity: float,
                 kind: str = "spread") -> torch.Tensor:
    """Indices of the (1-S)*D retained dimensions, sorted ascending.

    The most salient dimensions are taken by a stable descending sort, so
    among equal scores the lower index is kept first, as ``jax.lax.top_k``
    keeps it (``torch.topk`` promises no order)."""
    n_keep = max(1, int(round((1.0 - sparsity) * protos.shape[1])))
    order = torch.sort(dimension_saliency(protos, kind), descending=True,
                       stable=True).indices
    return torch.sort(order[:n_keep]).values


def sparsity_for_budget(budget_fraction: float, n_classes: int, dim: int,
                        bits: int) -> float:
    """S with  C*(1-S)*D*bits + D  <=  x * C*D*bits, rounded to float32 as
    the reference's ``jnp.clip`` rounds it."""
    keep = (budget_fraction * n_classes * dim * bits - dim) / (
        n_classes * dim * bits)
    return float(np.clip(np.float32(1.0 - keep), 0.0, 1.0))

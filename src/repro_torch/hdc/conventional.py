"""Conventional HDC math used by LogHD (port of ``repro.hdc.conventional``):
L2 normalisation and per-class prototype superposition.

The OnlineHD refinement comes with the training slice.
"""

from __future__ import annotations

import torch


def l2_normalize(v: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Safe L2 normalization, shared by the fit and predict paths."""
    return v / (torch.linalg.vector_norm(v, dim=dim, keepdim=True) + eps)


def segment_sum(x: torch.Tensor, ids: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Rows of `x` summed per id: (N, ...), (N,) -> (n_rows, ...).

    Rows whose id lies outside ``[0, n_rows)`` are dropped and ids with no
    rows give zeros, as ``jax.ops.segment_sum`` does.  Deterministic on
    every device: rows are stably sorted by id and each segment is summed by
    ``torch.segment_reduce``, which walks a segment in example order — no
    atomics, unlike a CUDA ``index_add_``, so a fit repeats bit for bit."""
    ids = ids.to(device=x.device, dtype=torch.int64)
    keep = (ids >= 0) & (ids < n_rows)
    if not bool(keep.all()):
        x, ids = x[keep], ids[keep]
    order = torch.argsort(ids, stable=True)
    lengths = torch.bincount(ids, minlength=n_rows)
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True, initial=0.0)


def class_prototypes(h: torch.Tensor, y: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """Superpose encoded examples per class: (N, D), (N,) -> (C, D)
    normalized."""
    return l2_normalize(segment_sum(h, y, n_classes))

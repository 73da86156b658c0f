"""Conventional HDC math (port of ``repro.hdc.conventional``): L2
normalisation, per-class prototype superposition, the OnlineHD refinement
pass shared by conventional refinement and SparseHD retraining, and the
nearest-prototype predict.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ConventionalConfig:
    """Hyperparameters for the conventional prototype-per-class baseline.

    ``refine_epochs`` OnlineHD-style passes (0 = pure superposition) with
    learning rate ``lr`` over mini-batches of ``batch_size``."""
    n_classes: int
    refine_epochs: int = 0
    lr: float = 3e-4
    batch_size: int = 256


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


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """`x` with zero rows appended along axis 0 up to `rows` rows."""
    short = rows - x.shape[0]
    if short <= 0:
        return x
    return torch.cat([x, x.new_zeros((short, *x.shape[1:]))])


def pad_batches(h: torch.Tensor, y: torch.Tensor, batch_size: int):
    """Zero-pad (h, y) along axis 0 to a whole number of batches and split:
    ``(n_batches, batch_size, ...)`` each.

    Zero query rows are exact no-ops for both the OnlineHD and Eq. 9
    updates — every delta term carries a factor of h — so the zero-padded
    tail batch contributes exactly its real examples.  ``y`` may be labels
    (n,) or per-example target rows (n, k).  The epoch loops pad only their
    last batch (``pad_rows``), which gives the same batches."""
    n_batches = -(-h.shape[0] // batch_size)
    total = n_batches * batch_size
    return (pad_rows(h, total).reshape(n_batches, batch_size, *h.shape[1:]),
            pad_rows(y, total).reshape(n_batches, batch_size, *y.shape[1:]))


def onlinehd_coefficients(protos: torch.Tensor, hh: torch.Tensor,
                          yy: torch.Tensor) -> torch.Tensor:
    """The OnlineHD minibatch coefficients (B, C), before the learning
    rate: for a misclassified query, +(1 - s_true) on its true class and
    -(1 - s_pred) on the predicted one; zero rows for correct queries.
    ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    sims = hh @ protos.T                                       # (B, C)
    pred = torch.argmax(sims, dim=-1)
    wrong = (pred != yy).to(hh.dtype)
    s_true = sims.gather(1, yy[:, None])[:, 0]
    s_pred = sims.gather(1, pred[:, None])[:, 0]
    c = protos.shape[0]
    return ((wrong * (1.0 - s_true))[:, None] * F.one_hot(yy, c).to(hh.dtype)
            - (wrong * (1.0 - s_pred))[:, None]
            * F.one_hot(pred, c).to(hh.dtype))


def onlinehd_delta(protos: torch.Tensor, hh: torch.Tensor, yy: torch.Tensor,
                   lr) -> torch.Tensor:
    """The raw OnlineHD minibatch delta lr * coeff^T h, before adding and
    re-normalizing."""
    return torch.einsum("bc,bd->cd", onlinehd_coefficients(protos, hh, yy),
                        hh) * lr


def onlinehd_step(protos: torch.Tensor, hh: torch.Tensor, yy: torch.Tensor,
                  lr) -> torch.Tensor:
    """One OnlineHD minibatch update: (C, D), (B, D), (B,) -> (C, D).

    Pulls the true prototype toward misclassified queries and pushes the
    winning wrong prototype away, scaled by the similarity gap."""
    return l2_normalize(protos + onlinehd_delta(protos, hh, yy, lr))


def onlinehd_epoch(protos: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
                   lr: float, batch_size: int,
                   step: Callable = onlinehd_step) -> torch.Tensor:
    """One OnlineHD pass over the examples in order, minibatch by minibatch
    (the last one zero-padded, see ``pad_batches``).  ``step`` is the
    minibatch update (the fit engine passes its kernel step)."""
    for i in range(0, h.shape[0], batch_size):
        protos = step(protos, pad_rows(h[i:i + batch_size], batch_size),
                      pad_rows(y[i:i + batch_size], batch_size), lr)
    return protos


def predict_from_encoded(protos: torch.Tensor, h: torch.Tensor
                         ) -> torch.Tensor:
    """Nearest-prototype labels for pre-encoded queries: (C, D), (B, D) ->
    (B,)."""
    return torch.argmax(h @ l2_normalize(protos).T, dim=-1)

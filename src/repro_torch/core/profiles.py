"""Activation vectors and per-class activation profiles (paper Sec. III-D,
Eq. 5-7); port of ``repro.core.profiles``.

A(x) = (cos(M_1, phi(x)), ..., cos(M_n, phi(x)))  in R^n      (Eq. 5)
P_y  = E[A(x) | y]  ~  mean over class-y training examples     (Eq. 6)
"""

from __future__ import annotations

import torch

from repro_torch.hdc.conventional import l2_normalize, segment_sum


def activations(bundles: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A(x) for a batch: (n, D), (B, D) -> (B, n); h is L2-normalized."""
    return h @ l2_normalize(bundles).T


def segment_profile_means(acts: torch.Tensor, ids: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """Per-row activation means: (B, n), (B,) -> (n_rows, n).

    Ids outside ``[0, n_rows)`` are dropped and rows with no examples come
    out zero.  Deterministic on every device (see ``segment_sum``)."""
    sums = segment_sum(acts, ids, n_rows)
    counts = segment_sum(torch.ones((acts.shape[0], 1), dtype=acts.dtype,
                                    device=acts.device), ids, n_rows)
    return sums / torch.clamp(counts, min=1.0)


def estimate_profiles(bundles: torch.Tensor, h: torch.Tensor,
                      y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """P_c = mean_{x in class c} A(x): -> (C, n); absent classes get 0."""
    return segment_profile_means(activations(bundles, h), y, n_classes)


def decode_profiles(profiles: torch.Tensor, acts: torch.Tensor,
                    metric: str = "l2", sigma_inv=None) -> torch.Tensor:
    """Nearest-profile decode (Eq. 7): (C, n), (B, n) -> (B,) labels.

      "l2"   argmin_c ||A - P_c||^2, as 2 A.P_c - ||P_c||^2 (||A||^2 is
             constant per row and dropped);
      "cos"  argmax_c cos(A, P_c);
      "maha" argmin_c (A-P_c)' Sigma^-1 (A-P_c), by decoding P L and A L for
             Sigma^-1 = L L'.
    """
    if metric == "l2":
        scores = (2.0 * acts) @ profiles.T - torch.sum(profiles * profiles,
                                                       dim=-1)
        return torch.argmax(scores, dim=-1)
    if metric == "cos":
        return torch.argmax(l2_normalize(acts) @ l2_normalize(profiles).T,
                            dim=-1)
    if metric == "maha":
        if sigma_inv is None:
            raise ValueError("maha decode needs sigma_inv")
        l = torch.linalg.cholesky(sigma_inv)
        pw, aw = profiles @ l, acts @ l
        scores = (2.0 * aw) @ pw.T - torch.sum(pw * pw, dim=-1)
        return torch.argmax(scores, dim=-1)
    raise ValueError(f"unknown decode metric: {metric}")


def profile_scores(profiles: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """Negative squared distances -||A - P_c||^2 as class scores (B, C)."""
    return ((2.0 * acts) @ profiles.T
            - torch.sum(profiles * profiles, dim=-1)
            - torch.sum(acts * acts, dim=-1, keepdim=True))

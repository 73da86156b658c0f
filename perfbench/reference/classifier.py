"""Plain reference of the LogHD classifier: fit (paper Algorithm 1 with the
Eq. 9 refinement) and predict, in float32 torch and numpy.

Written from the paper's equations and the configuration file, with the
benchmark's own draws (projection, bias, refinement orders) as inputs:

  encode   phi(x) = cos(x W + b) * sin(x W), h = l2n(l2n(phi) - center),
           center = the mean of l2n(phi) over the training rows
  codebook unique base-k codes over the whole code space, picked greedily
           by the largest least Hamming distance to the codes taken, the
           smaller most-loaded bundle breaking ties (the "distance" method)
  bundles  M_j = l2n(sum_c g(B_cj) H_c), H_c = l2n(sum of class c's h),
           g(s) = s / (k - 1)
  refine   for each epoch and each batch of its order:
           M <- l2n(M + lr (t(B_y) - h M^T)^T h), t(s) = 2 g(s) - 1
  profiles P_c = the mean over class c's training rows of h l2n(M)^T
  predict  argmax_c 2 A P_c - ||P_c||^2, A = l2n(h) l2n(M)^T

Every product goes through ``arith`` (``precision.py``): exact float32
for the reference, rounded operands for the control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.precision import EXACT, Arith, full_float32


@dataclasses.dataclass
class State:
    """What a fit derives: the encoder's centre, the codebook, the refined
    bundles and the class profiles (with the draws it was given)."""
    proj: torch.Tensor        # (F, D)
    bias: torch.Tensor        # (D,)
    center: torch.Tensor      # (D,)
    codebook: np.ndarray      # (C, n) int32
    bundles: torch.Tensor     # (n, D)
    profiles: torch.Tensor    # (C, n)


def l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _phi(x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
         arith: Arith) -> torch.Tensor:
    z = arith.mm(x, proj)
    return torch.cos(z + bias) * torch.sin(z)


def encode(state: State, x: torch.Tensor, arith: Arith = EXACT
           ) -> torch.Tensor:
    """(B, F) raw rows -> (B, D) unit encodings."""
    with full_float32():
        return l2n(l2n(_phi(x, state.proj, state.bias, arith))
                   - state.center)


def _all_codes(k: int, n: int) -> np.ndarray:
    """Every base-k code of length n, most significant symbol first."""
    idx = np.arange(k ** n, dtype=np.int64)
    out = np.empty((idx.shape[0], n), dtype=np.int32)
    for j in range(n - 1, -1, -1):
        out[:, j] = idx % k
        idx //= k
    return out


def distance_codebook(n_classes: int, n: int, k: int, alpha: float,
                      seed: int, eps: float = 1e-6) -> np.ndarray:
    """The "distance" codebook: a first code drawn at random, then each
    class takes the unused code with the largest least Hamming distance to
    the codes taken, ties to the smallest most-loaded bundle (load: the
    sum of g(s)^alpha), then to a uniform draw scaled by `eps`."""
    pool = _all_codes(k, n)
    q = pool.shape[0]
    rng = np.random.default_rng(seed)
    w = (pool.astype(np.float64) / (k - 1)) ** alpha
    first = int(rng.integers(q))
    picks = [first]
    dmin = (pool != pool[first]).sum(axis=1)
    loads = w[first].copy()
    used = np.zeros(q, bool)
    used[first] = True
    for _ in range(n_classes - 1):
        worst = (loads[None, :] + w).max(axis=1)
        score = dmin.astype(np.float64) * 1e6 - worst + eps * rng.random(q)
        score[used] = -np.inf
        pick = int(np.argmax(score))
        picks.append(pick)
        used[pick] = True
        loads += w[pick]
        dmin = np.minimum(dmin, (pool != pool[pick]).sum(axis=1))
    return pool[np.array(picks)].astype(np.int32)


def _class_means(v: torch.Tensor, y: torch.Tensor, n_classes: int,
                 mean: bool) -> torch.Tensor:
    out = torch.zeros((n_classes, v.shape[1]), dtype=v.dtype,
                      device=v.device)
    for c in range(n_classes):
        rows = v[y == c]
        if rows.shape[0]:
            out[c] = rows.mean(0) if mean else rows.sum(0)
    return out


def fit(x: torch.Tensor, y: torch.Tensor, proj: torch.Tensor,
        bias: torch.Tensor, perms: torch.Tensor, cfg: dict, seed: int,
        arith: Arith = EXACT) -> State:
    """Fit the classifier of configuration `cfg` on (x, y): the encoder's
    centre, the codebook (drawn from `seed`), the bundles refined over the
    (epochs, N) orders `perms`, and the profiles."""
    c, k, n = cfg["n_classes"], cfg["k"], cfg["n_bundles"]
    with full_float32():
        y = y.long()
        raw = l2n(_phi(x, proj, bias, arith))
        center = raw.mean(0)
        h = l2n(raw - center)
        protos = l2n(_class_means(h, y, c, mean=False))
        book = distance_codebook(c, n, k, cfg["alpha"], seed)
        g = torch.as_tensor(book, device=h.device).float() / (k - 1)
        m = l2n(arith.mm(g.T, protos))
        t_y = (2.0 * g - 1.0)[y]
        lr, bs = cfg["lr"], cfg["refine_batch"]
        for order in perms.to(h.device):
            for i in range(0, order.shape[0], bs):
                idx = order[i:i + bs]
                hb = h[idx]
                err = t_y[idx] - arith.mm(hb, m.T)
                m = l2n(m + lr * arith.mm(err.T, hb))
        acts = arith.mm(h, l2n(m).T)
        profiles = _class_means(acts, y, c, mean=True)
    return State(proj=proj, bias=bias, center=center, codebook=book,
                 bundles=m, profiles=profiles)


def scores(state: State, h: torch.Tensor, arith: Arith = EXACT
           ) -> torch.Tensor:
    """(B, C) class scores 2 A P^T - ||P||^2 of unit encodings h; the
    label is their argmax."""
    with full_float32():
        acts = arith.mm(l2n(h), l2n(state.bundles).T)
        p = state.profiles
        return 2.0 * arith.mm(acts, p.T) - (p * p).sum(-1)


def predict(state: State, h: torch.Tensor, arith: Arith = EXACT
            ) -> torch.Tensor:
    return torch.argmax(scores(state, h, arith), dim=-1)

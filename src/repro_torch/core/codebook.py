"""Capacity-aware k-ary codebook construction (paper Sec. III-C, Eq. 2-3);
port of ``repro.core.codebook``.

Each class c receives a unique length-n code B_c in {0..k-1}^n.  Methods:

  * "greedy"     — the paper's Eq. 2 over the candidate pool, with uniform
                   tie-break draws ``xi``.  The JAX package draws them from
                   threefry; here they come from a ``torch.Generator`` or are
                   injected, and the selection runs in float32 numpy with the
                   reference's arithmetic, so equal ``xi`` give equal codes.
  * "distance"   — max-min-Hamming-distance with the minimax load as
                   tie-breaker (numpy-seeded: bitwise equal to the reference).
  * "stratified" — snake assignment over the load-ordered pool (numpy-seeded:
                   bitwise equal to the reference).
  * "auto"       — greedy when C * |Q| is affordable, else stratified.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def min_bundles(n_classes: int, k: int) -> int:
    """ceil(log_k C) in exact integer arithmetic.

    >>> min_bundles(1 << 20, 2), min_bundles((1 << 20) + 1, 2)
    (20, 21)
    """
    if n_classes <= 1:
        return 1
    n, cap = 1, k
    while cap < n_classes:
        cap *= k
        n += 1
    return n


def symbol_weight(s: torch.Tensor, k: int) -> torch.Tensor:
    """g(s) = s / (k-1), mapping symbols to contribution strengths in [0,1]."""
    return s.to(torch.float32) / float(k - 1)


def capacity(w: torch.Tensor, alpha: float) -> torch.Tensor:
    """U(w) = w^alpha, the nondecreasing capacity surrogate."""
    return torch.pow(w, alpha)


def _decode_codes(idx: np.ndarray, k: int, n: int) -> np.ndarray:
    """Base-k code indices -> (len(idx), n) int32 symbol rows (most
    significant symbol first)."""
    idx = idx.astype(np.int64, copy=True)
    out = np.empty((idx.shape[0], n), dtype=np.int32)
    for j in range(n - 1, -1, -1):
        out[:, j] = idx % k
        idx //= k
    return out


def _pool_indices(k: int, n: int, pool_size: int, seed: int) -> np.ndarray:
    """Candidate code indices (Q,) int64: all k^n codes when that is at most
    `pool_size`, else a unique random sample."""
    total = k ** n
    if total <= pool_size:
        return np.arange(total, dtype=np.int64)
    rng = np.random.default_rng(seed)
    picks = set()
    while len(picks) < pool_size:
        picks.update(rng.integers(0, total, size=pool_size - len(picks)).tolist())
    return np.fromiter(picks, dtype=np.int64, count=pool_size)


def candidate_pool(k: int, n: int, pool_size: int, seed: int) -> np.ndarray:
    """Unique candidate codes as decoded (Q, n) symbol rows."""
    return _decode_codes(_pool_indices(k, n, pool_size, seed), k, n)


def _greedy_select(pool: np.ndarray, n_classes: int, k: int, alpha: float,
                   eps: float, xi: np.ndarray) -> np.ndarray:
    """Eq. 2 greedy: each class takes the unused candidate minimising
    max_j (L_j + U(g(s_j))) + eps * xi, in float32 as the reference does."""
    u_pool = np.power(pool.astype(np.float32) / np.float32(k - 1),
                      np.float32(alpha))                     # (Q, n)
    xi = np.asarray(xi, dtype=np.float32)
    if xi.shape != (n_classes, pool.shape[0]):
        raise ValueError(f"xi must be {(n_classes, pool.shape[0])}, "
                         f"got {xi.shape}")
    loads = np.zeros((pool.shape[1],), np.float32)
    used = np.zeros((pool.shape[0],), bool)
    chosen = np.zeros((n_classes,), np.int64)
    for c in range(n_classes):
        score = (loads[None, :] + u_pool).max(axis=1) + np.float32(eps) * xi[c]
        score[used] = np.inf
        pick = int(np.argmin(score))
        loads += u_pool[pick]
        used[pick] = True
        chosen[c] = pick
    return pool[chosen]


def _distance_select(pool: np.ndarray, n_classes: int, k: int, alpha: float,
                     eps: float, seed: int) -> np.ndarray:
    """Greedy max-min-Hamming-distance selection with the minimax load as
    tie-breaker (beyond-paper; buys error-correction distance)."""
    rng = np.random.default_rng(seed)
    q = pool.shape[0]
    u_pool = ((pool.astype(np.float64) / (k - 1)) ** alpha)       # (Q, n)
    chosen_idx = [int(rng.integers(q))]
    dmin = (pool != pool[chosen_idx[0]]).sum(axis=1)              # (Q,)
    loads = u_pool[chosen_idx[0]].copy()
    used = np.zeros(q, bool)
    used[chosen_idx[0]] = True
    for _ in range(n_classes - 1):
        cand_load = (loads[None, :] + u_pool).max(axis=1)         # (Q,)
        score = (dmin.astype(np.float64) * 1e6 - cand_load
                 + eps * rng.random(q))
        score[used] = -np.inf
        pick = int(np.argmax(score))
        chosen_idx.append(pick)
        used[pick] = True
        loads += u_pool[pick]
        dmin = np.minimum(dmin, (pool != pool[pick]).sum(axis=1))
    return pool[np.array(chosen_idx)]


def _stratified_picks(wsum: np.ndarray, n_classes: int, seed: int
                      ) -> np.ndarray:
    """Snake through the load-ordered pool (even slots from the light end,
    odd from the heavy end), then shuffle the class assignment."""
    order = np.argsort(wsum, kind="stable")
    n_even = (n_classes + 1) // 2
    n_odd = n_classes // 2
    picks = np.empty(n_classes, dtype=np.int64)
    picks[0::2] = order[:n_even]
    picks[1::2] = order[::-1][:n_odd]
    rng = np.random.default_rng(seed)
    return picks[rng.permutation(n_classes)]


def _stratified_select(pool: np.ndarray, n_classes: int, k: int,
                       alpha: float, seed: int) -> np.ndarray:
    w = (pool.astype(np.float64) / (k - 1)) ** alpha
    return pool[_stratified_picks(w.sum(axis=1), n_classes, seed)]


def _validate_codebook_args(n_classes: int, n_bundles: int, k: int) -> None:
    if k < 2:
        raise ValueError("alphabet size k must be >= 2")
    need = min_bundles(n_classes, k)
    if n_bundles < need:
        raise ValueError(
            f"n_bundles={n_bundles} infeasible: need >= ceil(log_{k} {n_classes}) = {need}")
    if k ** n_bundles < n_classes:
        raise ValueError("code space smaller than number of classes")


def _resolve_method(method: str, n_classes: int, q: int) -> str:
    """Pin down "auto" (and over-budget "distance") to a concrete method."""
    if method == "auto":
        return "greedy" if n_classes * q <= (1 << 26) else "stratified"
    if method == "distance" and n_classes * q > (1 << 26):
        return "stratified"
    return method


def build_codebook(n_classes: int, n_bundles: int, k: int, *,
                   alpha: float = 1.0, eps: float = 1e-6,
                   pool_size: int = 1 << 18, seed: int = 0,
                   method: str = "auto",
                   xi: Optional[np.ndarray] = None,
                   generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Construct B in {0..k-1}^(C x n) with unique rows and balanced loads.

    ``xi`` (C, Q) injects the greedy tie-breaks; otherwise they are drawn
    from ``generator`` (default: a CPU generator seeded with ``seed``).
    Returns a (C, n) int32 numpy array."""
    _validate_codebook_args(n_classes, n_bundles, k)
    pool = candidate_pool(k, n_bundles, max(pool_size, 2 * n_classes), seed)
    if pool.shape[0] < n_classes:
        raise ValueError("candidate pool smaller than number of classes")

    method = _resolve_method(method, n_classes, pool.shape[0])
    if method == "greedy":
        if xi is None:
            if generator is None:
                generator = torch.Generator().manual_seed(seed)
            xi = torch.rand((n_classes, pool.shape[0]),
                            generator=generator).numpy()
        codes = _greedy_select(pool, n_classes, k, alpha, eps, xi)
    elif method == "distance":
        codes = _distance_select(pool, n_classes, k, alpha, eps, seed)
    elif method == "stratified":
        codes = _stratified_select(pool, n_classes, k, alpha, seed)
    else:
        raise ValueError(f"unknown codebook method: {method}")
    if codes.shape != (n_classes, n_bundles):
        raise AssertionError(f"codebook shape {codes.shape}")
    return codes.astype(np.int32)


def build_codebook_rows(n_classes: int, n_bundles: int, k: int,
                        row_start: int, row_stop: int, *,
                        alpha: float = 1.0, eps: float = 1e-6,
                        pool_size: int = 1 << 18, seed: int = 0,
                        method: str = "auto",
                        xi: Optional[np.ndarray] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> np.ndarray:
    """Rows ``[row_start, row_stop)`` of ``build_codebook(...)``: a class
    shard builds its own rows.

    The stratified method ("auto" at extreme C) computes the pool order and
    the snake picks once and gathers only the requested rows, so the (C, n)
    code matrix is never assembled; greedy and distance selections depend
    on every earlier class, so they build the whole book and slice it
    (``xi`` / ``generator`` as in ``build_codebook``).

    >>> full = build_codebook(13, 5, 2, method="stratified", seed=3)
    >>> rows = build_codebook_rows(13, 5, 2, 4, 9, method="stratified",
    ...                            seed=3)
    >>> bool(np.array_equal(rows, full[4:9]))
    True
    """
    _validate_codebook_args(n_classes, n_bundles, k)
    if not 0 <= row_start <= row_stop <= n_classes:
        raise ValueError(f"bad row range [{row_start}, {row_stop}) "
                         f"for C={n_classes}")
    pool = candidate_pool(k, n_bundles, max(pool_size, 2 * n_classes), seed)
    if pool.shape[0] < n_classes:
        raise ValueError("candidate pool smaller than number of classes")
    if _resolve_method(method, n_classes, pool.shape[0]) != "stratified":
        return build_codebook(n_classes, n_bundles, k, alpha=alpha, eps=eps,
                              pool_size=pool_size, seed=seed, method=method,
                              xi=xi, generator=generator)[row_start:row_stop]
    w = (pool.astype(np.float64) / (k - 1)) ** alpha
    picks = _stratified_picks(w.sum(axis=1), n_classes, seed)
    return pool[picks[row_start:row_stop]].astype(np.int32)


def bundle_loads(codebook, k: int, alpha: float = 1.0) -> torch.Tensor:
    """Per-bundle cumulative load L_j = sum_c U(g(B_cj)) (the Eq. 3
    objective): (C, n) codes -> (n,) float32."""
    return torch.sum(capacity(symbol_weight(torch.as_tensor(codebook), k),
                              alpha), dim=0)


def verify_unique(codebook: np.ndarray) -> bool:
    """Every class must map to a distinct code."""
    return len(np.unique(codebook, axis=0)) == codebook.shape[0]

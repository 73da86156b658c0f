"""Plain PyTorch version of the flash_attn kernels: the forward with its
log-sum-exp, and the backward from the saved log-sum-exp, in float32.  The
CPU route of ``ops.flash_attn``, and the version the kernels are held
against on the card.

q (B, S, H, d), k (B, T, KVH, d), v (B, T, KVH, dv) with H a multiple of
KVH: query head h reads KV head h // (H // KVH).  Query i sees key j iff
j < T and, when ``causal``, j <= q0 + i.
"""

from __future__ import annotations

import torch


def visible(s: int, t: int, causal: bool, q0: int, device) -> torch.Tensor:
    """(S, T) bool: which keys each query sees."""
    if not causal:
        return torch.ones((s, t), dtype=torch.bool, device=device)
    qpos = torch.arange(q0, q0 + s, device=device)
    return torch.arange(t, device=device)[None, :] <= qpos[:, None]


def _grouped(q, k, scale, causal, q0):
    """q as (B, S, KVH, g, d) in float32 and the masked (B, KVH, g, S, T)
    logits."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    mask = visible(s, t, causal, q0, q.device)
    return qf, logits.masked_fill(~mask, float("-inf"))


def flash_attn_ref(q, k, v, scale: float, *, causal: bool = True,
                   q0: int = 0):
    """(o (B, S, H * dv), lse (B, H, S)), both float32."""
    b, s, h, _ = q.shape
    _, logits = _grouped(q, k, scale, causal, q0)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, KVH, g, S)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, s, h * v.shape[-1]), lse.reshape(b, h, s)


def flash_attn_bwd_ref(do, q, k, v, o, lse, scale: float, *,
                       causal: bool = True, q0: int = 0):
    """(dq, dk, dv) in float32 of a loss whose gradient through the
    forward's o (B, S, H * dv) is ``do``, from the saved ``lse`` (B, H,
    S): P = exp(scale q k - lse), delta = rowsum(dO o), dS = P (dO v -
    delta) scale, dq = dS k, dk = dS^T q and dv = P^T dO, each KV head's
    summed over its group of query heads."""
    b, s, h, d = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    qf, logits = _grouped(q, k, scale, causal, q0)
    p = torch.exp(logits - lse.float().reshape(b, kvh, g, s)[..., None])
    dof = do.float().reshape(b, s, kvh, g, dv)
    delta = (dof * o.float().reshape(b, s, kvh, g, dv)).sum(-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()).reshape(b, s, h, d)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf)
    dvv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return dq, dk, dvv

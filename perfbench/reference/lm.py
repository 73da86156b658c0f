"""Plain reference of a decoder LM training step: the forward, the loss, its
gradients and one AdamW update, in float32 torch.

Written from the configuration file (its ``model`` object: a repeated
(attention, ffn) block; ``optimizer``; ``router_aux_weight``;
``rms_norm_eps``), with the benchmark's weights and tokens as inputs.
Parameters are a dict of float32 tensors named

  embed.table (V, D)                   final_norm (D,)
  layers.{l}.ln1, layers.{l}.ln2 (D,)  layers.{l}.attn.wq (D, H hd),
  .wk, .wv (D, KV hd), .wo (H hd, D)   layers.{l}.moe.router (D, E),
  .wi, .wg (E, D, F), .wo (E, F, D)    (or layers.{l}.mlp.wi, .wg, .wo)
  head.bundles (n, D)                  head.profiles (V, n)

and each holds values of the dtype the configuration stores it in
(``stored_dtype``): after every update the value is rounded to it, as a
bfloat16 model keeps its weights.  Everything else is float32.

  block     x += attn(rms(x, ln1)); x += ffn(rms(x, ln2))
  rms       x / sqrt(mean(x^2) + eps) * (1 + scale)
  attn      causal softmax(q k^T / sqrt(hd)) v over grouped KV heads (head
            h reads KV head h // (H / KV)), q and k rotated by split-half
            rotary angles pos * theta^(-2i / hd)
  moe       router softmax over E experts, top-k (ties to the lower
            index), gates renormalised by max(sum, 1e-9); each expert
            keeps the first ceil(cf T k / E) of the call's T tokens that
            chose it, in token-major order of the (T, k) choices, and a
            token past that capacity adds nothing; SwiGLU experts
            silu(x Wg) * (x Wi) Wo; Switch loss w E sum_e mean_prob_e *
            mean_count_e, summed over the layers
  head      LogHD logits -||x M^T - P_v||^2
  loss      mean next-token NLL + the summed Switch losses
  AdamW     global-norm clip, decoupled weight decay on every leaf, bias
            correction, linear warmup then cosine decay to 0.1 x peak

Memory: each block and each 512-row chunk of attention queries and of
the loss is recomputed in the backward (``torch.utils.checkpoint``), so
the full-size step fits beside nothing else on one card.  Every product
goes through ``arith`` (``precision.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import EXACT, Arith, full_float32

CHUNK = 512


def stored_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a configuration of `dtype` stores leaf `name` in: norm
    scales and the router in float32, the rest in `dtype`."""
    if name.endswith(("ln1", "ln2", "final_norm", "router")):
        return torch.float32
    return dtype


def store(name: str, value: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """`value` rounded to the dtype leaf `name` is stored in, as float32."""
    return value.to(stored_dtype(name, dtype)).float()


def _ck(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class Step:
    """The loss, gradients and AdamW update of one configuration file."""

    def __init__(self, cfg: dict, arith: Arith = EXACT):
        self.cfg = cfg
        self.m = cfg["model"]
        self.opt = cfg["optimizer"]
        self.arith = arith
        self.eps = cfg["rms_norm_eps"]
        self.aux_w = cfg["router_aux_weight"]
        self.dtype = getattr(torch, self.m["dtype"])

    # ------------------------------------------------------------ forward

    def rms(self, x, scale):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + scale)

    def rope(self, s: int, device):
        hd = self.m["head_dim"]
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
        ang = torch.arange(s, device=device, dtype=torch.float32)[:, None] \
            * freqs
        return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    @staticmethod
    def rotate(x, cos, sin):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, p, pre, x, rope):
        m, a = self.m, self.arith
        b, s, _ = x.shape
        h, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        q = a.mm(x, p[pre + "wq"]).view(b, s, h, hd)
        k = a.mm(x, p[pre + "wk"]).view(b, s, kv, hd)
        v = a.mm(x, p[pre + "wv"]).view(b, s, kv, hd)
        q, k = self.rotate(q, *rope), self.rotate(k, *rope)
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
        kpos = torch.arange(s, device=x.device)
        scale = 1.0 / math.sqrt(hd)

        def attend(qc, c0):
            logits = a.einsum("bshd,bthd->bhst", qc, k) * scale
            qpos = torch.arange(c0, c0 + qc.shape[1], device=x.device)
            mask = kpos[None, :] <= qpos[:, None]
            logits = logits.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            return a.einsum("bhst,bthd->bshd", probs, v)

        out = torch.cat([_ck(attend, q[:, c:c + CHUNK], c)
                         for c in range(0, s, CHUNK)], dim=1)
        return a.mm(out.reshape(b, s, h * hd), p[pre + "wo"])

    def moe(self, p, pre, x):
        """(y, Switch loss) of x (B, S, D)."""
        m, a = self.m, self.arith
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        t, e, k = xt.shape[0], m["n_experts"], m["top_k"]
        probs = torch.softmax(a.mm(xt, p[pre + "router"]), dim=-1)
        vals, experts = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
        vals, experts = vals[:, :k], experts[:, :k]
        gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        count = F.one_hot(experts, e).float().sum(1).mean(0)
        aux = self.aux_w * e * (probs.mean(0) * count).sum()
        cap = max(1, int(math.ceil(m["capacity_factor"] * t * k / e)))
        flat = experts.reshape(-1)
        slot = F.one_hot(flat, e).cumsum(0).gather(1, flat[:, None])[:, 0] - 1
        choices, outs = [], []
        for j in range(e):
            choice = torch.nonzero((flat == j) & (slot < cap))[:, 0]
            xe = xt[choice // k]
            he = F.silu(a.mm(xe, p[pre + "wg"][j])) * a.mm(xe, p[pre + "wi"][j])
            choices.append(choice)
            outs.append(a.mm(he, p[pre + "wo"][j]))
        out = xt.new_zeros((t * k, d)).index_put((torch.cat(choices),),
                                                 torch.cat(outs))
        y = (out.view(t, k, d) * gates[..., None]).sum(1)
        return y.view(b, s, d), aux

    def mlp(self, p, pre, x):
        a = self.arith
        return a.mm(F.silu(a.mm(x, p[pre + "wg"])) * a.mm(x, p[pre + "wi"]),
                    p[pre + "wo"])

    def block(self, p, layer, x, rope):
        pre = f"layers.{layer}."
        x = x + self.attention(p, pre + "attn.", self.rms(x, p[pre + "ln1"]),
                               rope)
        spec = self.m["pattern"][0]
        if spec["ffn"] == "moe":
            y, aux = self.moe(p, pre + "moe.", self.rms(x, p[pre + "ln2"]))
        else:
            y = self.mlp(p, pre + "mlp.", self.rms(x, p[pre + "ln2"]))
            aux = x.new_zeros(())
        return x + y, aux

    def head_nll(self, p, x, targets):
        """Summed NLL of the LogHD logits of x (B, c, D)."""
        a = self.arith
        bundles, profiles = p["head.bundles"], p["head.profiles"]
        acts = a.mm(x, bundles.T)
        logits = (2.0 * a.mm(acts, profiles.T)
                  - (profiles * profiles).sum(-1)
                  - (acts * acts).sum(-1, keepdim=True))
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        return (lse - tgt).sum()

    def loss(self, p: dict, tokens: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
        """Mean next-token NLL of (B, S) tokens plus the Switch losses."""
        spec = self.m["pattern"]
        if (len(spec) != 1 or spec[0]["mixer"] != "attn"
                or self.m.get("n_prefix", 0)
                or self.m["head"] != "loghd"):
            raise ValueError("the reference runs one repeated (attn, ffn) "
                             "block with the LogHD head")
        tokens, targets = tokens.long(), targets.long()
        b, s = tokens.shape
        x = p["embed.table"][tokens]
        rope = self.rope(s, x.device)
        aux = x.new_zeros(())
        for layer in range(self.m["n_periods"]):
            x, a_l = _ck(self.block, p, layer, x, rope)
            aux = aux + a_l
        x = self.rms(x, p["final_norm"])
        total = x.new_zeros(())
        for c in range(0, s, CHUNK):
            total = total + _ck(self.head_nll, p, x[:, c:c + CHUNK],
                                targets[:, c:c + CHUNK])
        return total / (b * s) + aux

    def grads(self, p: dict, tokens, targets):
        """(loss, {name: gradient}) at parameters `p`."""
        with full_float32():
            leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
            loss = self.loss(leaves, tokens, targets)
            names = list(leaves)
            g = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, g))

    # ----------------------------------------------------------- optimizer

    def lr(self, step: int) -> float:
        """The learning rate of 0-based `step`."""
        o = self.opt
        peak, warm, total = o["peak_lr"], o["warmup_steps"], o["total_steps"]
        if step < warm:
            return peak * step / max(warm, 1)
        prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))

    def init_opt(self, p: dict) -> dict:
        return {"step": 0,
                "mu": {n: torch.zeros_like(v) for n, v in p.items()},
                "nu": {n: torch.zeros_like(v) for n, v in p.items()}}

    @torch.no_grad()
    def update(self, p: dict, grads: dict, state: dict, lr: float) -> None:
        """One AdamW step on `p` and `state`, in place."""
        o = self.opt
        t = state["step"] + 1
        gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                               for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0).float()
        b1, b2 = o["b1"], o["b2"]
        for n in p:
            g = grads[n] * scale
            mu = state["mu"][n].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][n].mul_(b2).add_((1 - b2) * g * g)
            upd = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                         + o["eps"])
            new = p[n] - lr * (upd + o["weight_decay"] * p[n])
            p[n] = store(n, new, self.dtype)
        state["step"] = t

    def train(self, p: dict, batches, first: int = 0):
        """Steps first, first + 1, ... over `batches` (an iterable of (tokens,
        targets)), in place; yields (loss, grads, state) after each."""
        state = self.init_opt(p)
        for i, (tokens, targets) in enumerate(batches):
            loss, g = self.grads(p, tokens, targets)
            self.update(p, g, state, self.lr(first + i))
            yield loss, g, state

"""Plain reference of a DeepSeek-V3 training step on one chip's share of
expert parallelism: the forward, the loss, its gradients, one AdamW update
and the router-bias update, in float32 torch.

Written from the configuration file (``configs/deepseek-v3-ep32-loghd.json``:
its ``model`` object, ``optimizer`` and ``rms_norm_eps``), with the
benchmark's weights and tokens as inputs; it shares ``lm.Step``'s norm,
split-half rotation, LogHD head and learning rate.  Products run in full
float32 (``full_float32`` turns the card's TF32 off:
``torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
False``), every one through ``arith`` (``precision.py``).  Parameters are
a dict of float32 tensors named

  embed.table (V, D)          final_norm (D,)       head.bundles (n, D)
  head.profiles (V, n)        layers.{l}.ln1, .ln2 (D,), every layer l
  layers.{l}.mla.wq_a (D, Lq), .q_a_norm (Lq,), .wq_b (Lq, H (Dn + Dr)),
      .wkv_a (D, Lkv + Dr), .kv_a_norm (Lkv,), .wkv_b (Lkv, H (Dn + Dv)),
      .wo (H Dv, D)
  layers.{l}.mlp.wi, .wg (D, F), .wo (F, D)         l < n_prefix (dense)
  layers.{l}.moe.router (D, Er), .wi, .wg (Eh, D, Fe), .wo (Eh, Fe, D),
      .shared_wi, .shared_wg (D, Fs), .shared_wo (Fs, D)   the MoE layers

each holding values of the dtype the configuration stores it in
(``stored_dtype``), and beside them the router biases, one (Er,) float32
vector a MoE layer, keyed by layer.

  block   x += mla(rms(x, ln1)); x += ffn(rms(x, ln2))
  mla     c_q = rms(x Wq_a, q_a_norm); [q_nope | q_rope] = c_q Wq_b a head;
          [c_kv | k_rope] = x Wkv_a; c_kv = rms(c_kv, kv_a_norm);
          [k_nope | v] = c_kv Wkv_b a head; q_rope and k_rope (one for
          every head) rotated by YaRN's table; causal softmax(q k^T *
          scale) v with q = [q_nope | q_rope], k = [k_nope | k_rope]; Wo
  yarn    inverse frequencies theta^(-2i/Dr) blended with the same over
          `factor` by a linear ramp from dim floor(c(beta_fast)) to
          ceil(c(beta_slow)), c(n) = Dr ln(L0 / (2 pi n)) / (2 ln theta);
          cos and sin times m(mscale) / m(mscale_all_dim), m(a) = 0.1 a
          ln(factor) + 1; scale (Dn + Dr)^-0.5 m(mscale_all_dim)^2
  dense   silu(x Wg) * (x Wi) Wo; the shared expert likewise
  router  s = sigmoid(x W_r) over all Er experts; choice scores s + b; a
          group's score the sum of its two best choice scores; the best
          topk_group of n_group groups kept; the top-k experts among
          theirs (ties to the lower index); gates the chosen s over their
          sum (+1e-20) times routed_scaling_factor
  moe     the held experts' part: held expert j keeps the first cap =
          ceil(cf T k / Er) of the call's choices of it, in token-major
          order, and adds gate * silu(x Wg_j) * (x Wi_j) Wo_j to their
          tokens; plus the shared expert on every token
  balance a sequence's f_i = Er / (k S) x its choices of i, P_i = mean
          over it of s_i / sum_j s_j; balance_weight sum_i f_i P_i, the
          mean over the sequences, summed over the layers
  head    LogHD logits -||x M^T - P_v||^2
  loss    mean next-token NLL + the balance losses
  AdamW   global-norm clip, decoupled weight decay on every leaf, bias
          correction, linear warmup then cosine decay to 0.1 x peak
  bias    after the update, b_i += bias_update_rate sign(mean load -
          load_i), load_i the step's choices of expert i (all Er, before
          the capacity)

Departures from the published model, all the configuration's own: the
rotation is split-half, DeepSeek's rotates interleaved pairs (a fixed
permutation of the rope channels of Wq_b and Wkv_a, which random weights
do not see); each expert has a capacity (the published training drops no
token; cf 1.25 here, as the program); MTP is left out; the LogHD head
replaces the untied dense head; only the held experts' part of each MoE
layer is computed (8 of 256 at the cell's size), as on one chip of the
deployment.

Memory: in float32 the weights, gradients and two AdamW moments of the
cell's 3.85 B parameters take 61.7 GB, more than fits beside the
activations on one card.  The moments stay on the host, and each leaf's
update moves its two moments to the card and back, a slice of at most
``SLICE`` elements at a time (the embedding's float32 temporaries whole
would take 3.7 GB each), writing the weights in place; each block, each
256-query chunk of attention and each 512-row chunk of the loss are
recomputed in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import lm
from perfbench.reference.precision import EXACT, Arith, full_float32

CHUNK = 512          # rows of the loss a checkpointed chunk
ATTN_CHUNK = 256     # attention queries a checkpointed chunk
SLICE = 1 << 26      # elements of a leaf AdamW updates at a time
_FLOAT32 = ("ln1", "ln2", "final_norm", "router", "q_a_norm", "kv_a_norm")


def stored_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """Norm scales and the router in float32, the rest in `dtype`."""
    return torch.float32 if name.endswith(_FLOAT32) else dtype


def store(name: str, value: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    return value.to(stored_dtype(name, dtype)).float()


def top_k(values: torch.Tensor, k: int):
    """The k largest along the last axis, in descending order, equal
    values in the order of their indices."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def yarn_m(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(m: dict, device=None) -> torch.Tensor:
    """The rope's inverse frequencies, YaRN's where ``yarn_factor`` > 0."""
    r, theta = m["mla_rope_dim"], m["rope_theta"]
    pw = theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                device=device) / r)
    f = m.get("yarn_factor", 0.0)
    if not f:
        return 1.0 / pw

    def corr(rot):
        return r * math.log(m["yarn_original_max_position"]
                            / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr(m["yarn_beta_slow"])), r - 1)
    ramp = torch.clamp((torch.arange(r // 2, dtype=torch.float32,
                                     device=device) - low)
                       / ((high if high != low else high + 0.001) - low),
                       0, 1)
    mask = 1.0 - ramp
    return (1.0 / (f * pw)) * (1.0 - mask) + (1.0 / pw) * mask


def softmax_scale(m: dict) -> float:
    scale = (m["mla_nope_dim"] + m["mla_rope_dim"]) ** -0.5
    f, all_dim = m.get("yarn_factor", 0.0), m.get("yarn_mscale_all_dim", 0)
    return scale * yarn_m(f, all_dim) ** 2 if f and all_dim else scale


def swiglu(a: Arith, x, wi, wg, wo):
    return a.mm(F.silu(a.mm(x, wg)) * a.mm(x, wi), wo)


class Step(lm.Step):
    """The loss, gradients, AdamW and bias updates of a DeepSeek-V3
    configuration file (one dense-prefix position, one MoE pattern
    position, MLA in every layer, the LogHD head)."""

    def __init__(self, cfg: dict, arith: Arith = EXACT):
        m = cfg["model"]
        if ([b["mixer"] for b in m["prefix_pattern"] + m["pattern"]]
                != ["mla", "mla"] or m["prefix_pattern"][0]["ffn"] != "dense"
                or m["pattern"][0]["ffn"] != "moe" or m["head"] != "loghd"
                or m["router"] != "sigmoid_group"):
            raise ValueError("the reference runs MLA blocks, dense then MoE "
                             "with the sigmoid group router, and the LogHD "
                             "head")
        self.cfg, self.m, self.opt, self.arith = cfg, m, cfg["optimizer"], \
            arith
        self.eps = cfg["rms_norm_eps"]
        self.dtype = getattr(torch, m["dtype"])
        self.n_prefix = m["n_prefix"]
        self.n_layers = m["n_prefix"] + m["n_periods"]
        self.loads: dict = {}      # MoE layer -> its (Er,) load, last call
        self.held: dict = {}       # MoE layer -> (held, dropped) choices

    def moe_layers(self) -> range:
        return range(self.n_prefix, self.n_layers)

    # ------------------------------------------------------------ forward

    def rope(self, s: int, device):
        inv = yarn_inv_freq(self.m, device)
        ang = torch.arange(s, device=device, dtype=torch.float32)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        f = self.m.get("yarn_factor", 0.0)
        af = (yarn_m(f, self.m["yarn_mscale"])
              / yarn_m(f, self.m["yarn_mscale_all_dim"])) if f else 1.0
        return (cos * af, sin * af) if af != 1.0 else (cos, sin)

    def mla(self, p, pre, x, rope):
        m, a = self.m, self.arith
        b, s, _ = x.shape
        h, dn, dr, dv = (m["n_heads"], m["mla_nope_dim"], m["mla_rope_dim"],
                         m["mla_v_dim"])
        cq = self.rms(a.mm(x, p[pre + "wq_a"]), p[pre + "q_a_norm"])
        q = a.mm(cq, p[pre + "wq_b"]).view(b, s, h, dn + dr)
        c_kv, k_rope = a.mm(x, p[pre + "wkv_a"]).split(
            [m["mla_kv_lora"], dr], dim=-1)
        c_kv = self.rms(c_kv, p[pre + "kv_a_norm"])
        k_nope, v = a.mm(c_kv, p[pre + "wkv_b"]).view(
            b, s, h, dn + dv).split([dn, dv], dim=-1)
        q = torch.cat([q[..., :dn], self.rotate(q[..., dn:], *rope)], dim=-1)
        k_rope = self.rotate(k_rope[:, :, None, :], *rope)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        kpos = torch.arange(s, device=x.device)
        scale = softmax_scale(m)

        def attend(qc, c0):
            logits = a.einsum("bshd,bthd->bhst", qc, k) * scale
            qpos = torch.arange(c0, c0 + qc.shape[1], device=x.device)
            logits = logits.masked_fill(kpos[None, :] > qpos[:, None],
                                        float("-inf"))
            return a.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v)

        out = torch.cat([lm._ck(attend, q[:, c:c + ATTN_CHUNK], c)
                         for c in range(0, s, ATTN_CHUNK)], dim=1)
        return a.mm(out.reshape(b, s, h * dv), p[pre + "wo"])

    def route(self, router, xt, bias, seq: int):
        """(experts (T, k), gates (T, k), balance loss, load (Er,)) of
        tokens xt (T, D) in sequences of `seq`."""
        m = self.m
        t, e, k, g = xt.shape[0], m["n_routed_experts"], m["top_k"], \
            m["n_group"]
        s = torch.sigmoid(self.arith.mm(xt, router))
        choice = s.detach() + bias
        best2 = top_k(choice.view(t, g, e // g), 2)[0].sum(-1)
        groups = top_k(best2, m["topk_group"])[1]
        kept = torch.zeros_like(best2, dtype=torch.bool).scatter(
            1, groups, True).repeat_interleave(e // g, dim=1)
        experts = top_k(choice.masked_fill(~kept, float("-inf")), k)[1]
        gates = s.gather(1, experts)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) \
            * m["routed_scaling_factor"]
        n_seq = t // seq
        counts = F.one_hot(experts, e).float().view(n_seq, seq * k, e).sum(1)
        share = (s / s.sum(-1, keepdim=True)).view(n_seq, seq, e).mean(1)
        aux = m["balance_weight"] * (counts * (e / (k * seq))
                                     * share).sum(-1).mean()
        return experts, gates, aux, counts.sum(0)

    def routed(self, xt, experts, gates, wi, wg, wo, offset: int):
        """The part of the routed result that experts offset ..
        offset + len(wi) - 1 give, and (held, dropped) choices."""
        m = self.m
        t, k, e = xt.shape[0], m["top_k"], m["n_routed_experts"]
        cap = max(1, int(math.ceil(m["capacity_factor"] * t * k / e)))
        flat, gflat = experts.reshape(-1), gates.reshape(-1)
        y = torch.zeros_like(xt)
        held = dropped = 0
        for j in range(wi.shape[0]):
            choice = torch.nonzero(flat == offset + j)[:, 0]
            held += choice.numel()
            dropped += max(choice.numel() - cap, 0)
            choice = choice[:cap]
            tok = choice // k
            out = swiglu(self.arith, xt[tok], wi[j], wg[j], wo[j])
            y = y.index_add(0, tok, out * gflat[choice][:, None])
        return y, (held, dropped)

    def moe(self, p, pre, x, bias, layer):
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        experts, gates, aux, load = self.route(p[pre + "router"], xt, bias, s)
        y, self.held[layer] = self.routed(
            xt, experts, gates, p[pre + "wi"], p[pre + "wg"], p[pre + "wo"],
            self.m.get("held_offset", 0))
        # assigned, not added: remat's recomputation writes the same
        self.loads[layer] = load.detach()
        y = y + swiglu(self.arith, xt, p[pre + "shared_wi"],
                       p[pre + "shared_wg"], p[pre + "shared_wo"])
        return y.view(b, s, d), aux

    def block(self, p, biases, layer, x, rope):
        pre = f"layers.{layer}."
        x = x + self.mla(p, pre + "mla.", self.rms(x, p[pre + "ln1"]), rope)
        h = self.rms(x, p[pre + "ln2"])
        if layer < self.n_prefix:
            return x + swiglu(self.arith, h, p[pre + "mlp.wi"],
                              p[pre + "mlp.wg"], p[pre + "mlp.wo"]), \
                x.new_zeros(())
        y, aux = self.moe(p, pre + "moe.", h, biases[layer], layer)
        return x + y, aux

    def loss(self, p: dict, biases: dict, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL of (B, S) tokens plus the balance losses."""
        tokens, targets = tokens.long(), targets.long()
        b, s = tokens.shape
        x = p["embed.table"][tokens]
        rope = self.rope(s, x.device)
        aux = x.new_zeros(())
        for layer in range(self.n_layers):
            x, a_l = lm._ck(self.block, p, biases, layer, x, rope)
            aux = aux + a_l
        x = self.rms(x, p["final_norm"])
        total = x.new_zeros(())
        for c in range(0, s, CHUNK):
            total = total + lm._ck(self.head_nll, p, x[:, c:c + CHUNK],
                                   targets[:, c:c + CHUNK])
        return total / (b * s) + aux

    def grads(self, p: dict, biases: dict, tokens, targets):
        """(loss, {name: gradient}) at parameters `p` and router biases
        `biases`; ``self.loads`` then holds the call's loads."""
        with full_float32():
            leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
            loss = self.loss(leaves, biases, tokens, targets)
            names = list(leaves)
            g = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, g))

    # ----------------------------------------------------------- updates

    def init_opt(self, p: dict) -> dict:
        """AdamW's state, its moments in float32 on the host."""
        def zeros(v):
            return torch.zeros(v.shape, dtype=torch.float32, device="cpu")
        return {"step": 0, "mu": {n: zeros(v) for n, v in p.items()},
                "nu": {n: zeros(v) for n, v in p.items()}}

    @torch.no_grad()
    def update(self, p: dict, grads: dict, state: dict, lr: float) -> None:
        """One AdamW step on `p` and `state`, in place, a slice of at most
        ``SLICE`` elements of a leaf at a time; it consumes `grads`."""
        o = self.opt
        t = state["step"] + 1
        gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                               for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                            max=1.0).float()
        b1, b2 = o["b1"], o["b2"]
        for n in list(p):
            g_all, w = grads.pop(n), p[n]
            rows = max(1, SLICE // max(w[0].numel(), 1))
            for r in range(0, w.shape[0], rows):
                sl = slice(r, r + rows)
                g = g_all[sl] * scale
                mu = state["mu"][n][sl].to(g.device).mul_(b1).add_(
                    (1 - b1) * g)
                nu = state["nu"][n][sl].to(g.device).mul_(b2).add_(
                    (1 - b2) * g * g)
                upd = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                             + o["eps"])
                w[sl] = store(n, w[sl] - lr * (upd + o["weight_decay"]
                                               * w[sl]), self.dtype)
                state["mu"][n][sl] = mu
                state["nu"][n][sl] = nu
                del g, mu, nu, upd
            del g_all
        state["step"] = t

    def update_biases(self, biases: dict) -> None:
        """b += gamma * sign(mean load - load), from the last call's loads."""
        gamma = self.m["bias_update_rate"]
        for layer in self.moe_layers():
            load = self.loads[layer]
            biases[layer] = biases[layer] + gamma * torch.sign(
                load.mean() - load)

    def init_biases(self, device) -> dict:
        return {layer: torch.zeros(self.m["n_routed_experts"],
                                   dtype=torch.float32, device=device)
                for layer in self.moe_layers()}

    def train(self, p: dict, biases: dict, batches, first: int = 0):
        """Steps first, first + 1, ... over `batches` ((tokens, targets)
        pairs), `p` and `biases` updated in place; yields (loss, grads,
        state) after each."""
        state = self.init_opt(p)
        for i, (tokens, targets) in enumerate(batches):
            loss, g = self.grads(p, biases, tokens, targets)
            self.update(p, g, state, self.lr(first + i))
            self.update_biases(biases)
            yield loss, g, state

"""Mixture-of-Experts ffn with expert parallelism (port of
``repro.models.moe``).

Used by deepseek-v3 (256 routed experts and one shared, top-8),
granite-moe (32 experts, top-8) and jamba (16 experts, top-2).

Routing is top-k over the softmax of a float32 router (the contraction in
x's dtype, its result cast to float32), ties to the lower expert index;
the k gates are renormalised by max(sum, 1e-9).  The Switch
load-balancing loss is ``router_aux_weight * E * sum_e mean_prob_e *
mean_count_e``.  Each expert takes at most ``cap = ceil(capacity_factor *
T * top_k / E)`` tokens of the call's T, in the order of the token-major
flattened (T * k) choices (each choice's slot counts the earlier choices
of its expert: the ``moe_slots`` kernel on the card, the reference's
one-hot cumsum on the CPU); a token past its expert's capacity falls
through the residual.  The kept tokens are scattered into (E, cap, D)
buffers, every expert runs its SwiGLU on its whole buffer (dense batched
products, as the reference computes them outside any kernel), and each
token's k outputs are gathered back and summed with their gates.

The capacity counts every token of the call, so a decode step (T = B)
and a forward (T = B * S) can drop different tokens, in the reference
too; with ``capacity_factor = E / top_k`` nothing is dropped.

Expert parallelism (``moe_block(moe, x, mesh)``, ``moe.py:147-215``): the
experts are split over the mesh's "model" axis, E / M a rank, and each
rank's expert matrices are gathered over "data" (the FSDP axis) before
its body runs.  The tokens enter split over the dp axes that divide B and,
where S divides, over "model"; each rank routes its local tokens (the
capacity counts them, so a sharded call can drop other tokens than an
unsharded one, in both packages), sends each expert's buffer to its owner
with one shape-preserving ``all_to_all`` on the "model" group, runs its
experts over the (E / M, M * cap, D) buffers it received, and sends the
outputs back with a second one.  The Switch loss is each rank's own,
averaged over the mesh.  The shared expert runs outside the body on
DTensors, as the reference computes it outside its ``shard_map``.

DeepSeek-V3's router and a held share of the experts (port only; the
settings of ``configs.PortModelConfig``, whose defaults are the above):

  * ``router="sigmoid_group"`` (arXiv:2412.19437 §2.1.2, ``noaux_tc``):
    s = sigmoid(x W_r) in float32 over all ``n_routed_experts``; choice
    scores s + b with ``router_bias`` b, a float32 buffer that chooses and
    is no parameter; a group's score is the sum of its two best choice
    scores, the best ``topk_group`` of ``n_group`` groups are kept, and
    the top-k experts among their experts taken (ties to the lower index;
    the others are masked to -inf); the gates are the chosen unbiased s,
    divided by their sum (+1e-20) and scaled by
    ``routed_scaling_factor``.  The auxiliary loss is the sequence-wise
    balance loss (Eqs. 17-20), ``balance_weight`` * sum_i f_i P_i a
    sequence, averaged over the sequences, with f_i = E / (k S) x the
    sequence's choices of expert i and P_i the mean of s_i / sum_j s_j.
  * ``update_router_biases(model)``, after each training step: b_i +=
    ``bias_update_rate`` * sign(mean load - load_i), load_i the choices of
    expert i since the last update.  The loads are counted in a training
    forward and not in remat's recomputation (``replay``), which routes
    with the same b.
  * A held share (with DeepSeek's router only; the softmax router holds
    every expert it routes to): the layer holds experts ``held_offset`` ..
    ``held_offset + n_experts - 1`` of the ``n_routed_experts`` the router
    scores, and computes only their part of the result.  The capacity
    counts every routed expert, ceil(cf T k / n_routed_experts), so each
    held expert's slots are the ones the whole layer gives it.  Dispatch
    and combine touch only the choices on held experts: an (n_experts,
    cap) table of token indices built from ``moe_slots``' slots gathers
    the rows, and the gated outputs are added back with ``index_add``;
    nothing of size (T k, D) is made.  Nothing stands in for the absent
    experts: their part is left out.  ``moe_block``'s mesh path raises on
    such a layer.
  * Counters, summed on the device (no host sync in the step) and read by
    ``routing_counters``: the choices on held experts, those of them the
    capacity dropped, and each routed expert's load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.moe_slots import moe_slots
from repro_torch.models import sharding as shd
from repro_torch.models.layers import normal_
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int               # experts this layer holds
    top_k: int
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0    # deepseek: one always-on shared expert
    router_aux_weight: float = 0.01
    # DeepSeek-V3's router and a held share (see the module docstring)
    router: str = "softmax"      # "softmax" | "sigmoid_group"
    n_routed_experts: int = 0    # experts the router scores; 0: n_experts
    held_offset: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    balance_weight: float = 0.0
    bias_update_rate: float = 0.0

    @property
    def n_routed(self) -> int:
        return self.n_routed_experts or self.n_experts

    @property
    def held_share(self) -> bool:
        """Whether the layer takes the held-expert dispatch: DeepSeek's
        router (the softmax router holds every expert it routes to)."""
        return self.router == "sigmoid_group"

    def capacity(self, tokens: int) -> int:
        """Slots per expert for a call of `tokens` tokens
        (``moe.py:97``, the same float expression), over every routed
        expert."""
        return max(1, int(math.ceil(self.capacity_factor * tokens
                                    * self.top_k / self.n_routed)))


_REPLAY = threading.local()


@contextlib.contextmanager
def replay():
    """Marks remat's recomputation of a block on this thread: the routing
    counts nothing inside it."""
    was = getattr(_REPLAY, "on", False)
    _REPLAY.on = True
    try:
        yield
    finally:
        _REPLAY.on = was


def _counting() -> bool:
    """A training forward, not its recomputation."""
    return torch.is_grad_enabled() and not getattr(_REPLAY, "on", False)


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing: the (T, k) chosen experts, their renormalised
    gates, each choice's slot in its expert's buffer and whether it fits
    under the capacity, and the auxiliary loss."""
    experts: torch.Tensor        # (T, k) int64
    gates: torch.Tensor          # (T, k) float32
    slots: torch.Tensor          # (T * k,) int64, cap - 1 where dropped
    keep: torch.Tensor           # (T * k,) bool
    cap: int
    aux: torch.Tensor            # () float32


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, equal values in the order of their indices."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    """Parameters in the reference's layout: router (D, E) float32, wi / wg
    (E, D, F), wo (E, F, D), and with a shared expert shared_wi /
    shared_wg (D, Fs), shared_wo (Fs, D)."""

    def __init__(self, cfg: MoEConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty(d, cfg.n_routed,
                                               device=device,
                                               dtype=torch.float32))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wg = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))
        if cfg.shared_expert_ff:
            fs = cfg.shared_expert_ff
            self.shared_wi = nn.Parameter(torch.empty(d, fs, **kw))
            self.shared_wg = nn.Parameter(torch.empty(d, fs, **kw))
            self.shared_wo = nn.Parameter(torch.empty(fs, d, **kw))
        if cfg.router == "sigmoid_group":
            def zeros(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=device)
            self.register_buffer("router_bias",
                                 zeros(cfg.n_routed, dtype=torch.float32))
            for name, shape in (("step_load", (cfg.n_routed,)),
                                ("load_count", (cfg.n_routed,)),
                                ("held_count", ()), ("drop_count", ())):
                self.register_buffer(name, zeros(*shape), persistent=False)
        elif cfg.router != "softmax":
            raise ValueError(f"unknown router {cfg.router!r}")
        elif cfg.n_routed != cfg.n_experts:
            raise ValueError(f"the softmax router holds every expert it "
                             f"routes to: {cfg.n_experts} held of "
                             f"{cfg.n_routed}")

    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales (``moe.py:45-59``).  Expert leaves are
        drawn one expert at a time, so the float32 draft of a draw is one
        expert's (deepseek's (256, 7168, 2048) leaf would need 15 GB)."""
        s_in = 1.0 / math.sqrt(self.cfg.d_model)
        s_out = 1.0 / math.sqrt(self.cfg.d_ff)
        normal_(self.router, gen, s_in)
        for w, s in ((self.wi, s_in), (self.wg, s_in), (self.wo, s_out)):
            for e in range(w.shape[0]):
                normal_(w[e], gen, s)
        if self.cfg.shared_expert_ff:
            normal_(self.shared_wi, gen, s_in)
            normal_(self.shared_wg, gen, s_in)
            normal_(self.shared_wo, gen,
                    1.0 / math.sqrt(self.cfg.shared_expert_ff))

    def route(self, x: torch.Tensor, router=None, seq_len=None) -> Routing:
        """Routing of x (T, D) (``moe.py:83-103``), by `router` (default
        the module's); DeepSeek's router reads x as sequences of `seq_len`
        tokens (None: one sequence)."""
        with span("repro_torch.moe.route"):
            if self.cfg.router == "sigmoid_group":
                return self._route_grouped(x, router, seq_len or x.shape[0])
            cfg = self.cfg
            t, e = x.shape[0], cfg.n_experts
            router = self.router if router is None else router
            logits = (x @ router.to(x.dtype)).float()
            probs = torch.softmax(logits, dim=-1)
            gates, experts = top_k(probs, cfg.top_k)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            me = probs.mean(0)
            ce = F.one_hot(experts, e).float().sum(1).mean(0)
            aux = cfg.router_aux_weight * e * (me * ce).sum()
            cap = cfg.capacity(t)
            slots, keep = moe_slots(experts.reshape(-1), e, cap)
            return Routing(experts, gates, slots, keep, cap, aux)

    def _route_grouped(self, x: torch.Tensor, router, seq: int) -> Routing:
        """DeepSeek-V3's group-limited sigmoid routing (module docstring)."""
        cfg = self.cfg
        t, e, k, g = x.shape[0], cfg.n_routed, cfg.top_k, cfg.n_group
        router = self.router if router is None else router
        s = torch.sigmoid(x.float() @ router.float())             # (T, E)
        choice = s.detach() + self.router_bias
        best2 = top_k(choice.view(t, g, e // g), 2)[0].sum(-1)     # (T, G)
        groups = top_k(best2, cfg.topk_group)[1]
        kept = torch.zeros_like(best2, dtype=torch.bool).scatter_(
            1, groups, True)
        kept = kept[:, :, None].expand(t, g, e // g).reshape(t, e)
        experts = top_k(choice.masked_fill(~kept, -math.inf), k)[1]
        gates = s.gather(1, experts)
        gates = (gates / (gates.sum(-1, keepdim=True) + 1e-20)
                 * cfg.routed_scaling_factor)
        # the sequence-wise balance loss: f_i P_i a sequence
        n_seq = t // seq
        row = torch.arange(t, device=x.device)[:, None] // seq
        counts = s.new_zeros(n_seq * e).scatter_add_(
            0, (row * e + experts).reshape(-1),
            s.new_ones(t * k)).view(n_seq, e)
        share = (s / s.sum(-1, keepdim=True)).view(n_seq, seq, e).mean(1)
        aux = cfg.balance_weight * (
            counts * (e / (k * seq)) * share).sum(-1).mean()
        if _counting():
            load = counts.sum(0).long()
            self.step_load += load
            self.load_count += load
        cap = cfg.capacity(t)
        slots, keep = moe_slots(experts.reshape(-1), e, cap)
        return Routing(experts, gates, slots, keep, cap, aux)

    def experts_ffn(self, buf: torch.Tensor, wi=None, wg=None,
                    wo=None) -> torch.Tensor:
        """Every expert's SwiGLU over its (cap, D) buffer: (E, cap, D), by
        the given expert matrices (default the module's)."""
        wi = self.wi if wi is None else wi
        wg = self.wg if wg is None else wg
        wo = self.wo if wo is None else wo
        g = F.silu(torch.bmm(buf, wg))
        return torch.bmm(g * torch.bmm(buf, wi), wo)

    def routed(self, xt: torch.Tensor, router=None, experts=None,
               exchange=None, seq_len=None):
        """The routed experts over local tokens xt (T, D): (y (T, D), aux).
        `experts` (wi, wg, wo) are the experts this rank runs and
        `exchange(buf, back)` moves the (E, cap, D) buffers to their
        owners and back (None: every expert here, no exchange)."""
        cfg = self.cfg
        d = xt.shape[1]
        r = self.route(xt, router, seq_len)
        if cfg.held_share:
            with span("repro_torch.moe.experts"):
                return self._held(xt, r), r.aux
        with span("repro_torch.moe.experts"):
            flat = r.experts.reshape(-1)
            keep = r.keep[:, None]
            x_rep = torch.repeat_interleave(xt, cfg.top_k, dim=0)  # (T*K, D)
            # a dropped choice adds zeros to its expert's last slot: the
            # reference's scatter-add, a plain copy for every kept token
            buf = xt.new_zeros((cfg.n_experts, r.cap, d)).index_put(
                (flat, r.slots), torch.where(keep, x_rep, 0),
                accumulate=True)
            if exchange is not None:
                buf = exchange(buf, back=False)
            out = self.experts_ffn(buf, *(experts or ()))
            if exchange is not None:
                out = exchange(out, back=True)
            y_tok = torch.where(keep, out[flat, r.slots], 0)
            y = (y_tok.reshape(-1, cfg.top_k, d)
                 * r.gates[..., None].to(y_tok.dtype)).sum(1)
        return y, r.aux

    def _held(self, xt: torch.Tensor, r: Routing) -> torch.Tensor:
        """The held experts' part of the routed result (module docstring):
        (T, D), zero for tokens none of whose kept choices is held."""
        cfg = self.cfg
        (t, d), n, cap, k = xt.shape, cfg.n_experts, r.cap, cfg.top_k
        local = r.experts.reshape(-1) - cfg.held_offset
        held = (local >= 0) & (local < n)
        ok = held & r.keep
        # each kept held choice's (expert, slot) cell; the rest to a spill
        # cell n * cap, cut off below
        cell = torch.where(ok, local * cap + r.slots, n * cap)
        token = torch.arange(t * k, device=xt.device) // k
        table = token.new_zeros(n * cap + 1).index_put_((cell,), token)
        gate = r.gates.new_zeros(n * cap + 1).index_put(
            (cell,), r.gates.reshape(-1))
        table, gate = table[:n * cap], gate[:n * cap]
        # an empty cell reads token 0 and is weighted 0
        out = self.experts_ffn(xt[table].view(n, cap, d))
        if _counting():
            self.held_count += held.sum()
            self.drop_count += (held & ~r.keep).sum()
        return xt.new_zeros((t, d)).index_add(
            0, table, out.view(n * cap, d) * gate[:, None].to(out.dtype))

    def update_bias(self) -> None:
        """b += gamma * sign(mean load - load) over the loads counted since
        the last update, which it clears."""
        with torch.no_grad():
            load = self.step_load.float()
            self.router_bias.add_(torch.sign(load.mean() - load),
                                  alpha=self.cfg.bias_update_rate)
            self.step_load.zero_()

    def shared(self, x):
        """The shared expert's SwiGLU (x may be a DTensor)."""
        with span("repro_torch.moe.shared"):
            sg = F.silu(x @ shd.fsdp(self.shared_wg))
            return ((sg * (x @ shd.fsdp(self.shared_wi)))
                    @ shd.fsdp(self.shared_wo))

    def forward(self, x: torch.Tensor):
        """x (B, S, D) -> (y (B, S, D), aux loss () float32)."""
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        y, aux = self.routed(xt, seq_len=s)
        if self.cfg.shared_expert_ff:
            y = y + self.shared(xt)
        return y.reshape(b, s, d), aux


def moe_block(moe: MoE, x: torch.Tensor, mesh=None):
    """The reference's ``moe_block``: ``moe(x)`` without a mesh (or on a
    mesh of one rank without a process group, or without a "model"
    axis); with one, expert parallelism over "model" (see the module
    docstring).  x (B, S, D) is a DTensor or the global tensor on every
    rank; y comes back a DTensor on x's layout, aux a float32 scalar, the
    same on every rank."""
    if (mesh is None or mesh.device_mesh is None
            or "model" not in mesh.axis_names):
        return moe(x)
    if moe.cfg.held_share:
        raise ValueError("the expert-parallel mesh path runs the softmax "
                         "router with every expert held; this layer has "
                         f"router {moe.cfg.router!r}, {moe.cfg.n_experts} "
                         f"of {moe.cfg.n_routed} experts")
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    import torch.distributed._functional_collectives as funcol
    cfg = moe.cfg
    dm = mesh.device_mesh
    nd = len(mesh.axis_names)
    n_ep = mesh.shape["model"]
    if cfg.n_experts % n_ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over a "
                         f"model axis of {n_ep}")
    e_loc = cfg.n_experts // n_ep
    rep = [Replicate()] * nd

    def dt(t):
        return t if shd.is_dtensor(t) else DTensor.from_local(
            t, dm, rep, run_check=False)

    xd = dt(x)
    b, s, d = xd.shape
    # tokens over the dp axes that divide B and, where S divides, "model"
    seq = "model" if s % n_ep == 0 and s >= n_ep else None
    x_pl = shd.placements(shd.P(shd.dp_for_batch(mesh, b), seq, None), mesh)
    split = [p.is_shard() for p in x_pl]
    if torch.is_grad_enabled() and not all(split):
        raise ValueError(f"expert-parallel training needs the tokens "
                         f"({b}, {s}) split over every mesh axis "
                         f"{mesh.shape}")
    model_dim = mesh.dim("model")
    xl = xd.redistribute(dm, x_pl).to_local(grad_placements=x_pl)

    def grad_pl(shard_model: bool):
        return [Shard(0) if (m == model_dim and shard_model) else
                (Partial() if split[m] else Replicate()) for m in range(nd)]

    router = dt(moe.router).redistribute(dm, rep).to_local(
        grad_placements=grad_pl(False))
    ep = [Shard(0) if m == model_dim else Replicate() for m in range(nd)]
    experts = [dt(w).redistribute(dm, ep).to_local(
        grad_placements=grad_pl(True)) for w in (moe.wi, moe.wg, moe.wo)]
    group = mesh.group("model")

    def exchange(buf: torch.Tensor, back: bool) -> torch.Tensor:
        # to the owners: (E, cap, D) -> (E_loc, M * cap, D); back: inverse
        cap = buf.shape[1] // (1 if not back else n_ep)
        if back:
            buf = buf.reshape(e_loc, n_ep, cap, d).transpose(0, 1)
            buf = buf.reshape(cfg.n_experts, cap, d)
        buf = funcol.wait_tensor(funcol.all_to_all_single_autograd(
            buf.contiguous(), None, None, group))
        if back:
            return buf
        buf = buf.reshape(n_ep, e_loc, cap, d).transpose(0, 1)
        return buf.reshape(e_loc, n_ep * cap, d)

    yl, aux_l = moe.routed(xl.reshape(-1, d), router, experts, exchange)
    # back on x's layout, so that the residual sum and its gradient keep it
    y = DTensor.from_local(yl.reshape(xl.shape), dm, x_pl,
                           run_check=False).redistribute(dm, [
                               Replicate() if p.is_partial() else p
                               for p in xd.placements])
    if cfg.shared_expert_ff:
        y = y + moe.shared(xd)
    # each rank's Switch loss, averaged over the whole mesh (a pmean)
    aux = DTensor.from_local(aux_l / mesh.size, dm, [Partial()] * nd,
                             run_check=False).full_tensor()
    return y, aux


def _moe_layers(model: nn.Module) -> list:
    """`model`'s MoE layers with DeepSeek's router."""
    return [m for m in model.modules()
            if isinstance(m, MoE) and m.cfg.router == "sigmoid_group"]


def update_router_biases(model: nn.Module) -> None:
    """One bias update in every MoE layer of `model` that has one (after
    a training step's optimizer update)."""
    for m in _moe_layers(model):
        if m.cfg.bias_update_rate:
            m.update_bias()


def reset_routing_counters(model: nn.Module) -> None:
    """Zero the counters of every DeepSeek-routed layer of `model`."""
    with torch.no_grad():
        for m in _moe_layers(model):
            for c in (m.load_count, m.held_count, m.drop_count):
                c.zero_()


def routing_counters(model: nn.Module) -> dict:
    """The counters of `model`'s DeepSeek-routed layers since their last
    reset, read in one copy to the host: ``held`` and ``dropped`` choices
    summed over the layers, and ``loads``, one list of each routed
    expert's choices a layer ({} without such a layer)."""
    layers = _moe_layers(model)
    if not layers:
        return {}
    flat = torch.cat([torch.cat([m.held_count[None], m.drop_count[None],
                                 m.load_count]) for m in layers]).tolist()
    width = 2 + layers[0].cfg.n_routed
    rows = [flat[i:i + width] for i in range(0, len(flat), width)]
    return {"held": sum(r[0] for r in rows),
            "dropped": sum(r[1] for r in rows),
            "loads": [r[2:] for r in rows]}

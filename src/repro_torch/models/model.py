"""Generic decoder LM assembled from a periodic block pattern (port of
``repro.models.model``).

A ModelConfig (``repro_torch.configs``) names a ``pattern``, the repeating
unit of blocks (each block: norm, mixer, norm, ffn), repeated
``n_periods`` times, and an optional ``prefix_pattern`` of ``n_prefix``
layers before it.  The port stores the body as one ``ModuleList`` per
pattern position, indexed by period, as the reference stacks its
parameters, and walks it in the reference's two orders: ``forward``
period-major (``model.py:238-245``), ``decode_step`` position-major
(``model.py:389-396``).  The two agree when the pattern is one block
(qwen3, granite-moe, deepseek's body) or there is one period; otherwise
(gemma3, jamba, xlstm) teacher-forced decode is a different network from
forward, in the reference and so in the port.

Mixers: attention (``attn``, ``attn_local``), ``mla``, ``mamba``,
``mlstm`` and ``slstm``, each held by its block under the reference's key;
ffns: dense, ``moe`` (whose Switch auxiliary loss ``forward`` returns and
``loss_fn`` adds, summed over the blocks in the reference's order) or
none.  Each mixer with a rotation (attention over ``head_dim`` channels,
MLA over ``mla_rope_dim``) reads a rotary table of its own width.  A
``configs.PortModelConfig`` adds DeepSeek-V3's router, a held share of
the experts (``models/moe.py``) and YaRN (``layers.Yarn``: every rotary
table, and MLA's softmax scale); a plain ModelConfig has none of them.

Heads: "dense" (the unembedding, a plain matmul as in the reference) or
"loghd" (the paper's class-axis compression of the vocab classifier:
bundles (n, D) and profiles (V, n), logits are the profile-decode scores of
``api.dispatch.loghd_head_scores``, through the ``loghd_head`` kernel, with
its gradient when autograd asks for one).

Training: ``loss_fn`` is the mean token NLL plus the auxiliary loss, with
the reference's sequence-chunked cross-entropy (``cfg.loss_chunk``), and
``cfg.remat_policy`` recomputes each block in the backward ("full"), keeps
its matmul outputs ("dots") or keeps everything ("none"), as the
reference's ``jax.checkpoint`` policies do.

``decode_step`` updates the decode state in place, KV caches and
recurrent states alike, and returns it (the reference returns a new
state).

A mesh (``launch/mesh.py``; ``forward``, ``loss_fn``, ``prefill`` and
``decode_step`` take one, as ``Model(cfg, mesh)`` does) runs the passes on
a model laid out by ``models/sharding.py`` (``shard_model``): the
parameters are DTensors, the tokens enter split over the dp axes, and the
activations are DTensors that the reference's hints pin
(``activation_sharding`` after each block, ``model.py:175-178``).  The
LogHD head keeps its kernel there: each rank scores its rows against its
vocab shard (the reference turns its Pallas kernel off under a mesh and
computes the same scores in jnp); the cross entropy over the vocab shards
takes a MAX and two SUMs on the "model" group.  The loss comes back a
plain scalar, the same on every rank; logits as DTensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.api.dispatch import loghd_head_scores
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import sharding as shd
from repro_torch.models.attention import (Attention, AttnConfig, DecodeIndex,
                                          decode_attention_seqsharded,
                                          init_kv_cache)
from repro_torch.models.layers import (DenseHead, Embed, GatedMLP, Yarn,
                                       norm_scale, normal_, rms_norm,
                                       rope_table)
from repro_torch.models.mamba import Mamba, MambaConfig, init_mamba_state
from repro_torch.models.mla import MLA, MLAConfig, init_mla_cache
from repro_torch.models.moe import MoE, MoEConfig, moe_block, replay
from repro_torch.models.xlstm import (MLSTM, SLSTM, XLSTMConfig,
                                      init_mlstm_state, init_slstm_state)
from repro_torch.spans import span


def _yarn(cfg: ModelConfig) -> Optional[Yarn]:
    """The config's YaRN settings (a ``PortModelConfig`` with
    ``yarn_factor`` > 0), else None."""
    if not getattr(cfg, "yarn_factor", 0):
        return None
    return Yarn(cfg.yarn_factor, cfg.yarn_original_max_position,
                cfg.yarn_beta_fast, cfg.yarn_beta_slow, cfg.yarn_mscale,
                cfg.yarn_mscale_all_dim)


# the MoE settings a PortModelConfig carries under the same names
_ROUTER_KEYS = ("router", "n_routed_experts", "held_offset", "n_group",
                "topk_group", "routed_scaling_factor", "balance_weight",
                "bias_update_rate")


def _mixer_cfg(cfg: ModelConfig, blk: BlockSpec):
    """The mixer's config (``model.py:42-64``); an unknown mixer raises
    ``ValueError``."""
    if blk.mixer in ("attn", "attn_local"):
        return AttnConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
            rope_theta=cfg.rope_theta,
            window=cfg.local_window if blk.mixer == "attn_local" else None)
    if blk.mixer == "mla":
        return MLAConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads, q_lora=cfg.mla_q_lora,
            kv_lora=cfg.mla_kv_lora, nope_dim=cfg.mla_nope_dim,
            rope_dim=cfg.mla_rope_dim, v_dim=cfg.mla_v_dim,
            rope_theta=cfg.rope_theta, yarn=_yarn(cfg))
    if blk.mixer == "mamba":
        return MambaConfig(d_model=cfg.d_model)
    if blk.mixer in ("mlstm", "slstm"):
        return XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_kv_heads)
    raise ValueError(f"unknown mixer {blk.mixer!r}")


def _ffn_cfg(cfg: ModelConfig, blk: BlockSpec) -> Optional[MoEConfig]:
    """The MoE config of a ``moe`` ffn (``model.py:67-73``), else None."""
    if blk.ffn != "moe":
        return None
    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
                     n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor,
                     shared_expert_ff=cfg.shared_expert_ff,
                     **{k: getattr(cfg, k) for k in _ROUTER_KEYS
                        if hasattr(cfg, k)})


# a block's mixer module, under the reference's parameter key
_MIXERS = {"attn": Attention, "mla": MLA, "mamba": Mamba, "mlstm": MLSTM,
           "slstm": SLSTM}


def _mixer_key(blk: BlockSpec) -> str:
    return "attn" if blk.mixer in ("attn", "attn_local") else blk.mixer


# matmuls without batch dimensions: the weight products (x @ w flattens x
# to 2-D), not attention's batched einsums (bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(policy: str):
    """How a block runs under ``cfg.remat_policy`` (``model.py:218-226``):
    "none" keeps every activation for the backward; "full" keeps only the
    block's input and recomputes the block in the backward
    (``nothing_saveable``); "dots" keeps the outputs of the matmuls without
    batch dimensions and recomputes the rest
    (``dots_with_no_batch_dims_saveable``).  Without grad mode every
    policy runs the block plainly.  The recomputation runs under
    ``moe.replay``, so the routing's counts are the forward's alone."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _keep_dots) if policy == "dots" else None)

    def run(blk, x, ropes):
        if policy == "none" or not torch.is_grad_enabled():
            return blk(x, ropes)
        kw = {"context_fn": context} if context else {}
        calls = []

        def forward_or_replay(x, ropes):
            with replay() if calls else contextlib.nullcontext():
                calls.append(None)
                return blk(x, ropes)
        # no random op in a block: nothing to replay
        return ckpt.checkpoint(forward_or_replay, x, ropes,
                               use_reentrant=False, preserve_rng_state=False,
                               **kw)
    return run


def _gathered(h):
    """A block's input laid out with the batch over the dp axes and the
    rest whole: a DTensor carry stored sequence- or d-sharded is gathered
    here, as sequence parallelism does before its matmuls, and the
    residual sums run in this layout."""
    return shd.hint(h, ("pod", "data"), *((None,) * (h.ndim - 1)))


class Block(nn.Module):
    """Residual block: x + mixer(ln1(x)), then x + ffn(ln2(x)).  The mixer
    is the attribute named by ``key`` (the reference's parameter key:
    attn, mla, mamba, mlstm or slstm); the ffn is ``mlp``, ``moe`` or
    none."""

    def __init__(self, cfg: ModelConfig, blk: BlockSpec, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = norm_scale(cfg.d_model, device)
        mc = _mixer_cfg(cfg, blk)
        self.key = _mixer_key(blk)
        setattr(self, self.key, _MIXERS[self.key](mc, **kw))
        self.mlp = self.moe = None
        self.act_sharding = cfg.activation_sharding
        if blk.ffn != "none":
            self.ln2 = norm_scale(cfg.d_model, device)
        if blk.ffn == "dense":
            self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, **kw)
        elif blk.ffn == "moe":
            self.moe = MoE(_ffn_cfg(cfg, blk), **kw)

    @property
    def mixer(self) -> nn.Module:
        return getattr(self, self.key)

    @property
    def rope_dim(self) -> Optional[int]:
        """The width of the rotary table the mixer reads, or None."""
        if self.key == "attn":
            return self.attn.cfg.head_dim
        return self.mla.cfg.rope_dim if self.key == "mla" else None

    def init_weights(self, gen: torch.Generator) -> None:
        self.mixer.init_weights(gen)
        for ffn in (self.mlp, self.moe):
            if ffn is not None:
                ffn.init_weights(gen)

    def _ffn(self, x: torch.Tensor):
        if self.mlp is not None:
            return x + self.mlp(rms_norm(x, self.ln2)), None
        if self.moe is not None:
            y, aux = moe_block(self.moe, rms_norm(x, self.ln2),
                               shd.mesh_of(x))
            return x + y, aux
        return x, None

    def forward(self, x: torch.Tensor, ropes: dict):
        """x (B, S, D) -> (x, the MoE aux loss or None); `ropes` maps a
        rotary width to its ``rope_table``."""
        x = _gathered(x)
        # the mixer's output is cast to x's dtype (model.py:168)
        mixed = self.mixer(rms_norm(x, self.ln1), ropes.get(self.rope_dim))
        x, aux = self._ffn(x + mixed.to(x.dtype))
        # the carry stored model-sharded under a mesh (model.py:175-178)
        if self.act_sharding == "seq":
            x = shd.hint(x, ("pod", "data"), "model", None)
        elif self.act_sharding == "d":
            x = shd.hint(x, ("pod", "data"), None, "model")
        return x, aux

    def decode(self, x: torch.Tensor, st: dict, layer: int, ropes: dict,
               index, seq_pos=None) -> torch.Tensor:
        """One token through layer `layer` of this position's stacked
        state `st` (updated in place), as ``model.py:332-358``: the MoE aux
        loss is dropped.  ``index(length, local)`` gives the
        ``DecodeIndex`` of a cache of that length; `seq_pos` (the step's
        scalar position) sends a global attention layer through the
        sequence-sharded flash decode."""
        x = _gathered(x)
        h = rms_norm(x, self.ln1)
        rope = ropes.get(self.rope_dim)
        if (self.key == "attn" and seq_pos is not None
                and self.attn.cfg.window is None):
            mixed, _ = decode_attention_seqsharded(
                self.attn, h, {"k": st["k"][layer], "v": st["v"][layer]},
                seq_pos)
        elif self.key == "attn":
            ck = st["k"]
            mixed = self.attn.decode(
                h, ck[layer], st["v"][layer], rope,
                index(ck.shape[2], self.attn.cfg.window is not None))
        elif self.key == "mla":
            c_kv = st["c_kv"]
            mixed = self.mla.decode(h, c_kv[layer], st["k_rope"][layer], rope,
                                    index(c_kv.shape[2], False))
        elif self.key == "mamba":
            mixed = self.mamba.decode(h, st["conv"][layer], st["ssm"][layer])
        elif self.key == "mlstm":
            mixed = self.mlstm.decode(h, *(st[k][layer] for k in "cnm"))
        else:
            mixed = self.slstm.decode(h, *(st[k][layer] for k in "cnmh"))
        return self._ffn(x + mixed)[0]


class LogHDHead(nn.Module):
    """The LogHD vocab head: bundles (n, D) and profiles (V, n); its
    forward gives the (..., V) float32 logits -||x M^T - P_v||^2 through
    ``loghd_head_scores``: one ``loghd_head`` launch a call on the card,
    differentiable in x, the bundles and the profiles on both routes."""

    def __init__(self, d_model: int, vocab: int, n: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.bundles = nn.Parameter(torch.empty(n, d_model, **kw))
        self.profiles = nn.Parameter(torch.empty(vocab, n, **kw))

    def init_weights(self, gen: torch.Generator) -> None:
        normal_(self.bundles, gen, 1.0 / math.sqrt(self.bundles.shape[1]))
        normal_(self.profiles, gen, 0.05)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = shd.mesh_of(x)
        if mesh is None:
            return loghd_head_scores(x, self.bundles, self.profiles)
        return _loghd_head_sharded(x, self.bundles, self.profiles, mesh)


def _loghd_head_sharded(x, bundles, profiles, mesh):
    """The LogHD head on a mesh: each rank runs ``loghd_head_scores`` (one
    kernel launch on the card) on its rows of x (split over the dp axes
    that divide B), the bundles gathered whole and its vocab shard of the
    profiles; a vocab row's score depends on that row alone, so the local
    logits are the full result's columns.  Backward: the profiles'
    gradient stays local (summed over the row shards), the bundles' and
    x's are partial sums over the vocab shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = mesh.device_mesh
    xs = shd.hint(x, shd.dp_for_batch(mesh, x.shape[0]),
                  *((None,) * (x.ndim - 1)))
    if not shd.is_dtensor(profiles):
        profiles = DTensor.from_local(profiles, dm, [Replicate()] * dm.ndim,
                                      run_check=False)
        bundles = DTensor.from_local(bundles, dm, [Replicate()] * dm.ndim,
                                     run_check=False)
    split = [a.is_shard() or b.is_shard()
             for a, b in zip(xs.placements, profiles.placements)]
    h = shd.local_grads(xs, split)
    m = shd.local_grads(bundles.redistribute(dm, [Replicate()] * dm.ndim),
                        split)
    p = shd.local_grads(profiles, split)
    out = loghd_head_scores(h, m, p)
    vocab = out.ndim - 1
    pl = [Shard(vocab) if b.is_shard() else a
          for a, b in zip(xs.placements, profiles.placements)]
    return DTensor.from_local(out, dm, pl, run_check=False)


class DecoderLM(nn.Module):
    """The parameters of one ModelConfig on one device, and its passes.

    ``prefix[i][r]`` is repetition r of prefix-pattern position i,
    ``body[i][p]`` period p of pattern position i."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = norm_scale(cfg.d_model, device)
        reps = (cfg.n_prefix // len(cfg.prefix_pattern)
                if cfg.prefix_pattern else 0)
        self.prefix = nn.ModuleList(
            nn.ModuleList(Block(cfg, blk, **kw) for _ in range(reps))
            for blk in cfg.prefix_pattern)
        self.body = nn.ModuleList(
            nn.ModuleList(Block(cfg, blk, **kw) for _ in range(cfg.n_periods))
            for blk in cfg.pattern)
        self.rope_dims = sorted({stack[0].rope_dim
                                 for stack in (*self.prefix, *self.body)
                                 if len(stack) and stack[0].rope_dim})
        if cfg.head == "dense":
            self.head = DenseHead(cfg.d_model, cfg.vocab, **kw)
        elif cfg.head == "loghd":
            self.head = LogHDHead(cfg.d_model, cfg.vocab, cfg.loghd_bundles,
                                  **kw)
        else:
            raise ValueError(cfg.head)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_weights(self, gen: torch.Generator) -> None:
        """Draw every weight from `gen`, the head last, so that the dense
        and LogHD variants of one config share their backbone for a seed.
        Norm scales and biases stay zero, as in the reference."""
        self.embed.init_weights(gen)
        for stack in (*self.prefix, *self.body):
            for blk in stack:
                blk.init_weights(gen)
        self.head.init_weights(gen)

    def _embed(self, tokens, embeddings) -> torch.Tensor:
        mesh = shd.get_context_mesh()
        if embeddings is None:
            tokens = torch.as_tensor(tokens, device=self.device).long()
            if mesh is not None:
                tokens = shd.place_batch(tokens, mesh)
            x = self.embed(tokens)
        else:
            x = (embeddings if mesh is None
                 else shd.place_batch(embeddings, mesh))
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _ropes(self, positions: torch.Tensor, x) -> dict:
        """Each rotary width's table at `positions`, computed once a pass
        and shared by the layers (the reference recomputes it in each);
        replicated DTensors when x is a DTensor."""
        yarn = _yarn(self.cfg)
        return {dim: tuple(shd.like(t, x) for t in rope_table(
                    positions, dim, self.cfg.rope_theta, yarn))
                for dim in self.rope_dims}

    def backbone(self, tokens=None, embeddings=None):
        """Everything up to the head: ((B, S, D) final hidden states, the
        summed MoE aux loss () float32), each block run under the config's
        ``remat_policy``.  The aux losses are summed as the reference's
        scans sum them: each prefix position's layers, then each period's
        blocks in pattern order, then the periods."""
        x = self._embed(tokens, embeddings)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        ropes = self._ropes(positions, x)
        run = _remat(self.cfg.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # prefix: position-major, all repetitions of a position in turn
        # (model.py:228-233)
        for stack in self.prefix:
            auxs = []
            for blk in stack:
                x, a = run(blk, x, ropes)
                auxs.append(a)
            if auxs[0] is not None:
                aux = aux + torch.stack(auxs).sum()
        # body: period-major, the whole pattern once per period
        # (model.py:238-245)
        periods = []
        for p in range(self.cfg.n_periods):
            per = None
            for stack in self.body:
                x, a = run(stack[p], x, ropes)
                if a is not None:
                    per = a if per is None else per + a
            periods.append(per)
        if periods[0] is not None:
            aux = aux + torch.stack(periods).sum()
        return rms_norm(x, self.final_norm), aux

    def forward(self, tokens=None, *, embeddings=None):
        """tokens (B, S) int (or `embeddings` (B, S, D) from a frontend
        stub) -> (logits (B, S, V) float32, aux loss () float32: the MoE
        blocks' summed Switch losses, 0 without them)."""
        x, aux = self.backbone(tokens, embeddings)
        return self.head(x), aux

    @torch.no_grad()
    def decode_step(self, state: dict, tokens, pos, *, embeddings=None,
                    seq_sharded: bool = False):
        """One decode step.  tokens (B, 1) int; pos a scalar or (B,) int
        per-slot positions (a scalar when `seq_sharded`: the global
        attention layers' caches then hold this rank's sequence slice, see
        ``decode_attention_seqsharded``).  Writes each layer's cache
        entries and recurrent states into `state` in place; returns
        (logits (B, 1, V) float32, state)."""
        x = self._embed(tokens, embeddings)
        b = x.shape[0]
        seq_pos = None
        if seq_sharded:
            seq_pos = torch.as_tensor(pos, dtype=torch.int64,
                                      device=x.device)
            if seq_pos.ndim:
                raise ValueError("the sequence-sharded decode takes one "
                                 "scalar position for every slot")
        pos = torch.broadcast_to(
            torch.as_tensor(pos, dtype=torch.int64, device=x.device), (b,))
        ropes = self._ropes(pos[:, None], x)
        where: dict = {}

        def index(length: int, local: bool) -> DecodeIndex:
            if (length, local) not in where:
                where[length, local] = DecodeIndex.of(pos, length, local)
            return where[length, local]

        # a state of plain tensors on a mesh: each rank holds it whole,
        # replicated DTensors over the same storage
        view = state if not shd.is_dtensor(x) or seq_sharded else {
            name: [{k: shd.like(t, x) for k, t in st.items()} for st in sts]
            for name, sts in state.items()}
        # both stacks position-major: every layer of pattern position 0,
        # then of position 1, ... (model.py:376-387 and :389-396)
        for name, stacks in (("prefix", self.prefix), ("body", self.body)):
            for stack, st in zip(stacks, view.get(name, ())):
                for layer, blk in enumerate(stack):
                    x = blk.decode(x, st, layer, ropes, index, seq_pos)
        x = rms_norm(x, self.final_norm)
        return self.head(x), state


def _check_cfg(params: DecoderLM, cfg: ModelConfig) -> DecoderLM:
    """`params` if they were built for `cfg`, which may differ from their
    config in ``loss_chunk`` only (the loss reads it from `cfg`)."""
    if cfg is not params.cfg and dataclasses.replace(
            cfg, loss_chunk=params.cfg.loss_chunk) != params.cfg:
        raise ValueError(f"params were built for {params.cfg.name} "
                         f"(head {params.cfg.head}), not {cfg.name} "
                         f"(head {cfg.head})")
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    """The model of `cfg` with weights drawn from a ``torch.Generator``
    seeded with `seed` on `device` (None: the card, raising without one),
    at the reference's scales (``attention.py:44-61``, ``mla.py:46-60``,
    ``mamba.py:44-60``, ``xlstm.py:47-59`` and ``:195-206``,
    ``moe.py:45-59``, ``layers.py:54-83``, ``model.py:124-133``), and its
    constants (norms and biases zero, Mamba's A and dt bias, skip weights
    one).  The draws differ from jax's for the same seed.  On the meta
    device nothing is drawn: the model's shapes and dtypes alone (the dry
    run builds deepseek-v3's 671 B parameters so)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, device=dev)
    if dev.type != "meta":
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model


def head_logits(params: DecoderLM, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> (..., V) float32 logits."""
    return _check_cfg(params, cfg).head(x)


def _on_mesh(params: DecoderLM, mesh):
    """`params` checked to be laid out on `mesh` (``shard_model``) when
    the mesh has a DeviceMesh; the mesh installed for the pass."""
    if mesh is not None and mesh.device_mesh is not None and not (
            shd.is_dtensor(params.embed.table)
            and params.embed.table.device_mesh == mesh.device_mesh):
        raise ValueError("the model is not laid out on this mesh: call "
                         "models.sharding.shard_model(model, mesh) first")
    return shd.use_mesh(mesh)


def forward(params: DecoderLM, cfg: ModelConfig, tokens=None, mesh=None, *,
            embeddings: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V) float32, aux loss); on `mesh`
    the logits are a DTensor."""
    model = _check_cfg(params, cfg)
    with _on_mesh(model, mesh):
        return model(tokens, embeddings=embeddings)


def prefill(params: DecoderLM, cfg: ModelConfig, tokens=None, mesh=None,
            embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward pass's last-position logits (B, 1, V)."""
    logits, _ = forward(params, cfg, tokens, mesh, embeddings=embeddings)
    return logits[:, -1:]


def _xent_from_logits(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Summed token NLL of float32 logits (..., V): logsumexp minus the
    target's logit (the reference's one-hot einsum picks the same value
    exactly: every other term is a zero).  DTensor logits take the
    vocab-sharded form."""
    mesh = shd.mesh_of(logits)
    if mesh is not None:
        return _xent_sharded(logits, targets, mesh)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).sum()


def _xent_sharded(logits, targets: torch.Tensor, mesh) -> torch.Tensor:
    """The summed NLL of DTensor logits (B, ..., V), laid out with the
    rows over the dp axes that divide B and the vocab over "model": each
    rank takes its shard's max, all-reduced (MAX) over the vocab shards,
    its sum of exp(l - max) and its pick of the target logit (zero where
    the target lies in another shard), both summed over the vocab shards
    (the reference's one-hot einsum partitions the same way), then the
    rows' NLL summed over the row shards.  A plain scalar, the same on
    every rank, differentiable in the logits."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = mesh.device_mesh
    vdim = logits.ndim - 1
    lg = shd.hint(logits, shd.dp_for_batch(mesh, logits.shape[0]),
                  *((None,) * (vdim - 1)), "model")
    pl = lg.placements
    l = lg.to_local()
    t = shd.place_batch(targets, mesh).to_local()
    v_loc = l.shape[-1]
    v0 = shd.shard_offset(lg, vdim)
    mx = l.detach().amax(dim=-1)
    for m, p in enumerate(pl):
        if p.is_shard(vdim):
            mx = funcol.wait_tensor(funcol.all_reduce(
                mx, "max", dm.get_group(m)))
    se = torch.exp(l - mx[..., None]).sum(dim=-1)
    idx = t - v0
    inside = (idx >= 0) & (idx < v_loc)
    picked = l.gather(-1, torch.clamp(idx, 0, v_loc - 1)[..., None])[..., 0]
    tgt = torch.where(inside, picked, 0)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    part = [Partial() if p.is_shard(vdim) else r for p, r in zip(pl, rows)]

    def vocab_sum(v):
        return DTensor.from_local(v, dm, part, run_check=False).redistribute(
            dm, rows).to_local()
    nll = (mx + torch.log(vocab_sum(se)) - vocab_sum(tgt)).sum()
    total = [Partial() if p.is_shard(0) else Replicate() for p in pl]
    return DTensor.from_local(nll, dm, total, run_check=False).full_tensor()


def loss_fn(params: DecoderLM, cfg: ModelConfig, tokens, targets,
            mesh=None, *,
            embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL over (B, S) plus the MoE auxiliary loss: a float32
    scalar that autograd differentiates in every parameter.  `tokens` and
    `targets` are (B, S) ints (or `embeddings` (B, S, D) from a frontend
    stub in place of the tokens).

    With ``cfg.loss_chunk`` set, S > chunk and S % chunk == 0, the head and
    the NLL run one (B, chunk) slice of the sequence at a time under a
    checkpoint, as the reference's ``jax.checkpoint``-ed scan does
    (``model.py:263-284``): the (B, chunk, V) logits are made again in the
    backward instead of kept, so the LogHD head launches twice a chunk (a
    forward and a recomputation).

    On `mesh` the model must be laid out on it (``shard_model``); tokens
    and targets are the global batch (or DTensors), and the loss is a
    plain scalar, the same on every rank."""
    model = _check_cfg(params, cfg)
    with _on_mesh(model, mesh):
        return _loss(model, cfg, tokens, targets, embeddings)


def _loss(model: DecoderLM, cfg: ModelConfig, tokens, targets, embeddings):
    x, aux = model.backbone(tokens, embeddings)
    x = shd.hint(x, ("pod", "data"), None, None)
    targets = torch.as_tensor(targets, device=x.device).long()
    b, s, _ = x.shape
    chunk = cfg.loss_chunk
    if chunk and s > chunk and s % chunk == 0:
        def chunk_nll(xi, ti):
            with span("repro_torch.head"):
                return _xent_from_logits(model.head(xi), ti)

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, s, chunk):
            xi, ti = x[:, c:c + chunk], targets[:, c:c + chunk]
            if torch.is_grad_enabled():
                nll = ckpt.checkpoint(chunk_nll, xi, ti, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                nll = chunk_nll(xi, ti)
            total = total + nll
        return total / (b * s) + aux
    with span("repro_torch.head"):
        nll = _xent_from_logits(model.head(x), targets)
    return nll / (b * s) + aux


def _init_block_state(cfg: ModelConfig, blk: BlockSpec, batch: int,
                      max_len: int, dtype, device, layers: int,
                      seq_shards: int = 1) -> dict:
    """One pattern position's zero state, stacked over its `layers`
    (``model.py:291-305``)."""
    mc = _mixer_cfg(cfg, blk)
    key = _mixer_key(blk)
    if key == "attn":
        return init_kv_cache(mc, batch, max_len, dtype, device, layers=layers,
                             seq_shards=seq_shards)
    if key == "mla":
        return init_mla_cache(mc, batch, max_len, dtype, device,
                              layers=layers)
    if key == "mamba":
        return init_mamba_state(mc, batch, dtype, device, layers=layers)
    if key == "mlstm":
        return init_mlstm_state(mc, batch, device, layers=layers)
    return init_slstm_state(mc, batch, device, layers=layers)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      seq_shards: int = 1, device=None) -> dict:
    """Zero decode states in the reference's layout: ``{"prefix": [...],
    "body": [...]}`` with one entry per pattern position, stacked over its
    layers: ``{"k", "v"}`` (layers, B, L, KV, hd) for attention,
    ``{"c_kv", "k_rope"}`` for MLA, ``{"conv", "ssm"}`` for Mamba, ``{"c",
    "n", "m"}`` for mLSTM and ``{"c", "n", "m", "h"}`` for sLSTM, caches in
    the config's dtype ("prefix" only when the config has one).
    `seq_shards`: the global attention caches hold max_len / seq_shards
    positions, a rank's slice for the sequence-sharded decode."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def caches(pattern, layers):
        return [_init_block_state(cfg, blk, batch, max_len, dtype, dev,
                                  layers, seq_shards) for blk in pattern]

    state = {}
    if cfg.prefix_pattern:
        state["prefix"] = caches(cfg.prefix_pattern,
                                 cfg.n_prefix // len(cfg.prefix_pattern))
    state["body"] = caches(cfg.pattern, cfg.n_periods)
    return state


def decode_step(params: DecoderLM, cfg: ModelConfig, state: dict, tokens,
                pos, mesh=None, *, seq_sharded: bool = False,
                embeddings: Optional[torch.Tensor] = None):
    """One decode step: (logits (B, 1, V) float32, state updated in place).
    The MoE capacity counts the step's B tokens, so a step may drop other
    tokens than ``forward`` over the sequence does (``moe.py:97``).  On
    `mesh` the state's tensors may be DTensors (``launch/specs.py`` lays
    them out) and the logits come back a DTensor; `seq_sharded` takes the
    sequence-sharded flash decode over "data" for the global attention
    layers, whose caches then hold this rank's slice
    (``init_decode_state(..., seq_shards=)``)."""
    model = _check_cfg(params, cfg)
    with _on_mesh(model, mesh):
        return model.decode_step(state, tokens, pos, embeddings=embeddings,
                                 seq_sharded=seq_sharded)


class Model:
    """Thin OO facade, as the reference's: ``init`` draws the weights (laid
    out on the mesh when there is one), ``loss`` is ``loss_fn``
    (differentiable), ``forward`` the logits."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> DecoderLM:
        return shd.shard_model(init_params(self.cfg, seed, self.device),
                               self.mesh)

    def loss(self, params: DecoderLM, tokens, targets) -> torch.Tensor:
        return loss_fn(params, self.cfg, tokens, targets, self.mesh)

    def forward(self, params: DecoderLM, tokens):
        return forward(params, self.cfg, tokens, self.mesh)


def param_specs(cfg: ModelConfig) -> dict:
    """Parameter name -> P (``models/sharding.py``'s rules), from the
    model of `cfg` built on the meta device (no weight is drawn)."""
    return shd.model_specs(DecoderLM(cfg, device=torch.device("meta")))

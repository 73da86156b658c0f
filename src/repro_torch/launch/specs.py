"""Inputs and step functions for the multi-pod dry run (port of
``repro.launch.specs``).

For every (arch, shape) cell this module produces:
  * a step function (train_step / prefill_step / decode_step),
  * its inputs as meta-device DTensors laid out on the mesh: the
    counterpart of the reference's sharded ``ShapeDtypeStruct``s,
    shardable and allocation-free (``init_params(cfg, device="meta")``
    draws nothing, so deepseek-v3's 671 B parameters cost no memory),
so ``launch/dryrun.py`` can run each cell's step once on the production
meshes under a fake process group.

``input_shapes`` lists every input leaf's global and local shard shape
under the reference's tree paths (the parameters stacked over their layers
as the reference keeps them), which is what the layout parity test holds
against the reference's ``NamedSharding.shard_shape``.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.checkpoint.ckpt import LeafSpec
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import sharding as shd
from repro_torch.models.convert import stack_tree, stacked_layers
from repro_torch.models.model import (decode_step, forward, init_decode_state,
                                      init_params, loss_fn)
from repro_torch.models.sharding import NamedSharding, P
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule


def _maybe(mesh, axis: str, dim: int):
    """Shard `dim` on `axis` only if divisible (else replicate)."""
    return axis if dim % mesh.shape[axis] == 0 and dim >= mesh.shape[axis] \
        else None


def _meta(shape, dtype, sharding: NamedSharding):
    """A meta DTensor of global `shape` laid out by `sharding`."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, sharding.mesh.device_mesh,
                              sharding.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _meta_tree(tree, shardings):
    if isinstance(tree, dict):
        return {k: _meta_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_tree(v, s) for v, s in zip(tree, shardings)]
    return _meta(tree.shape, tree.dtype, shardings)


@functools.lru_cache(maxsize=2)
def _model(cfg: ModelConfig, mesh):
    """The meta model of `cfg` laid out on `mesh`, shared by the cells of
    one (config, mesh): its steps change nothing on meta tensors."""
    return shd.shard_model(init_params(cfg, device="meta"), mesh)


# -------------------------------------------------------------- train cell --

def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """int8 moments above 100 B parameters (the 671B config); float32
    elsewhere."""
    big = cfg.param_count() > 100e9
    return AdamWConfig(moment_dtype="int8" if big else "float32")


def make_train_step(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch, step):
        if cfg.frontend is None:
            loss = loss_fn(params, cfg, batch["tokens"], batch["targets"],
                           mesh)
        else:
            loss = loss_fn(params, cfg, None, batch["targets"], mesh,
                           embeddings=batch["embeddings"])
        names = [n for n, _ in params.named_parameters()]
        # a frontend config's token table takes no gradient: zeros, as
        # jax.grad gives
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        lr = cosine_schedule(step, peak_lr=3e-4, warmup_steps=100,
                             total_steps=10_000)
        adamw_update(opt_state, dict(params.named_parameters()),
                     dict(zip(names, grads)), opt_cfg, lr=lr)
        return params, opt_state, loss
    return train_step


def _batch(cfg: ModelConfig, shape: ShapeSpec, mesh, targets: bool) -> dict:
    dp = shd.dp_for_batch(mesh, shape.global_batch)
    tok = NamedSharding(mesh, P(dp, None))
    bs = (shape.global_batch, shape.seq_len)
    batch = {"tokens": _meta(bs, torch.int32, tok)}
    if targets:
        batch["targets"] = _meta(bs, torch.int32, tok)
    if cfg.frontend is not None:
        batch["embeddings"] = _meta(
            (*bs, cfg.d_model), getattr(torch, cfg.dtype),
            NamedSharding(mesh, P(dp, None, None)))
        del batch["tokens"]
    return batch


def train_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    opt_cfg = opt_config_for(cfg)
    model = _model(cfg, mesh)
    opt = adamw_init(dict(model.named_parameters()), opt_cfg,
                     stacked_layers(model))
    p_shard = shd.model_shardings(model, mesh)
    o_shard = shd.opt_state_shardings(opt, model, mesh)
    batch = _batch(cfg, shape, mesh, targets=True)
    step_fn = make_train_step(cfg, mesh, opt_cfg)
    return step_fn, (model, opt, batch, 0), (p_shard, o_shard, None), (0, 1)


# ------------------------------------------------------------ prefill cell --

def make_prefill_step(cfg: ModelConfig, mesh):
    def prefill_step(params, batch):
        if cfg.frontend is None:
            logits, _ = forward(params, cfg, batch["tokens"], mesh)
        else:
            logits, _ = forward(params, cfg, None, mesh,
                                embeddings=batch["embeddings"])
        return logits[:, -1:]
    return prefill_step


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    batch = _batch(cfg, shape, mesh, targets=False)
    return make_prefill_step(cfg, mesh), (_model(cfg, mesh), batch), None, ()


# ------------------------------------------------------------- decode cell --

def _decode_state_shardings(cfg: ModelConfig, state, mesh, batch: int,
                            long_ctx: bool):
    """Cache/state sharding policy:
       decode_32k : batch on dp axes, heads/d_inner on model.
       long_500k  : batch=1 -> attn caches sharded along SEQUENCE on "data",
                    state feature axes on "model" (divisibility-guarded)."""
    dp = shd.dp_for_batch(mesh, batch)

    def spec_for(names, leaf):
        ndim = len(leaf.shape)
        # leaves are stacked (L, B, ...) by init_decode_state
        if "k" in names or "v" in names:           # (L, B, S, KV, hd)
            if long_ctx:
                return P(None, None, _maybe(mesh, "data", leaf.shape[2]),
                         _maybe(mesh, "model", leaf.shape[3]), None)
            # prefer sharding kv-heads on "model"; fall back to the seq axis
            # when the head count doesn't divide (GQA kv=8 on a 16-way axis
            # would otherwise replicate a 40+ GiB cache per device)
            kv_ax = _maybe(mesh, "model", leaf.shape[3])
            seq_ax = None if kv_ax else _maybe(mesh, "model", leaf.shape[2])
            return P(None, dp, seq_ax, kv_ax, None)
        if "c_kv" in names or "k_rope" in names:    # (L, B, S, r)
            if long_ctx:
                return P(None, None, _maybe(mesh, "data", leaf.shape[2]), None)
            return P(None, dp, _maybe(mesh, "model", leaf.shape[2]), None)
        if "conv" in names:                         # (L, B, dc-1, di)
            return P(None, dp if not long_ctx else None, None,
                     _maybe(mesh, "model", leaf.shape[3]))
        if "ssm" in names:                          # (L, B, di, ds)
            return P(None, dp if not long_ctx else None,
                     _maybe(mesh, "model", leaf.shape[2]), None)
        if "c" in names and ndim == 5:              # mlstm C (L,B,H,hd,hd)
            return P(None, dp if not long_ctx else None, None,
                     _maybe(mesh, "model", leaf.shape[3]), None)
        if ndim >= 2:
            bdim = dp if (not long_ctx and leaf.shape[1] % 16 == 0) else None
            return P(*((None, bdim) + (None,) * (ndim - 2)))
        return P(*((None,) * ndim))

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, names + [i]) for i, v in enumerate(node)]
        return NamedSharding(mesh, spec_for(names, node))
    return walk(state, [])


def make_decode_step(cfg: ModelConfig, mesh):
    def step(params, state, tokens, pos):
        return decode_step(params, cfg, state, tokens, pos, mesh)
    return step


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    long_ctx = shape.seq_len > 100_000
    state = init_decode_state(cfg, batch=shape.global_batch,
                              max_len=shape.seq_len, device="meta")
    s_shard = _decode_state_shardings(cfg, state, mesh, shape.global_batch,
                                      long_ctx)
    dp = shd.dp_for_batch(mesh, shape.global_batch)
    tokens = _meta((shape.global_batch, 1), torch.int32,
                   NamedSharding(mesh, P(dp, None)))
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    return make_decode_step(cfg, mesh), \
        (_model(cfg, mesh), _meta_tree(state, s_shard), tokens, pos), \
        None, (1,)


def cell_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Dispatch: returns (step_fn, inputs, out_shardings, donate)."""
    if shape.kind == "train":
        return train_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape, mesh)
    return decode_specs(cfg, shape, mesh)


# ----------------------------------------------------------- shard shapes --

def _shape_pair(t) -> tuple:
    if isinstance(t, int):
        return (), ()
    local = shd.local(t).shape
    return tuple(t.shape), tuple(local)


def _flat(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    else:
        out[prefix.lstrip("/")] = tree
    return out


def input_shapes(inputs: tuple) -> dict:
    """Every input leaf of a cell as {path: (global shape, this rank's
    shard shape)}, under the reference's tree paths: argument index, then
    the keys (a model's parameters and its AdamW moments stacked over
    their layers, with the layer axis whole, as the reference keeps
    them)."""
    model = inputs[0]

    def tree_of(arg, which: int):
        def one(t):
            if isinstance(t, dict):
                return {k: one(v) for k, v in t.items()}
            if isinstance(t, list):
                return [one(v) for v in t]
            return LeafSpec(_shape_pair(t)[which], "")
        if arg is model:
            return stack_tree({n: one(p) for n, p in
                               model.named_parameters()}, model)
        if isinstance(arg, dict) and "mu" in arg:
            return {"step": LeafSpec((), ""),
                    "mu": stack_tree({n: one(m) for n, m in
                                      arg["mu"].items()}, model),
                    "nu": stack_tree({n: one(m) for n, m in
                                      arg["nu"].items()}, model)}
        return one(arg)

    out: dict = {}
    for i, arg in enumerate(inputs):
        glob = _flat(tree_of(arg, 0), str(i), {})
        loc = _flat(tree_of(arg, 1), str(i), {})
        out.update({k: (tuple(glob[k].shape), tuple(loc[k].shape))
                    for k in glob})
    return out


def arg_bytes(inputs: tuple) -> int:
    """Bytes of this rank's shards of every input leaf."""
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            loc = shd.local(t)
            total += math.prod(loc.shape) * loc.element_size()
        elif isinstance(t, dict):
            for v in t.values():
                add(v)
        elif isinstance(t, list):
            for v in t:
                add(v)
    add([p for p in inputs[0].parameters()])
    for arg in inputs[1:]:
        add(arg)
    return total

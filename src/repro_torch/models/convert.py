"""Carry decoder-LM weights and optimizer state between the JAX package and
the port.

The exchange format is the reference's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)``): ``{"embed": {"table"},
"final_norm", "prefix": [...], "body": [...], "head": {...}}``, where each
``prefix`` / ``body`` entry holds one pattern position's block parameters
stacked over repetitions / periods on the first axis.  A block's subtree
(``ln1``, ``attn.wq`` / ``mla.wkv_b`` / ``mamba.a_log`` / ``mlstm.wq`` /
``slstm.rz``, ..., ``mlp.wo`` / ``moe.router``) has the same dotted names
as the port's ``Block`` parameters, and each leaf keeps the reference's
dtype (a bf16 model's norms, MoE router, Mamba ``a_log`` / ``dt_bias`` /
``d_skip``, xLSTM ``skip_w`` and gate biases stay float32).  Neither
direction imports JAX; bfloat16
leaves (ml_dtypes arrays) are read through their bits, and come back as
float32 arrays, which widen bf16 exactly.

``stack_tree`` / ``unstack_tree`` map any per-parameter values (a tensor,
a ``{"codes", "scale"}`` moment, a ``LeafSpec``) to that stacked layout
and back; ``opt_state_to_reference`` / ``opt_state_from_reference`` carry
the AdamW state (``{"step", "mu", "nu"}``, int8 moments as ``{"codes",
"scale"}``), and ``train_state`` gives the ``{"params", "opt"}`` tree that
the training loops of both packages checkpoint (a port-only
``"router_bias"`` beside them for DeepSeek's router).

On a mesh: ``from_reference(..., mesh=)`` lays the weights out by
``models/sharding.py``'s rules and ``opt_state_from_reference`` the
moments on their parameters' layouts; the other direction gathers every
DTensor whole (``full_tensor()``), so the reference's tree and the
checkpoints are the same with or without a mesh.
``train_state_shardings`` gives the elastic restore its layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import LeafSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import sharding as shd
from repro_torch.models.model import DecoderLM

_STACKED = ("prefix", "body")


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return {k.rstrip("."): v for k, v in out.items()}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _locate(name: str) -> tuple:
    """A port parameter name's place in the reference tree: (path, layer),
    e.g. "body.0.3.attn.wq" -> (("body", 0, "attn", "wq"), 3) and
    "embed.table" -> (("embed", "table"), None)."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return (parts[0], int(parts[1]), *parts[3:]), int(parts[2])
    return tuple(parts), None


def stacked_layers(model: DecoderLM) -> dict:
    """Parameter name -> the number of layers the reference stacks it with
    (1 for the unstacked embedding, norm and head)."""
    return {name: (1 if layer is None else
                   len(getattr(model, path[0])[path[1]]))
            for name, _ in model.named_parameters()
            for path, layer in [_locate(name)]}


def _stack(leaves: list):
    first = leaves[0]
    if isinstance(first, dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in first}
    if isinstance(first, LeafSpec):
        return LeafSpec((len(leaves), *first.shape), first.dtype)
    if isinstance(first, shd.NamedSharding):
        return shd.NamedSharding(first.mesh, shd.P(None, *first.spec))
    if isinstance(first, torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def _index(leaf, i: int):
    if isinstance(leaf, dict):
        return {k: _index(v, i) for k, v in leaf.items()}
    return leaf[i]


def stack_tree(named: dict, model: DecoderLM) -> dict:
    """Per-parameter values of `model` (name -> value; a value is a tensor,
    a numpy array, a ``LeafSpec`` or a dict of them) as the reference's
    tree, each prefix / body position's layers stacked on a new first
    axis."""
    groups: dict = {}
    for name, value in named.items():
        path, layer = _locate(name)
        groups.setdefault(path, []).append((layer, value))
    tree: dict = {}
    for stack in _STACKED:
        if len(getattr(model, stack)):
            tree[stack] = [{} for _ in getattr(model, stack)]
    for path, items in groups.items():
        if items[0][0] is None:
            value = items[0][1]
        else:
            value = _stack([v for _, v in sorted(items, key=lambda t: t[0])])
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def unstack_tree(tree: dict, model: DecoderLM, names=None) -> dict:
    """The inverse of ``stack_tree``: parameter name -> that parameter's
    value (a stacked leaf's slice; views of the tree's arrays), for each
    of `names` (None: the model's parameters).  Raises KeyError naming a
    parameter the tree lacks."""
    out = {}
    if names is None:
        names = [name for name, _ in model.named_parameters()]
    for name in names:
        path, layer = _locate(name)
        node = tree
        try:
            for k in path:
                node = node[k]
        except (KeyError, IndexError) as e:
            raise KeyError(f"the reference tree lacks {name}") from e
        out[name] = node if layer is None else _index(node, layer)
    return out


@torch.no_grad()
def from_reference(tree: dict, cfg: ModelConfig, device=None,
                   mesh=None) -> DecoderLM:
    """The port's model of `cfg` on `device` (None: the card) holding the
    reference tree's weights, each cast to the dtype the port keeps it in,
    laid out on `mesh` by the sharding rules when one is given.  Raises if
    a leaf is missing, foreign or of another shape."""
    model = DecoderLM(cfg, device=resolve_device(device))
    params = dict(model.named_parameters())
    known = {".".join(map(str, _locate(n)[0])) for n in params}
    foreign = sorted(set(_flatten(tree)) - known)
    if foreign:
        raise ValueError(f"reference leaves {foreign} have no port parameter")
    try:
        values = unstack_tree(tree, model)
    except KeyError as e:
        raise ValueError(f"the reference tree lacks {e.args[0].split()[-1]}")
    for name, p in params.items():
        t = _tensor(values[name])
        if p.shape != t.shape:
            raise ValueError(f"reference leaf for {name} {tuple(t.shape)} "
                             f"does not fit the port's {tuple(p.shape)}")
        p.copy_(t)
    return shd.shard_model(model, mesh)


@torch.no_grad()
def to_reference(model: DecoderLM) -> dict:
    """The inverse: the reference's tree of numpy arrays (bf16 as
    float32), each prefix / body position's layers stacked (a sharded
    model's gathered whole)."""
    def leaf(p: torch.Tensor) -> np.ndarray:
        p = shd.full(p.detach()).cpu()
        return (p.float() if p.dtype == torch.bfloat16 else p).numpy()
    return stack_tree({n: leaf(p) for n, p in model.named_parameters()},
                      model)


def _map(fn, value):
    if isinstance(value, dict):
        return {k: _map(fn, v) for k, v in value.items()}
    return fn(value)


def _host(t: torch.Tensor) -> torch.Tensor:
    return shd.full(t.detach()).cpu()


def _spec(t: torch.Tensor) -> LeafSpec:
    return LeafSpec(tuple(t.shape), str(t.dtype).removeprefix("torch."))


def _opt_tree(opt_state: dict, model: DecoderLM, leaf) -> dict:
    step = torch.tensor(opt_state["step"], dtype=torch.int32)
    return {"step": leaf(step),
            "mu": stack_tree({n: _map(leaf, v) for n, v in
                              opt_state["mu"].items()}, model),
            "nu": stack_tree({n: _map(leaf, v) for n, v in
                              opt_state["nu"].items()}, model)}


def opt_state_to_reference(opt_state: dict, model: DecoderLM) -> dict:
    """The port's AdamW state as the reference's ``{"step": int32 (),
    "mu": tree, "nu": tree}``, each moment stacked as the parameters are
    (int8 moments as ``{"codes", "scale"}``), on the host."""
    return _opt_tree(opt_state, model, _host)


def _to(value, device):
    if isinstance(value, dict):
        return {k: _to(v, device) for k, v in value.items()}
    return _tensor(value).to(device) if not isinstance(
        value, torch.Tensor) else value.to(device)


def opt_state_from_reference(tree: dict, model: DecoderLM) -> dict:
    """The reference's AdamW state (tensors or numpy arrays) as the port's,
    each moment on its parameter's device."""
    devices = {n: p.device for n, p in model.named_parameters()}

    def moments(key):
        return {n: _to(v, devices[n])
                for n, v in unstack_tree(tree[key], model).items()}
    step = tree["step"]
    state = {"step": int(shd.full(step).item()
                         if isinstance(step, torch.Tensor)
                         else np.asarray(step)),
             "mu": moments("mu"), "nu": moments("nu")}
    mesh = shd.mesh_of(model.embed.table)
    return state if mesh is None else shd.shard_opt_state(state, model, mesh)


def router_biases(model: DecoderLM) -> dict:
    """The router-bias buffers of `model`'s DeepSeek-routed MoE layers
    (name -> buffer; {} in every config the reference has)."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(".router_bias")}


def train_state(model: DecoderLM, opt_state: dict, *, spec: bool = False):
    """``{"params": ..., "opt": ...}`` in the reference's layout on the
    host, parameters in their own dtypes: the tree both packages' training
    loops checkpoint.  A model with DeepSeek's router adds
    ``"router_bias"``, its bias buffers stacked as the parameters are (a
    port-only key: the training step moves them, and routing reads them).
    ``spec=True``: its structure, shapes and dtypes as ``LeafSpec``s, a
    restore target that copies nothing."""
    leaf = _spec if spec else _host
    tree = {"params": stack_tree({n: leaf(p) for n, p in
                                  model.named_parameters()}, model),
            "opt": _opt_tree(opt_state, model, leaf)}
    biases = router_biases(model)
    if biases:
        tree["router_bias"] = stack_tree(
            {n: leaf(b) for n, b in biases.items()}, model)
    return tree


def train_state_shardings(model: DecoderLM, opt_state: dict) -> dict:
    """The ``train_state`` tree's layouts on the mesh a sharded `model`
    lives on (``NamedSharding`` leaves; None for the step): what
    ``restore_checkpoint(..., shardings=)`` lays each leaf onto."""
    mesh = shd.mesh_of(model.embed.table)
    params = shd.model_shardings(model, mesh)
    opt = shd.opt_state_shardings(opt_state, model, mesh)
    tree = {"params": stack_tree(params, model),
            "opt": {"step": None, "mu": stack_tree(opt["mu"], model),
                    "nu": stack_tree(opt["nu"], model)}}
    if router_biases(model):
        tree["router_bias"] = None
    return tree


@torch.no_grad()
def load_train_state(tree: dict, model: DecoderLM) -> dict:
    """Copy a ``train_state`` tree's parameters (and router biases) into
    `model` and return its AdamW state in the port's form (on the model's
    mesh when the model is sharded; the tree's leaves may be DTensors
    already, from an elastic restore).  Raises ValueError when the tree
    and the model disagree on router biases: a resume without them would
    route otherwise than the run it continues."""
    biases = router_biases(model)
    if bool(biases) != ("router_bias" in tree):
        raise ValueError("the model has router biases and the tree none"
                         if biases else
                         "the tree has router biases and the model none")
    if biases:
        values = unstack_tree(tree["router_bias"], model, list(biases))
        for name, b in biases.items():
            b.copy_(_to(values[name], b.device))
    values = unstack_tree(tree["params"], model)
    for name, p in model.named_parameters():
        v = _to(values[name], p.device)
        if shd.is_dtensor(p):
            p.to_local().copy_(shd.like(v, p).redistribute(
                p.device_mesh, p.placements).to_local())
        else:
            p.copy_(v)
    return opt_state_from_reference(tree["opt"], model)

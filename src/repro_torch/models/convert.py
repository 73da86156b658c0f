"""Carry decoder-LM weights between the JAX package and the port.

The exchange format is the reference's parameter tree with numpy leaves
(``jax.tree.map(np.asarray, params)``): ``{"embed": {"table"},
"final_norm", "prefix": [...], "body": [...], "head": {...}}``, where each
``prefix`` / ``body`` entry holds one pattern position's block parameters
stacked over repetitions / periods on the first axis.  A block's subtree
(``ln1``, ``attn.wq``, ..., ``mlp.wo``) has the same dotted names as the
port's ``Block`` parameters.  Neither direction imports JAX; bfloat16
leaves (ml_dtypes arrays) are read through their bits, and come back as
float32 arrays, which widen bf16 exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
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


def _set(tree: dict, key: str, value) -> None:
    *path, last = key.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


@torch.no_grad()
def from_reference(tree: dict, cfg: ModelConfig, device=None) -> DecoderLM:
    """The port's model of `cfg` on `device` (None: the card) holding the
    reference tree's weights, each cast to the dtype the port keeps it in.
    Raises if a leaf is missing, foreign or of another shape."""
    model = DecoderLM(cfg, device=resolve_device(device))
    params = dict(model.named_parameters())
    seen = set()
    for key, leaf in _flatten(tree).items():
        t = _tensor(leaf)
        if key.split(".")[0] in _STACKED:       # one name per stacked layer
            stack, pos, name = key.split(".", 2)
            pairs = [(f"{stack}.{pos}.{i}.{name}", t[i])
                     for i in range(t.shape[0])]
        else:
            pairs = [(key, t)]
        for name, part in pairs:
            p = params.get(name)
            if p is None or p.shape != part.shape:
                raise ValueError(f"reference leaf {key} {tuple(t.shape)} has "
                                 f"no port parameter {name}")
            p.copy_(part)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise ValueError(f"the reference tree lacks {missing}")
    return model


@torch.no_grad()
def to_reference(model: DecoderLM) -> dict:
    """The inverse: the reference's tree of numpy arrays (bf16 as
    float32), each prefix / body position's layers stacked."""
    def leaf(p: torch.Tensor) -> np.ndarray:
        p = p.detach().cpu()
        return (p.float() if p.dtype == torch.bfloat16 else p).numpy()

    def stacked(layers) -> dict:
        out: dict = {}
        for name, _ in layers[0].named_parameters():
            _set(out, name, np.stack([leaf(blk.get_parameter(name))
                                      for blk in layers]))
        return out

    tree: dict = {}
    for name, p in model.named_parameters():
        if name.split(".")[0] not in _STACKED:
            _set(tree, name, leaf(p))
    if len(model.prefix):
        tree["prefix"] = [stacked(layers) for layers in model.prefix]
    tree["body"] = [stacked(layers) for layers in model.body]
    return tree

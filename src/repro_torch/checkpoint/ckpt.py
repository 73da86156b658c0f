"""Atomic checkpoints in the JAX package's on-disk layout (port of
``repro.checkpoint.ckpt``; a class-sharded model's elastic restore is
``api.checkpointing.load_model``, which keeps each rank's rows, an LM
tree's is ``restore_checkpoint(..., shardings=)``).

Layout:  <dir>/step_<N>/
            manifest.json          — tree structure, shapes, dtypes
            arr_<i>.npy            — one file per array leaf (bf16 as uint16)
            COMMIT                 — atomic commit marker (written last)

The files are written to ``step_<N>.tmp``, renamed into place, and only
then is ``COMMIT`` written; readers accept only committed directories.

Leaves are numbered in the order in which ``jax.tree_util`` flattens the
same tree, so a checkpoint written here loads in the JAX package and the
other way round:

  * a dict's entries in sorted key order, a list's or tuple's in order;
  * ``None`` gives no leaf;
  * a ``QTensor`` gives (codes, scale), its ``bits`` being static;
  * a typed model (a dataclass with ``aux_fields``) gives its fields in
    declaration order, the aux fields being static;
  * a tensor or numpy array is an array leaf (``arr_<i>.npy``), anything
    else (a string, a number) a scalar leaf kept in the manifest.

Restored arrays are torch tensors; dtype names are numpy's ("float32",
"int8", "bfloat16"), as the JAX package writes them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels.common import resolve_device

__all__ = ["LeafSpec", "save_checkpoint", "restore_checkpoint",
           "latest_step", "read_scalar_leaves", "AsyncCheckpointer"]


class LeafSpec(NamedTuple):
    """Shape and dtype name of an array leaf: a restore target that holds
    no data (the counterpart of ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: str


def _is_model(node) -> bool:
    return (dataclasses.is_dataclass(node) and not isinstance(node, type)
            and hasattr(node, "aux_fields"))


def _is_array(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, LeafSpec))


def _node(node):
    """(label, aux, children) of an inner node, or None for a leaf."""
    if isinstance(node, QTensor):
        return "QTensor", node.bits, [node.codes, node.scale]
    if _is_model(node):
        names = [f.name for f in dataclasses.fields(node)]
        return (type(node).__name__,
                tuple(getattr(node, n) for n in node.aux_fields),
                [getattr(node, n) for n in names
                 if n not in node.aux_fields])
    return None


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, LeafSpec):
        return [leaf for v in tree for leaf in _flatten(v)]
    node = _node(tree)
    if node is not None:
        return [leaf for c in node[2] for leaf in _flatten(c)]
    return [tree]


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it, without the ``PyTreeDef(...)`` wrapper."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple) and not isinstance(tree, LeafSpec):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    node = _node(tree)
    if node is not None:
        label, aux, children = node
        return (f"CustomNode({label}[{aux!r}], ["
                + ", ".join(_treedef(c) for c in children) + "])")
    return "*"


def _unflatten(target, leaves):
    """`target`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, (list, tuple)) and not isinstance(target,
                                                            LeafSpec):
        return type(target)(_unflatten(v, leaves) for v in target)
    if isinstance(target, QTensor):
        codes = _unflatten(target.codes, leaves)
        return QTensor(codes, _unflatten(target.scale, leaves), target.bits)
    if _is_model(target):
        kw = {f.name: (getattr(target, f.name)
                       if f.name in target.aux_fields
                       else _unflatten(getattr(target, f.name), leaves))
              for f in dataclasses.fields(target)}
        return type(target)(**kw)
    return next(leaves)


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _to_numpy(a) -> np.ndarray:
    """An array leaf as the numpy array written to disk (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a)


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _host_leaves(tree, copy: bool = False) -> tuple[str, list]:
    """The tree's structure string and its leaves on the host: array leaves
    as (numpy array written to disk, dtype name), scalars as they are.
    ``copy`` detaches the arrays from the tree's own memory (a CPU tensor's
    numpy view shares it)."""
    leaves = [(np.array(_to_numpy(leaf), copy=copy), _dtype_name(leaf))
              if _is_array(leaf) else leaf for leaf in _flatten(tree)]
    return f"PyTreeDef({_treedef(tree)})", leaves


def _save_host(ckpt_dir: str, step: int, treedef: str, leaves: list) -> str:
    """Write host leaves (``_host_leaves``) as a committed checkpoint."""
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "treedef": treedef,
                "n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, tuple):
            arr, dtype = leaf
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            manifest["leaves"].append({"kind": "array", "dtype": dtype,
                                       "shape": list(arr.shape)})
        else:
            manifest["leaves"].append({"kind": "scalar", "value": leaf})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, "COMMIT"), "w") as f:
        f.write("ok")
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Blocking save.  Returns the committed directory path."""
    return _save_host(ckpt_dir, step, *_host_leaves(tree))


class AsyncCheckpointer:
    """Single-outstanding-write async checkpointing.

    ``save()`` copies the tree's tensors to the host synchronously (cheap
    beside a training step), then writes the files on a daemon thread;
    ``wait()`` joins it and re-raises an error of the writer.  A training
    loop calls ``save()`` every few steps and ``wait()`` before it exits;
    ``save()`` waits for the write before it.  The files are those of
    ``save_checkpoint``, byte for byte."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host = _host_leaves(tree, copy=True)

        def write():
            try:
                _save_host(self.ckpt_dir, step, *host)
            except BaseException as e:      # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _manifest(ckpt_dir: str, step: int) -> tuple[str, dict]:
    path = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def read_scalar_leaves(ckpt_dir: str, step: int) -> list:
    """Values of the scalar leaves of a committed checkpoint, in leaf
    order, read without a restore target."""
    _, manifest = _manifest(ckpt_dir, step)
    return [leaf["value"] for leaf in manifest["leaves"]
            if leaf.get("kind") == "scalar"]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest COMMITted step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _flatten_up_to(target, shardings) -> list:
    """`shardings`' entries at `target`'s leaves, in ``_flatten`` order
    (None where `shardings` has none)."""
    if shardings is None:
        return [None] * len(_flatten(target))
    if target is None:
        return []
    if isinstance(target, dict):
        return [x for k in sorted(target)
                for x in _flatten_up_to(target[k], shardings.get(k))]
    if isinstance(target, (list, tuple)) and not isinstance(target,
                                                            LeafSpec):
        return [x for t, sh in zip(target, shardings)
                for x in _flatten_up_to(t, sh)]
    if _node(target) is not None:
        return [None] * len(_flatten(target))
    return [shardings]


def restore_checkpoint(ckpt_dir: str, step: int, target: Any,
                       shardings: Any = None, *, device=None) -> Any:
    """Restore into the structure of `target`, whose array leaves may be
    tensors, numpy arrays or ``LeafSpec``s; array leaves come back as
    tensors on `device` (None means "cuda") with the dtypes on disk.

    `shardings` (the structure of `target`, leaves
    ``models.sharding.NamedSharding`` or None) makes it an ELASTIC
    restore: each such leaf is read whole from the reference's layout and
    laid onto its mesh as a DTensor, this rank keeping its shard, so a
    checkpoint written unsharded (or by the JAX package) restores onto any
    mesh, and one written from a mesh (gathered) back onto none."""
    device = resolve_device(device)
    path, manifest = _manifest(ckpt_dir, step)
    t_leaves = _flatten(target)
    if manifest["n_leaves"] != len(t_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; target has "
            f"{len(t_leaves)} — structure mismatch")
    s_leaves = _flatten_up_to(target, shardings)
    out = []
    for i, (meta, tgt, sh) in enumerate(zip(manifest["leaves"], t_leaves,
                                            s_leaves)):
        if meta["kind"] == "scalar":
            out.append(meta["value"])
            continue
        leaf = _from_numpy(np.load(os.path.join(path, f"arr_{i}.npy")),
                           meta["dtype"], device)
        expect = tuple(getattr(tgt, "shape", leaf.shape))
        if tuple(leaf.shape) != expect:
            raise ValueError(f"leaf {i}: ckpt shape {tuple(leaf.shape)} != "
                             f"target {expect}")
        if sh is not None:
            from repro_torch.models.sharding import distribute
            leaf = distribute(leaf, sh.mesh, sh.spec)
        out.append(leaf)
    return _unflatten(target, iter(out))

"""Path-based sharding rules: parameter and activation layouts over an LM
mesh (port of ``repro.models.sharding``, on ``torch.distributed.tensor``).

Meshes (``launch/mesh.py``):
  single-pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16)

Strategy, as in the reference:
  * "pod"   -- pure data parallelism;
  * "data"  -- FSDP: every weight is sharded along its d_model-like axis;
  * "model" -- tensor parallelism: heads / ffn hidden / experts / vocab.

A rule's ``P`` is the reference's ``PartitionSpec``: one entry a tensor
dimension, None (replicated), an axis name or a tuple of axis names.  On a
DTensor it becomes one placement a mesh dimension: ``Shard(d)`` on each
mesh axis named in entry d, ``Replicate()`` on the others; a tuple of axes
on one dimension shards it on each in mesh order, major to minor, as jax
does.  The reference's GSPMD inserts the collectives; here DTensor's
propagation does for the ops it covers, and the bodies that it does not
cover (the MoE dispatch, the LM head's kernel, the vocab-sharded cross
entropy, the decode caches' writes, the sequence-sharded decode) work on
``to_local()`` shards with the collectives written out.

The port's per-layer parameters have no stack axis: a parameter's path is
its reference leaf's (``models/convert._locate``), and the rule's leading
``None`` for the stack falls away.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re

import torch


class P(tuple):
    """A partition spec: ``P("data", None)``, one entry a dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# (regex over "/"-joined path, spec) -- spec axes reference logical mesh
# names; ("data",) FSDP axis and ("model",) TP axis.
# The port's parameters carry no stack axis, so no rule pads one.
_RULES: list[tuple[str, P]] = [
    # embeddings / dense head: vocab on model, d_model on data
    (r"embed/table$",              P("model", "data")),
    (r"head/w$",                   P("data", "model")),
    # LogHD head: bundles tiny in n — shard D on data; profiles vocab on model
    (r"head/bundles$",             P(None, "data")),
    (r"head/profiles$",            P("model", None)),
    # attention projections: (D, heads*hd) / (heads*hd, D)
    (r"attn/(wq|wk|wv)$",          P("data", "model")),
    (r"attn/wo$",                  P("model", "data")),
    (r"attn/(bq|bk|bv)$",          P("model",)),
    (r"attn/(qnorm|knorm)$",       P(None,)),
    # MLA: lora-rank axes replicated, expanded head axes on model
    (r"mla/(wq_a|wkv_a)$",         P("data", None)),
    (r"mla/(wq_b|wkv_b)$",         P(None, "model")),
    (r"mla/wo$",                   P("model", "data")),
    (r"mla/(q_a_norm|kv_a_norm)$", P(None,)),
    # dense mlp: (D, F) with F on model
    (r"mlp/(wi|wg)$",              P("data", "model")),
    (r"mlp/wo$",                   P("model", "data")),
    # MoE: experts on model (EP); per-expert matrices FSDP on data
    (r"moe/router$",               P(None, None)),
    (r"moe/(wi|wg)$",              P("model", "data", None)),
    (r"moe/wo$",                   P("model", None, "data")),
    (r"moe/shared_(wi|wg)$",       P("data", "model")),
    (r"moe/shared_wo$",            P("model", "data")),
    # mamba: d_inner on model, d_model-ish axes on data
    (r"mamba/in_proj$",            P("data", "model")),
    (r"mamba/conv_w$",             P(None, "model")),
    (r"mamba/conv_b$",             P("model",)),
    (r"mamba/x_proj$",             P("model", None)),
    (r"mamba/dt_proj$",            P(None, "model")),
    (r"mamba/(a_log|d_skip)$",     P("model", None)),
    (r"mamba/dt_bias$",            P("model",)),
    (r"mamba/out_proj$",           P("model", "data")),
    # xLSTM
    (r"mlstm/up_proj$",            P("data", "model")),
    (r"mlstm/(wq|wk|wv)$",         P("data", "model")),
    (r"mlstm/(wi|wf|wo_gate)$",    P("data", "model")),
    (r"mlstm/down_proj$",          P("model", "data")),
    (r"mlstm/skip_w$",             P("model",)),
    (r"slstm/(wz|wi|wf|wo)$",      P("data", "model")),
    (r"slstm/(rz|ri|rf|ro)$",      P(None, "model")),
    (r"slstm/(bz|bi|bf|bo)$",      P("model",)),
    (r"slstm/(up_proj)$",          P("data", "model")),
    (r"slstm/(down_proj)$",        P("model", "data")),
    # norms / scalars: replicated
    (r"(ln1|ln2|ln3|norm|final_norm|scale|.*_norm)$", P(None,)),
    (r"frontend/.*$",              P(None, None)),
]


def spec_for_path(path: str, ndim: int) -> P:
    """Find the rule for a leaf path; pad leading stack axes with None."""
    for pat, spec in _RULES:
        if re.search(pat, path):
            pads = ndim - len(spec)
            if pads < 0:
                # rule has more axes than the leaf (e.g. scalar norm): trim
                return P(*tuple(spec)[:ndim])
            return P(*((None,) * pads + tuple(spec)))
    # default: replicate
    return P(*((None,) * ndim))


def param_path(name: str) -> str:
    """A port parameter's reference path, "/"-joined without the layer:
    "body.0.3.attn.wq" -> "body/0/attn/wq"."""
    from repro_torch.models.convert import _locate
    return "/".join(map(str, _locate(name)[0]))


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _rebuild(tree, values, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [_rebuild(v, values, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return values[prefix.rstrip("/")]


def tree_specs(tree) -> dict:
    """P tree matching `tree` (nested dicts / lists of anything with a
    ``shape``), each leaf's spec from its "/"-joined path."""
    return _rebuild(tree, {path: spec_for_path(path, len(leaf.shape))
                           for path, leaf in _leaves(tree)})


def model_specs(model) -> dict:
    """Parameter name -> P, for a ``DecoderLM``'s per-layer parameters."""
    return {n: spec_for_path(param_path(n), p.ndim)
            for n, p in model.named_parameters()}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _guard_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes from dims they don't evenly divide (e.g. 4 mLSTM gate
    heads on a 16-way model axis; granite's 49155 vocab)."""
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            fixed.append(None)
            continue
        # an axis the mesh lacks (a ("data",) mesh) shards nothing
        size = math.prod(mesh.shape.get(a, 1) for a in _axes(entry))
        fixed.append(entry if (dim % size == 0 and dim >= size) else None)
    return P(*fixed)


def placements(spec: P, mesh) -> tuple:
    """One DTensor placement a mesh dimension for `spec`."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [mesh.axis_names.index(a) for a in axes if a in mesh.axis_names]
        if order != sorted(order):
            raise ValueError(f"{spec}: axes of one dimension must follow the "
                             f"mesh's order {mesh.axis_names}")
        for m in order:
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    its ``placements`` and the ``shard_shape`` of a global shape."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        out = list(shape)
        for d, entry in enumerate(self.spec):
            size = math.prod(self.mesh.shape.get(a, 1) for a in _axes(entry))
            out[d] = -(-out[d] // size)
        return tuple(out)


def tree_shardings(tree, mesh) -> dict:
    """NamedSharding tree of `tree`: each leaf's rule, guarded for
    divisibility on `mesh`."""
    specs = tree_specs(tree)
    guarded = {path: NamedSharding(mesh, _guard_spec(spec, leaf.shape, mesh))
               for (path, leaf), (_, spec) in zip(_leaves(tree),
                                                   _leaves(specs))}
    return _rebuild(tree, guarded)


def model_shardings(model, mesh) -> dict:
    """Parameter name -> NamedSharding for a ``DecoderLM``."""
    return {n: NamedSharding(mesh, _guard_spec(spec, p.shape, mesh))
            for (n, p), spec in zip(model.named_parameters(),
                                    model_specs(model).values())}


# ---- classifier class-axis layout ----------------------------------------
# The sharded extreme-classification estimator (repro_torch.api.sharded)
# lays profile / codebook rows over "class" and keeps the O(n * D) bundles
# whole on every rank.

CLASS_SHARDED = P("class", None)     # (C, ...) leaves: rows over "class"
CLASS_REPLICATED = P()               # n- or (n, D)-sized leaves: replicated


# ---- activation sharding hints -------------------------------------------
# Model code calls hint() where the reference does; it is a no-op on a
# plain tensor and lays a DTensor out on its own mesh, so that a block
# recomputed in the backward (remat) takes the same layouts without a
# context.  The context mesh, installed by forward() / loss_fn() /
# decode_step(), tells the entry where to lay the tokens.

_CONTEXT_MESH: list = [None]


def get_context_mesh():
    """The installed mesh, or None (also for a mesh of one rank without a
    process group, which holds every shard)."""
    mesh = _CONTEXT_MESH[0]
    return mesh if mesh is not None and mesh.device_mesh is not None else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` as the context mesh for the block; the previous mesh
    comes back after it."""
    before = _CONTEXT_MESH[0]
    _CONTEXT_MESH[0] = mesh
    try:
        yield
    finally:
        _CONTEXT_MESH[0] = before


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


_MESHES: dict = {}


def mesh_of(x):
    """The ``launch.mesh.Mesh`` a DTensor lives on (None for a plain
    tensor)."""
    if not is_dtensor(x):
        return None
    dm = x.device_mesh
    mesh = _MESHES.get(id(dm))
    if mesh is None or mesh.device_mesh is not dm:
        from repro_torch.launch.mesh import Mesh
        names = tuple(dm.mesh_dim_names)
        mesh = Mesh(dm, names, dict(zip(names, dm.shape)))
        _MESHES[id(dm)] = mesh
    return mesh


def like(t, ref):
    """`t` as a replicated DTensor on `ref`'s mesh when `ref` is a DTensor
    and `t` a plain tensor (a mask, a rotary table, positions), else `t`:
    DTensor ops take no plain operand, in the backward neither."""
    if not is_dtensor(ref) or is_dtensor(t) or not isinstance(
            t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    dm = ref.device_mesh
    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                              run_check=False)


def _fix(shape, spec, mesh) -> P:
    fixed = []
    for dim, ax in zip(shape, spec):
        axes = tuple(a for a in _axes(ax) if a in mesh.axis_names)
        size = math.prod(mesh.shape[a] for a in axes)
        fixed.append(axes if (axes and dim % size == 0 and dim >= size)
                     else None)
    return P(*fixed)


def hint(x, *spec):
    """Redistribute the DTensor `x` to `spec` on its mesh (no-op for a
    plain tensor).  Axes named in `spec` that don't divide the
    corresponding dim, or that the mesh lacks, are dropped to None."""
    mesh = mesh_of(x)
    if mesh is None:
        return x
    pl = placements(_fix(x.shape, spec, mesh), mesh)
    return x if tuple(x.placements) == pl else x.redistribute(
        mesh.device_mesh, pl)


def dp_axes_of(mesh) -> tuple:
    if mesh is None:
        return ()
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def batch_spec(mesh) -> P:
    """Tokens (B, S): batch over all data-parallel axes."""
    axes = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return P(axes, None)


def activation_spec(mesh) -> P:
    """(B, S, D) activations: batch over dp axes, D replicated."""
    axes = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return P(axes, None, None)


def dp_for_batch(mesh, batch: int):
    """Largest prefix of the dp axes that divides `batch`, or None."""
    axes = []
    prod = 1
    for a in dp_axes_of(mesh):
        if batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes) if axes else None


# ---- placing tensors, models and optimizer states ------------------------

def distribute(t: torch.Tensor, mesh, spec: P):
    """A DTensor on `mesh` laid out by `spec` (guarded for divisibility)
    from `t`, the full tensor, which every rank holds: each rank keeps its
    own shard, with no collective.  A DTensor is redistributed; on a mesh
    without a DeviceMesh the whole tensor comes back."""
    if mesh.device_mesh is None:
        return full(t)
    spec = _guard_spec(spec, t.shape, mesh)
    pl = placements(spec, mesh)
    if is_dtensor(t):
        return t.redistribute(mesh.device_mesh, pl)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh.device_mesh, pl, src_data_rank=None)


def place_batch(t, mesh):
    """Tokens or targets (B, S), or embeddings (B, S, D), of the global
    batch laid out over the dp axes that divide B (a DTensor is
    redistributed; a plain tensor is the global batch on every rank)."""
    spec = P(dp_for_batch(mesh, t.shape[0]), *((None,) * (t.ndim - 1)))
    if is_dtensor(t):
        return t.redistribute(mesh.device_mesh, placements(spec, mesh))
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(t, mesh.device_mesh,
                             [Replicate()] * len(mesh.axis_names),
                             run_check=False)
    return rep.redistribute(mesh.device_mesh, placements(spec, mesh))


def local(x):
    """The local shard of a DTensor, or `x` itself."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The whole tensor of a DTensor (gathered), or `x` itself."""
    return x.full_tensor() if is_dtensor(x) else x


@torch.no_grad()
def shard_model(model, mesh):
    """Lay every parameter of `model` (a ``DecoderLM``) on `mesh` by the
    rules, in place: each becomes a DTensor parameter holding this rank's
    shard of the full weights the rank holds now (every rank must hold the
    same).  A mesh without a DeviceMesh leaves the model as it is.
    Returns `model`."""
    if mesh is None or mesh.device_mesh is None:
        return model
    from torch import nn
    shardings = model_shardings(model, mesh)
    for name, sh in shardings.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = getattr(mod, leaf)
        if is_dtensor(p):
            continue
        mod.register_parameter(leaf, nn.Parameter(
            distribute(p.detach(), mesh, sh.spec),
            requires_grad=p.requires_grad))
    model.mesh = mesh
    return model


def moment_spec(param_spec: P, ndim: int) -> P:
    """An int8 moment's ``scale``: the parameter's spec with the last
    axis replicated (it rarely divides; ``launch/specs.py:114-136``)."""
    spec = tuple(param_spec) + (None,) * (ndim - len(param_spec))
    return P(*(spec[:-1] + (None,))) if ndim else P()


def opt_state_shardings(opt_state: dict, model, mesh) -> dict:
    """NamedSharding tree of a port AdamW state: each moment on its
    parameter's layout; an int8 moment's codes likewise and its scale with
    the last axis replicated."""
    shardings = model_shardings(model, mesh)

    def moment(name, m):
        sh = shardings[name]
        if isinstance(m, dict):
            return {"codes": sh, "scale": NamedSharding(
                mesh, moment_spec(sh.spec, m["scale"].ndim))}
        return sh
    return {key: {n: moment(n, m) for n, m in opt_state[key].items()}
            for key in ("mu", "nu")}


@torch.no_grad()
def shard_opt_state(opt_state: dict, model, mesh) -> dict:
    """The AdamW state of `model` laid on `mesh` (moments as DTensors, see
    ``opt_state_shardings``); the step stays an int.  A mesh without a
    DeviceMesh returns the state as it is."""
    if mesh is None or mesh.device_mesh is None:
        return opt_state
    shardings = opt_state_shardings(opt_state, model, mesh)

    def put(m, sh):
        if isinstance(m, dict):
            return {k: put(m[k], sh[k]) for k in m}
        return distribute(m, mesh, sh.spec)
    out = {"step": opt_state["step"]}
    for key in ("mu", "nu"):
        out[key] = {n: put(m, shardings[key][n])
                    for n, m in opt_state[key].items()}
    return out


# ---- shard-local bodies --------------------------------------------------

def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of the DTensor `x` starts along `dim`."""
    dm = x.device_mesh
    coord = dm.get_coordinate()
    idx = 0
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            idx = idx * dm.size(m) + coord[m]
    return idx * x.to_local().shape[dim]


def local_grads(x, split):
    """``x.to_local()`` for a body whose work is split along the mesh
    dimensions where `split` is true: the local gradient of a dimension x
    is sharded on stays sharded, of one it is replicated on is a partial
    sum where the body's work is split there and replicated where every
    rank does the same work."""
    from torch.distributed.tensor import Partial, Replicate
    pl = [p if p.is_shard() else (Partial() if s else Replicate())
          for p, s in zip(x.placements, split)]
    return x.to_local(grad_placements=pl)


def write_rows(cache, slot, value) -> None:
    """``cache[b, slot[b]] = value[b]`` for every row b, in place: cache
    (B, L, ...), slot (B,) int, value (B, ...).  On a DTensor cache each
    rank writes the rows and the positions its shard holds (the value
    laid out as the cache's other dims), leaving the others as they
    were."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot] = value
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = cache.device_mesh
    vpl = [Shard(0) if p.is_shard(0) else
           Shard(p.dim - 1) if p.is_shard() and p.dim >= 2 else Replicate()
           for p in cache.placements]
    if not is_dtensor(value):
        value = DTensor.from_local(value, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
    v = value.redistribute(dm, vpl).to_local()
    c = cache.to_local()
    b_loc, l_loc = c.shape[:2]
    r0, s0 = shard_offset(cache, 0), shard_offset(cache, 1)
    slot = local(slot)[r0:r0 + b_loc] - s0
    owns = (slot >= 0) & (slot < l_loc)
    safe = torch.clamp(slot, 0, l_loc - 1)
    rows = torch.arange(b_loc, device=c.device)
    shape = (b_loc,) + (1,) * (v.ndim - 1)
    c[rows, safe] = torch.where(owns.reshape(shape), v, c[rows, safe])


def assign(dst, src) -> None:
    """``dst.copy_(src)`` for a decode state written in place: on a
    DTensor `dst`, `src` is first laid out as `dst`."""
    if is_dtensor(dst):
        if not is_dtensor(src):
            from torch.distributed.tensor import DTensor, Replicate
            src = DTensor.from_local(src, dst.device_mesh,
                                     [Replicate()] * dst.device_mesh.ndim,
                                     run_check=False)
        dst.to_local().copy_(src.redistribute(dst.device_mesh,
                                              dst.placements).to_local())
        return
    dst.copy_(src)


def elementwise(fn, x):
    """fn(x) for an elementwise `fn` that DTensor has no rule for (or no
    rule for its backward): on a DTensor, fn runs on the local shard
    (a partial sum is summed first), differentiably."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def fsdp(w):
    """A weight as a layer uses it: a DTensor gathered over the
    data-parallel axes ("pod", "data") where it is sharded on them, its
    "model" shards kept (FSDP's per-use all-gather; the gradient is
    reduce-scattered back through it), so that its product with
    batch-sharded activations is a tensor-parallel one.  A plain tensor
    comes back as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if names[m] in ("pod", "data") and p.is_shard()
          else p for m, p in enumerate(w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def rows_local(fn, tensors: tuple, params: tuple = ()):
    """``fn(*local tensors, *local params)`` as a shard-local body over the
    batch rows: each DTensor of `tensors` laid out with dim 0 over the dp
    axes that divide it and the rest whole, each of `params` gathered
    whole; fn's outputs (a tensor or a tuple, each with the rows first)
    come back as DTensors on that rows layout.  For the recurrent scans
    (Mamba's, the mLSTM's chunks, the sLSTM's steps), whose ops DTensor
    would propagate one step at a time.  Plain tensors: ``fn`` as it is."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors, *params)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = mesh_of(tensors[0])
    dm = mesh.device_mesh
    dp = dp_for_batch(mesh, tensors[0].shape[0])
    rows = [hint(like(t, tensors[0]), dp, *((None,) * (t.ndim - 1)))
            for t in tensors]
    split = [p.is_shard() for p in rows[0].placements]
    local_in = [t.to_local() for t in rows]
    local_p = [local_grads(like(p, tensors[0]).redistribute(
        dm, [Replicate()] * dm.ndim), split) for p in params]
    out = fn(*local_in, *local_p)
    pl = rows[0].placements

    def wrap(t):
        return DTensor.from_local(t, dm, pl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)

"""Class-sharded LogHD estimator for extreme C (port of
``repro.api.sharded``).

LogHD stores O(n D + C n) for n ~ ceil(log_k C): the class axis is the
only axis that grows with C, so it is the axis this module shards.  The
layout is a ``launch.mesh.make_class_mesh`` ("data", "class") mesh of
shards over the process group:

  sharded over "class":  profiles (C, n) rows, codebook (C, n) rows
  replicated:            bundles (n, D), the encoder

A class shard is a contiguous block of rows; the class axis is padded with
zero rows to S equal blocks.  A rank holds the rows of its own blocks
(all of them without a process group), so ``ShardedLogHDModel.profiles``
is this rank's slice.  No C x D array exists at any point:

  fit      streams the bundle superposition over blocks of 4,096 classes
           (``streaming_build_bundles``); Eq. 9 refinement touches only
           (n, D) and batches (``fit_engine``, data-parallel over the
           mesh's "data" axis when ``data_sharding > 1``); each block
           estimates its own profile rows (``sharded_estimate_profiles``);
  predict  reduces queries to the n-dim activations A(x) = h M^T, scores
           each block's rows, keeps one (best score, global row) pair a
           query, and combines them over blocks and then ranks
           (``sharded_decode``): never the (B, C) score matrix.

Every score is the same n-length arithmetic whichever block holds the
row, and the combine takes the first maximum in block order, so labels
are the unsharded decode's.  At small C the streaming superposition is one
block, bitwise ``build_bundles``, and ``segment_profile_means`` is bitwise
shift-invariant per row, so the fit is the unsharded fit's too.  The
Pallas kernels (the CUDA kernels here) do not know this layout: the class
turns kernel dispatch off, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.api import dispatch
from repro_torch.api.fit_engine import (fused_refine_bundles,
                                        fused_refine_bundles_dp)
from repro_torch.api.models import MODEL_CLASSES, LogHDModel, _shape
from repro_torch.core import codebook as cb
from repro_torch.core.bundling import build_bundles
from repro_torch.core.profiles import activations, segment_profile_means
from repro_torch.core.quantize import (QTensor, codes_for_scale,
                                       quantize_scale)
from repro_torch.hdc.conventional import l2_normalize, pad_rows, segment_sum
from repro_torch.launch import mesh as dmesh
from repro_torch.precision import full_f32

__all__ = ["ShardedLogHDModel", "fit_loghd_sharded", "shard_loghd_model",
           "place_sharded", "sharded_decode", "sharded_estimate_profiles",
           "streaming_build_bundles", "class_mesh", "clear_sharded_cache"]

STREAM_BLOCK = 4096

# Meshes are cached per (shard layout, process group), so that every stage
# of one layout uses the same axis groups, created once.
_MESH_CACHE: dict = {}


def _world_key() -> Optional[tuple]:
    if not dmesh.distributed():
        return None
    return (id(torch.distributed.group.WORLD), dmesh.world_size(),
            dmesh.rank())


@dispatch.register_cache_clearer
def clear_sharded_cache() -> None:
    """Drop the cached meshes (also runs on ``api.dispatch.clear_cache()``);
    call it after a process group is destroyed."""
    _MESH_CACHE.clear()


def class_mesh(n_class_shards: int, n_data_shards: int = 1
               ) -> dmesh.ClassMesh:
    """The cached ("data", "class") mesh for one shard layout."""
    key = (int(n_class_shards), int(n_data_shards), _world_key())
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = dmesh.make_class_mesh(key[0], key[1])
    return mesh


def _padded_rows(n_classes: int, n_shards: int) -> int:
    """Class-axis length after padding to a whole number of shard rows."""
    return -(-int(n_classes) // int(n_shards)) * int(n_shards)


def _local_rows(mesh: dmesh.ClassMesh, c_pad: int) -> slice:
    """The rows of the padded class axis this rank holds."""
    c_loc = c_pad // mesh.shape["class"]
    blocks = mesh.blocks("class")
    return slice(blocks.start * c_loc, blocks.stop * c_loc)


def _gather_rows(local: torch.Tensor, mesh: dmesh.ClassMesh) -> torch.Tensor:
    """Every rank's rows of a class-sharded leaf, in row order."""
    if not dmesh.distributed():
        return local
    parts = dmesh.all_gather_stack(local, mesh.group("class"))
    return parts.reshape(-1, *local.shape[1:])


# ------------------------------------------------------------------ decode --

@full_f32()
def sharded_decode(profiles: torch.Tensor, acts: torch.Tensor, *,
                   n_shards: int, n_classes: int,
                   metric: str = "l2") -> torch.Tensor:
    """argmax over class-sharded profile rows: this rank's (rows, n) and the
    queries' (B, n) activations -> (B,) global labels.

    Each block scores its own rows with ``decode_profiles``' arithmetic
    (``2 A P^T - ||P||^2``, or the cosine), masks rows at or past
    `n_classes` to -inf and keeps one (best score, global row) pair a
    query; the rank keeps the first maximum over its blocks in block order,
    then the pairs of the class group's ranks are all-gathered and the
    first maximum over ranks wins.  Blocks are contiguous in rank order and
    every argmax takes the first maximum, so ties resolve to the lowest
    global row: the argmax over the full (B, C) scores, which is never
    built (the transient is one block's (B, rows a block)).

    >>> profiles = torch.tensor([[0., 0.], [1., 0.], [0., 1.]])
    >>> acts = torch.tensor([[0.9, 0.1], [0.1, 1.2]])
    >>> sharded_decode(profiles, acts, n_shards=1, n_classes=3).tolist()
    [1, 2]
    """
    if metric not in ("l2", "cos"):
        raise ValueError(
            f"sharded decode supports l2/cos metrics, not {metric!r} "
            "(gather the model with .gathered() for maha)")
    mesh = class_mesh(n_shards)
    blocks = mesh.blocks("class")
    if profiles.shape[0] % len(blocks):
        raise ValueError(f"{profiles.shape[0]} profile rows do not split "
                         f"into {len(blocks)} class shards")
    c_loc = profiles.shape[0] // len(blocks)
    if metric == "cos":
        a = l2_normalize(acts)
        p_all = l2_normalize(profiles)
    else:
        a = 2.0 * acts
        p_all = profiles
    best_s = best_i = None
    for j, blk in enumerate(blocks):
        p = p_all[j * c_loc:(j + 1) * c_loc]
        scores = a @ p.T
        if metric == "l2":
            scores = scores - torch.sum(p * p, dim=-1)
        start = blk * c_loc
        if start + c_loc > n_classes:
            gidx = torch.arange(start, start + c_loc, device=scores.device)
            scores = torch.where(gidx[None, :] < n_classes, scores,
                                 float("-inf"))
        loc = torch.argmax(scores, dim=-1)
        s = scores.gather(1, loc[:, None])[:, 0]
        i = loc + start
        if best_s is None:
            best_s, best_i = s, i
        else:
            better = s > best_s
            best_s = torch.where(better, s, best_s)
            best_i = torch.where(better, i, best_i)
    if not dmesh.distributed():
        return best_i
    group = mesh.group("class")
    all_s = dmesh.all_gather_stack(best_s, group)           # (W_c, B)
    all_i = dmesh.all_gather_stack(best_i, group)
    win = torch.argmax(all_s, dim=0)                        # first max
    return all_i.gather(0, win[None, :])[0]


# --------------------------------------------------------------------- fit --

@full_f32()
def streaming_build_bundles(h: torch.Tensor, y, codebook, k: int, *,
                            bipolar: bool = False,
                            block: int = STREAM_BLOCK) -> torch.Tensor:
    """Eq. 4 bundle superposition with the class axis streamed in blocks:
    (N, D), (N,), (C, n) -> (n, D), with O(block x max(n, D)) transients.

    Each block superposes its classes' prototypes (ids outside the block
    are dropped by ``segment_sum``) and the blocks' (n, D) products are
    summed in block order.  The block is clamped to C, so at small C the
    one block is ``build_bundles(class_prototypes(h, y, C), ...)`` bit for
    bit."""
    book = torch.as_tensor(codebook, device=h.device)
    y = torch.as_tensor(y, device=h.device).to(torch.int64)
    c = book.shape[0]
    block = int(min(block, c))
    g = cb.symbol_weight(book, k)                               # (C, n)
    if bipolar:
        g = 2.0 * g - 1.0
    m = None
    for start in range(0, c, block):
        g_blk = g[start:start + block]
        protos = l2_normalize(segment_sum(h, y - start, g_blk.shape[0]))
        part = g_blk.T @ protos
        m = part if m is None else m + part
    return l2_normalize(m)


@full_f32()
def sharded_estimate_profiles(bundles: torch.Tensor, h: torch.Tensor, y,
                              n_classes: int, n_shards: int) -> torch.Tensor:
    """Eq. 6 profile estimation, each class block its own rows: -> this
    rank's (rows, n) slice of the padded (C_pad, n) profiles.

    The activations (N, n) are computed once; each block averages the
    examples whose label falls in its rows (``segment_profile_means`` drops
    the others and is bitwise shift-invariant per row), so every row equals
    the unsharded ``estimate_profiles``' bit for bit.  Padding rows and
    classes absent from the data come out zero."""
    mesh = class_mesh(n_shards)
    c_loc = _padded_rows(n_classes, n_shards) // int(n_shards)
    acts = activations(bundles, h)                              # (N, n)
    y = torch.as_tensor(y, device=h.device).to(torch.int64)
    return torch.cat([segment_profile_means(acts, y - blk * c_loc, c_loc)
                      for blk in mesh.blocks("class")])


# ------------------------------------------------------------------- model --

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedLogHDModel(LogHDModel):
    """LogHD with its profile and codebook rows laid over a "class" mesh.

    The fields of ``LogHDModel`` plus the static layout: the class axis is
    padded to ``class_sharding`` equal row blocks and ``n_classes_real``
    keeps the true C (0: no padding).  ``profiles`` and ``codebook`` hold
    this rank's rows.  Decode is ``sharded_decode`` (l2 / cos); kernel
    dispatch is off for the class."""

    class_sharding: int = 1
    n_classes_real: int = 0           # 0: profiles carry no padding rows

    method: ClassVar[str] = "loghd_sharded"
    stored_leaves: ClassVar[tuple] = ("bundles", "profiles")
    aux_fields: ClassVar[tuple] = ("metric", "encoder_kind",
                                   "class_sharding", "n_classes_real")
    kernel_dispatch: ClassVar[bool] = False

    @property
    def mesh(self) -> dmesh.ClassMesh:
        return class_mesh(self.class_sharding)

    @property
    def padded_classes(self) -> int:
        """Rows of the padded class axis over every rank."""
        rows = _shape(self.profiles)[0]
        return rows * int(self.class_sharding) // len(self.mesh.blocks(
            "class"))

    @full_f32()
    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """The n-dim activations, then the sharded argmax-combine."""
        acts = activations(self.bundles, h)
        return sharded_decode(self.profiles, acts,
                              n_shards=self.class_sharding,
                              n_classes=self.n_classes, metric=self.metric)

    def model_bits(self, bits: int) -> int:
        """Accounting over the real class count: padding rows are layout,
        not model."""
        from repro_torch.core.loghd import memory_bits
        n, d = _shape(self.bundles)
        return memory_bits(self.n_classes, d, n, bits)

    @property
    def n_classes(self) -> int:
        return int(self.n_classes_real) or self.padded_classes

    def quantized(self, bits: int) -> "ShardedLogHDModel":
        """Quantize the stored leaves; the profiles' scale is taken over
        every rank's rows (the padded leaf, as in the reference)."""
        mesh = self.mesh
        if mesh.grid["class"] == 1:
            return super().quantized(bits)
        full = _gather_rows(self.profiles.to(torch.float32), mesh)
        scale = torch.tensor(quantize_scale(full.cpu().numpy(), bits),
                             device=full.device)
        prof = QTensor(codes_for_scale(self.profiles, scale, bits), scale,
                       bits)
        return super().quantized(bits).replace(profiles=prof)

    def _corrupt_whole(self, corrupt, *args):
        """`corrupt` (an ``HDModel`` corruption method) on the model with
        every rank's rows, then this rank's rows of each result: each leaf
        is corrupted whole with its seed, so a code's flips follow its
        global index as in the reference, and every rank draws the same
        faults.  The gathered leaves are the (C, n) int codes, never C x D;
        at one rank per class group no gather is made."""
        if self.mesh.grid["class"] == 1:
            return corrupt(self, *args)
        out = corrupt(self.full_rows(), *args)
        if isinstance(out, list):
            return [place_sharded(m) for m in out]
        return place_sharded(out)

    def corrupted(self, p, seeds, scope="all", fault_model=None):
        return self._corrupt_whole(LogHDModel.corrupted, p, seeds, scope,
                                   fault_model)

    def corrupted_materialized(self, p, seeds, scope="all",
                               fault_model=None):
        return self._corrupt_whole(LogHDModel.corrupted_materialized, p,
                                   seeds, scope, fault_model)

    def corrupted_materialized_grid(self, ps, seeds, scope="all",
                                    fault_model=None):
        return self._corrupt_whole(LogHDModel.corrupted_materialized_grid,
                                   ps, seeds, scope, fault_model)

    def full_rows(self) -> "ShardedLogHDModel":
        """The same model holding every rank's rows (the padded class axis),
        as checkpoints and the JAX package hold it."""
        mesh = self.mesh

        def gather(leaf):
            if isinstance(leaf, QTensor):
                return QTensor(_gather_rows(leaf.codes, mesh), leaf.scale,
                               leaf.bits)
            return _gather_rows(leaf, mesh)
        return self.replace(profiles=gather(self.profiles),
                            codebook=gather(self.codebook))

    def gathered(self) -> LogHDModel:
        """A plain ``LogHDModel`` with every rank's rows and the padding
        rows dropped: for maha decode, the kernel predict, or export."""
        m = self.materialized().full_rows()
        c = self.n_classes
        return LogHDModel(enc=m.enc, bundles=m.bundles,
                          profiles=m.profiles[:c], codebook=m.codebook[:c],
                          sigma_inv=m.sigma_inv, metric=m.metric,
                          encoder_kind=m.encoder_kind)

    def _held_bytes(self) -> int:
        """Bytes of the class-sharded leaves (profiles + codebook) as this
        rank's tensors hold them."""
        return sum((leaf.codes if isinstance(leaf, QTensor) else leaf).nbytes
                   for leaf in (self.profiles, self.codebook))

    def sharded_leaf_bytes(self) -> tuple:
        """(bytes of one class shard, total bytes over every shard) of the
        class-sharded leaves.  A shard is the reference's device: one block
        of rows.  The first is read from this rank's tensors, their bytes
        over the blocks it holds (on one process holding every block it is
        the layout's S-th part, whatever the leaves hold); the second is
        the padded class axis's logical size."""
        held = self._held_bytes()
        per_shard = held // len(self.mesh.blocks("class"))
        total = 0
        for leaf in (self.profiles, self.codebook):
            arr = leaf.codes if isinstance(leaf, QTensor) else leaf
            total += arr[0].numel() * arr.element_size() * self.padded_classes
        return per_shard, total

    def resident_bytes_per_device(self) -> dict:
        """Residency of a shard against the ideal C / S split (padding rows
        excluded from the ideal, so the ratio charges them), and the bytes
        this rank holds."""
        mx, total = self.sharded_leaf_bytes()
        real = total * self.n_classes / max(self.padded_classes, 1)
        ideal = real / max(int(self.class_sharding), 1)
        return {"max_bytes_per_device": int(mx),
                "total_bytes": int(total),
                "ideal_bytes_per_device": ideal,
                "ratio_to_ideal": mx / ideal,
                "bytes_this_rank": self._held_bytes()}


MODEL_CLASSES[ShardedLogHDModel.method] = ShardedLogHDModel


# -------------------------------------------------------------- placement --

def place_sharded(model: ShardedLogHDModel) -> ShardedLogHDModel:
    """Keep this rank's rows of a model that holds the whole padded class
    axis (a loaded checkpoint, a converted reference model): each rank of
    any world size takes its own blocks."""
    c_pad = _padded_rows(model.n_classes_real or _shape(model.profiles)[0],
                         model.class_sharding)
    if _shape(model.profiles)[0] != c_pad:
        raise ValueError(f"profiles have {_shape(model.profiles)[0]} rows, "
                         f"not the padded class axis's {c_pad}")
    rows = _local_rows(class_mesh(model.class_sharding), c_pad)

    def take(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(leaf.codes[rows], leaf.scale, leaf.bits)
        return leaf[rows]
    return model.replace(profiles=take(model.profiles),
                         codebook=take(model.codebook))


def shard_loghd_model(model: LogHDModel, n_shards: int, *,
                      place: bool = True) -> ShardedLogHDModel:
    """Re-lay a fitted LogHD model over ``n_shards`` class shards: the row
    leaves padded to the shard grid and (by default) cut to this rank's
    rows.  Predictions equal the source model's."""
    if getattr(model, "metric", "l2") == "maha":
        raise ValueError("class-sharded LogHD decodes l2/cos only; keep the "
                         "maha model unsharded or switch its metric")
    m = model.materialized()
    c = _shape(m.profiles)[0]
    c_pad = _padded_rows(c, n_shards)
    out = ShardedLogHDModel(
        enc=m.enc, bundles=m.bundles, profiles=pad_rows(m.profiles, c_pad),
        codebook=pad_rows(m.codebook, c_pad), sigma_inv=m.sigma_inv,
        metric=m.metric, encoder_kind=m.encoder_kind,
        class_sharding=int(n_shards), n_classes_real=c)
    return place_sharded(out) if place else out


# ----------------------------------------------------------------- trainer --

@full_f32()
def fit_loghd_sharded(cfg, enc_cfg, x, y, *, device,
                      enc: Optional[dict] = None, encoded=None,
                      prototypes=None, base=None,
                      generator: Optional[torch.Generator] = None,
                      perms=None) -> ShardedLogHDModel:
    """Algorithm 1 with the class axis sharded end to end: the stages of
    ``_impl.fit_loghd_model`` (which hands its fit here when
    ``class_sharding`` or ``data_sharding`` is above 1), the C-sized ones in
    their streaming or sharded forms:

      codebook   the whole book on the host (the Eq. 9 targets gather
                 arbitrary rows), padded, this rank's rows kept;
      bundles    ``streaming_build_bundles`` (no C x D prototypes);
      refine     ``fused_refine_bundles``, or at ``data_sharding > 1``
                 ``fused_refine_bundles_dp`` over the mesh's "data" axis
                 (``perms``: (epochs, N) orders, or (epochs, data shards,
                 rows a shard) for the data-parallel fit);
      profiles   ``sharded_estimate_profiles``.

    ``sigma_inv`` is not estimated (maha is rejected up front).  Every rank
    is given the whole (x, y)."""
    if cfg.metric == "maha":
        raise ValueError("class-sharded LogHD decodes l2/cos only "
                         "(maha needs the dense profile gather)")
    from repro_torch.api._impl import _encoder_and_encodings
    n_shards = max(1, int(cfg.class_sharding))
    data_shards = max(1, int(cfg.data_sharding))
    device = torch.device(device)
    enc, h = _encoder_and_encodings(enc_cfg, x, device, enc, encoded,
                                    generator)
    y = torch.as_tensor(y, device=device).to(torch.int64)

    c = cfg.n_classes
    book = torch.as_tensor(
        cb.build_codebook(c, cfg.n_bundles, cfg.k, alpha=cfg.alpha,
                          seed=cfg.seed, method=cfg.codebook_method),
        device=device)
    if prototypes is not None:
        bundles = build_bundles(torch.as_tensor(prototypes, device=device),
                                book, cfg.k, bipolar=cfg.bipolar_init)
    else:
        bundles = streaming_build_bundles(h, y, book, cfg.k,
                                          bipolar=cfg.bipolar_init)
    if data_shards > 1:
        bundles = fused_refine_bundles_dp(
            bundles, h, y, book, cfg.k, epochs=cfg.refine_epochs, lr=cfg.lr,
            batch_size=cfg.refine_batch,
            mesh=class_mesh(n_shards, data_shards), axis="data",
            seed=cfg.seed, perms=perms)
    else:
        bundles = fused_refine_bundles(
            bundles, h, y, book, cfg.k, epochs=cfg.refine_epochs, lr=cfg.lr,
            batch_size=cfg.refine_batch, seed=cfg.seed, perms=perms)
    profiles = sharded_estimate_profiles(bundles, h, y, c, n_shards)
    c_pad = _padded_rows(c, n_shards)
    rows = _local_rows(class_mesh(n_shards), c_pad)
    return ShardedLogHDModel(
        enc=enc, bundles=bundles, profiles=profiles,
        codebook=pad_rows(book, c_pad)[rows], sigma_inv=None,
        metric=cfg.metric, encoder_kind=enc_cfg.kind,
        class_sharding=n_shards, n_classes_real=c)

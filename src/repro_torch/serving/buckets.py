"""Shape buckets over the dispatch predict surface (port of
``repro.serving.buckets``).

Serving traffic arrives in any batch size.  ``BucketedPredict`` quantizes
batch sizes onto a fixed ladder of buckets (powers of two by default): a
batch of n rows is padded with zero rows up to the smallest bucket >= n,
and the padding is sliced off the labels.  The port compiles nothing, so
the buckets buy no executables today; they keep the number of distinct
batch shapes the kernels see to the ladder, which is what a later CUDA
graph per bucket needs, and they keep the JAX package's hit / miss
bookkeeping per (family, metric, kernels, residency, bucket), so the
service behaves and reports as it does there.

Every predict path is row-wise (similarities, then a per-row argmax), so
padded rows cannot change real rows.  Live caches register with
``api.dispatch.register_cache_clearer``, so ``api.dispatch.clear_cache()``
resets them.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

from repro_torch.api import dispatch
from repro_torch.api.models import HDModel
from repro_torch.core.quantize import QTensor
from repro_torch.hdc.conventional import pad_rows
from repro_torch.kernels import common

__all__ = ["bucket_sizes", "BucketedPredict", "BucketStats"]


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The default bucket ladder: powers of two up to (and incl.) max_batch.

    >>> bucket_sizes(8)
    (1, 2, 4, 8)
    >>> bucket_sizes(12)
    (1, 2, 4, 8, 12)
    """
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


# Live caches, so dispatch.clear_cache() can reset serving-layer state
# without dispatch importing upward.
_LIVE_CACHES: "weakref.WeakSet[BucketedPredict]" = weakref.WeakSet()


@dispatch.register_cache_clearer
def _clear_all_bucket_caches() -> None:
    for cache in list(_LIVE_CACHES):
        cache.clear()


@dataclasses.dataclass
class BucketStats:
    """Per-(family, bucket) accounting."""
    hits: int = 0
    misses: int = 0          # first use of a (family key, bucket) pair
    padded_rows: int = 0     # total pad rows dispatched (wasted work proxy)

    @property
    def calls(self) -> int:
        return self.hits + self.misses


class BucketedPredict:
    """Pad-to-bucket batch assembly over ``dispatch.predict_fn``.

    ``predict(model, h)`` pads ``h`` (n, D) up to the smallest bucket >= n,
    predicts at that fixed shape and returns the first n labels.  Batches
    larger than the top bucket are served in top-bucket-sized chunks.

    ``stats`` counts hits and misses per (family key, bucket): a miss is
    the first time a pair is seen, every later call is a hit.  In the JAX
    package a miss is one compile; ``ClassifierService.warmup`` visits every
    pair so that steady-state traffic sees no miss.
    """

    def __init__(self, buckets=None, max_batch: int = 64):
        self.buckets = (tuple(sorted(set(int(b) for b in buckets)))
                        if buckets is not None else bucket_sizes(max_batch))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid bucket ladder: {self.buckets!r}")
        self.stats = BucketStats()
        self._seen: dict = {}           # (family key, bucket) -> call count
        _LIVE_CACHES.add(self)

    # ------------------------------------------------------------- shapes --
    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (top bucket for oversized n; callers chunk).

        >>> BucketedPredict(buckets=(1, 2, 4, 8)).bucket_for(3)
        4
        """
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _family_key(self, model: HDModel, device: torch.device,
                    use_kernels: Optional[bool]) -> tuple:
        metric = getattr(model, "metric", "l2")
        if use_kernels is None:
            use_kernels = (model.kernel_dispatch
                           and common.use_kernels(device, metric))
        # residency: an int8-resident model (QTensor codes, dequantized per
        # call) is a different family entry from its f32 twin
        residency = tuple((name, getattr(model, name).bits)
                          for name in model.stored_leaves
                          if isinstance(getattr(model, name), QTensor))
        return (type(model), metric, bool(use_kernels), residency)

    # ------------------------------------------------------------ predict --
    def _predict_bucket(self, model: HDModel, h: torch.Tensor, bucket: int,
                        use_kernels: Optional[bool]) -> torch.Tensor:
        """One fixed-shape dispatch: pad (n, D) -> (bucket, D), slice n."""
        n = h.shape[0]
        key = self._family_key(model, h.device, use_kernels) + (bucket,)
        if key in self._seen:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        self._seen[key] = self._seen.get(key, 0) + 1
        if n < bucket:
            h = pad_rows(h, bucket)
            self.stats.padded_rows += bucket - n
        labels = dispatch.predict_fn(model, use_kernels)(model, h)
        return labels[:n]

    def predict(self, model: HDModel, h: torch.Tensor,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Labels for (n, D) pre-encoded queries, through the buckets.

        Row i of the result equals ``dispatch.predict_encoded(model, h)[i]``:
        padded rows never leak.  Nothing waits for the device."""
        n = h.shape[0]
        if n == 0:
            return torch.zeros((0,), dtype=torch.int64, device=h.device)
        top = self.max_bucket
        if n <= top:
            return self._predict_bucket(model, h, self.bucket_for(n),
                                        use_kernels)
        return torch.cat([self._predict_bucket(
            model, h[i:i + top], self.bucket_for(min(top, n - i)),
            use_kernels) for i in range(0, n, top)])

    # ------------------------------------------------------------ metrics --
    def executables(self) -> int:
        """Distinct (family, bucket) pairs this cache has dispatched (the
        JAX package's executables)."""
        return len(self._seen)

    def snapshot(self) -> dict:
        """JSON-able stats."""
        return {
            "buckets": list(self.buckets),
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "padded_rows": self.stats.padded_rows,
            "executables": self.executables(),
        }

    def clear(self) -> None:
        """Reset the bucket bookkeeping."""
        self._seen.clear()
        self.stats = BucketStats()

"""The classifier service: device-resident models behind a request queue
(port of ``repro.serving.service``).

``ClassifierService`` holds several typed models on one device, optionally
with int8 residency (``register(..., quantize_bits=8)``), behind a
deficit-round-robin request queue (``serving/queue.py``) and the bucket
ladder of ``serving/buckets.py``.

One service cycle (``step()``):

    admit up to max_batch queued requests of the round-robin head group
    stack their features -> pad to the batch's bucket -> encode (the
      hdc_encode kernel on the card)
    bucketed predict through api.dispatch.predict_fn (int8-resident models
      dequantize per call; device memory holds the codes)
    copy the labels to pinned host memory and record a CUDA event
    bind each request's future to its row of that batch

``step()`` returns once the batch is enqueued on the device; a future is
done when the batch's event has completed, and ``result()`` waits for it.
A cycle that raises binds the exception into exactly the affected futures
and the service keeps serving.  ``serve_forever()`` runs the cycle loop on
a background thread, on the service's device and stream, so host batch
assembly overlaps device work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.models import HDModel
from repro_torch.hdc.encoders import encode
from repro_torch.kernels.common import resolve_device
from repro_torch.serving.buckets import BucketedPredict
from repro_torch.serving.queue import PredictFuture, PredictRequest, RequestQueue

__all__ = ["ClassifierService", "BatchLabels"]


class BatchLabels:
    """The labels of one service cycle, as futures see them.

    On a CUDA device the labels are copied to pinned host memory without
    blocking and an event is recorded after the copy, so ``is_ready()``
    polls the event and ``__array__`` waits on it and then reads the one
    host copy of the batch.  On the CPU the labels are ready at once."""

    __slots__ = ("_host", "_event")

    def __init__(self, labels: torch.Tensor):
        self._event = None
        if labels.device.type == "cuda":
            host = torch.empty(labels.shape, dtype=labels.dtype,
                               pin_memory=True)
            host.copy_(labels, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(labels.device))
            labels = host
        self._host = labels.numpy()      # a view: read only after wait()

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> None:
        """Block until the batch's device work has finished."""
        if self._event is not None:
            self._event.synchronize()

    def __array__(self, dtype=None, copy=None):
        self.wait()
        return self._host if dtype is None else self._host.astype(dtype)


class ClassifierService:
    """Continuous-batched predict service over the typed classifier API.

    ``device=None`` means "cuda" and raises without a card; pass
    ``device="cpu"`` for the plain versions.

    >>> import numpy as np
    >>> from repro_torch.api import make_classifier
    >>> x = np.random.default_rng(0).standard_normal((60, 8), np.float32)
    >>> y = np.arange(60) % 3
    >>> clf = make_classifier("conventional", n_classes=3, in_features=8,
    ...                       dim=128, device="cpu").fit(x, y)
    >>> svc = ClassifierService({"conv": clf.model}, max_batch=16,
    ...                         device="cpu")
    >>> futs = [svc.submit("conv", x[i]) for i in range(5)]
    >>> svc.run_until_drained()
    5
    >>> [f.result() for f in futs] == clf.predict(x[:5]).tolist()
    True
    """

    def __init__(self, models: Optional[dict] = None, *,
                 max_batch: int = 64, buckets: Optional[Sequence[int]] = None,
                 max_depth: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.bucket_cache = BucketedPredict(buckets=buckets,
                                            max_batch=self.max_batch)
        # max_depth bounds the queue: submit past it raises QueueFullError
        # (counted in stats()["rejected"])
        self.queue = RequestQueue(max_depth=max_depth)
        self._models: dict[str, HDModel] = {}
        # the stream every cycle's kernels, copies and events go on, also
        # from the serve_forever thread
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._t0 = time.perf_counter()
        self._cycle_lock = threading.Lock()   # one cycle at a time
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()        # wakes an idle dispatch thread
        self.errors = 0                       # cycles that bound an exception
        self.padded_rows = 0                  # zero rows added before encode
        if models:
            for name, model in models.items():
                self.register(name, model)

    # ----------------------------------------------------------- registry --
    def register(self, name: str, model: HDModel, *,
                 quantize_bits: Optional[int] = None) -> None:
        """Add (or replace) a served model, moved to the service's device
        once, here.

        With ``quantize_bits=b`` the stored leaves are post-training
        quantized and the device holds the int8 ``QTensor`` codes (for
        b = 8 about 0.25x the f32 bytes); every predict dequantizes them
        through ``materialized()``, so labels equal ``predict_encoded`` on
        the quantized-then-materialized model."""
        if not isinstance(model, HDModel):
            raise TypeError(f"served models are typed repro_torch.api "
                            f"models, got {type(model).__name__}")
        model = model.to(self.device)
        if quantize_bits is not None:
            model = model.quantized(int(quantize_bits))
        else:
            model = model.materialized()
        self._models[name] = model

    def model(self, name: str) -> HDModel:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(f"unknown served model {name!r}; registered: "
                           f"{sorted(self._models)}") from None

    def served_models(self) -> tuple[str, ...]:
        return tuple(sorted(self._models))

    def model_bytes(self, name: str) -> int:
        """Device-resident bytes of `name`'s stored leaves (the shared
        encoder is not counted, as in ``model_bits``)."""
        return self.model(name).stored_bytes()

    # -------------------------------------------------------------- clock --
    def now(self) -> float:
        """Seconds since service start (the arrival / latency clock)."""
        return time.perf_counter() - self._t0

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _scope(self):
        """The service's device and stream, for a thread that steps it."""
        if self._stream is None:
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.device))
        scope.enter_context(torch.cuda.stream(self._stream))
        return scope

    # ------------------------------------------------------------- warmup --
    def warmup(self, model_names: Optional[Sequence[str]] = None) -> int:
        """Run every (model, bucket) pair once, through both input forms
        (encode then predict, and predict of an encoded batch), and wait
        for the device.  Afterwards steady-state traffic sees no bucket
        miss.  Returns the number of (model, bucket) pairs touched."""
        pairs = 0
        with self._cycle_lock:
            for name in (model_names if model_names is not None
                         else self.served_models()):
                model = self.model(name)
                n_feat, dim = model.enc["proj"].shape
                for b in self.bucket_cache.buckets:
                    h = encode(model.enc,
                               torch.zeros((b, n_feat), device=self.device),
                               model.encoder_kind)
                    self.bucket_cache.predict(model, h)
                    self.bucket_cache.predict(
                        model, torch.zeros((b, dim), device=self.device))
                    pairs += 1
            self._sync()
        return pairs

    # ------------------------------------------------------------- submit --
    def submit(self, model_name: str, x, *, encoded: bool = False,
               t_arrival: Optional[float] = None) -> PredictFuture:
        """Enqueue one request; returns its future.

        ``x`` is one feature vector (F,), or one pre-encoded hypervector
        (D,) with ``encoded=True``.  It is validated and cast to float32
        here, so a malformed submit raises at once and never poisons a
        service cycle.  ``t_arrival`` (service-clock seconds) lets open-loop
        load generators stamp the scheduled arrival.

        With a bounded queue (``max_depth=...``) a submit past the bound
        raises ``QueueFullError`` and is counted in
        ``stats()["rejected"]``."""
        model = self.model(model_name)              # fail fast on bad name
        x = np.asarray(x, np.float32)
        want = model.enc["proj"].shape[1 if encoded else 0]
        if x.shape != (want,):
            form = "pre-encoded hypervector" if encoded else "feature vector"
            raise ValueError(
                f"{model_name!r} expects a ({want},) {form}, got shape "
                f"{x.shape} — one request per submit; batch via repeated "
                f"submits (the scheduler batches for you)")
        req = PredictRequest(
            uid=self.queue.next_uid(), model_name=model_name,
            x=x, encoded=bool(encoded),
            t_arrival=self.now() if t_arrival is None else float(t_arrival))
        self.queue.push(req)
        self._work.set()                            # wake the dispatch thread
        return req.future

    # --------------------------------------------------------------- step --
    def step(self) -> list[PredictRequest]:
        """Run one service cycle; returns the admitted requests (empty if
        the queue was empty).  Does not wait for the device.

        If any stage of the cycle raises, the exception is bound into
        exactly this batch's futures (``result()`` re-raises it) and the
        service keeps serving the rest of the queue."""
        with self._cycle_lock:
            batch = self.queue.admit(self.max_batch)
            if not batch:
                return []
            try:
                model = self.model(batch[0].model_name)
                n = len(batch)
                bucket = self.bucket_cache.bucket_for(n)
                xs = np.stack([r.x for r in batch])
                if n < bucket:               # pad before encode: the
                    xs = np.concatenate(     # encoder sees bucket shapes too
                        [xs, np.zeros((bucket - n,) + xs.shape[1:],
                                      xs.dtype)])
                    self.padded_rows += bucket - n
                h = torch.from_numpy(xs).to(self.device)
                if not batch[0].encoded:
                    h = encode(model.enc, h, model.encoder_kind)
                labels = BatchLabels(self.bucket_cache.predict(model, h))
                for row, req in enumerate(batch):
                    req.future._bind(labels, row)
            except Exception as exc:         # noqa: BLE001 — bound, not lost
                self.errors += 1
                for req in batch:
                    req.future._set_exception(exc)
            return batch

    def run_until_drained(self, block: bool = False) -> int:
        """Cycle until the queue is empty; returns requests admitted.
        With ``block=True`` also waits for the last batch's device work."""
        total = 0
        labels = None
        while len(self.queue):
            batch = self.step()
            total += len(batch)
            if batch:
                labels = batch[-1].future._batch
        if block and labels is not None:
            labels.wait()
        return total

    # -------------------------------------------------- background thread --
    def serve_forever(self, *, poll_s: float = 0.01) -> None:
        """Start the background dispatch thread: it runs ``step()`` in a
        loop on the service's device and stream, so callers just ``submit``
        and ``result(timeout=...)``.  Raises if already serving.
        ``poll_s`` caps the idle re-check interval (submits wake the thread
        at once)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("serve_forever() already running — "
                               "shutdown() first")
        self._stop.clear()

        def _loop():
            with self._scope():
                while not self._stop.is_set():
                    if not self.step():
                        self._work.wait(poll_s)
                        self._work.clear()

        self._thread = threading.Thread(
            target=_loop, name="classifier-service-dispatch", daemon=True)
        self._thread.start()

    def serving(self) -> bool:
        """True while the background dispatch thread is running."""
        return self._thread is not None and self._thread.is_alive()

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the background dispatch thread (no-op if not serving).

        With ``drain=True`` (default) any still-queued requests are served
        after the thread stops, so shutdown never strands a pending future;
        with ``drain=False`` they stay queued."""
        if self._thread is not None:
            self._stop.set()
            self._work.set()                 # unblock an idle wait
            self._thread.join(timeout)
            self._thread = None
        if drain:
            with self._scope():
                self.run_until_drained()

    # -------------------------------------------------------------- stats --
    def stats(self) -> dict:
        return {
            "device": str(self.device),
            "served_models": list(self.served_models()),
            "admitted": self.queue.admitted,
            "cycles": self.queue.cycles,
            "queued": len(self.queue),
            "rejected": self.queue.rejected,
            "max_depth": self.queue.max_depth,
            "errors": self.errors,
            "padded_rows": self.padded_rows,
            "max_group_wait_cycles": self.queue.max_group_wait_cycles,
            "serving": self.serving(),
            "bucket_cache": self.bucket_cache.snapshot(),
        }

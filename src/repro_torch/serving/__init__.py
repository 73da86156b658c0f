"""repro_torch.serving — the classifier inference service of the port (of
``repro.serving``): device-resident models behind a fair request queue,
answering one-shot classify requests in batches on the card.

  queue.py      ``PredictRequest`` / ``PredictFuture`` / ``RequestQueue``:
                deficit-round-robin admission over per-(model, input-form)
                subqueues, futures with the full lifecycle, ``max_depth``
                backpressure (``QueueFullError``).
  buckets.py    ``BucketedPredict``: batches padded to a fixed bucket
                ladder, hit / miss bookkeeping per (family, residency,
                bucket), reset by ``api.dispatch.clear_cache``.
  service.py    ``ClassifierService``: models on the card (f32 or int8
                residency), encode (the ``hdc_encode`` kernel) -> bucketed
                predict cycles, error binding, ``serve_forever`` /
                ``shutdown``.
  loadgen.py    closed-loop and open-loop Poisson load; p50 / p99 latency
                and requests a second (``LoadResult``).

    from repro_torch.api import load_model
    from repro_torch.serving import ClassifierService
    svc = ClassifierService({"loghd": load_model("ckpt")}, max_batch=64)
    svc.warmup()
    fut = svc.submit("loghd", x_row)
    svc.run_until_drained()
    label = fut.result()
"""

from repro_torch.serving.buckets import BucketedPredict, bucket_sizes
from repro_torch.serving.loadgen import LoadResult, closed_loop, open_loop_poisson
from repro_torch.serving.queue import (PredictFuture, PredictRequest,
                                       QueueFullError, RequestQueue)
from repro_torch.serving.service import BatchLabels, ClassifierService

__all__ = [
    "ClassifierService", "BatchLabels",
    "BucketedPredict", "bucket_sizes",
    "RequestQueue", "PredictRequest", "PredictFuture", "QueueFullError",
    "LoadResult", "closed_loop", "open_loop_poisson",
]

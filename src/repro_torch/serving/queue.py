"""Request queue, result futures and the fair slot admission (port of
``repro.serving.queue``; numpy and threading only).

A "slot" lives for one service cycle: each cycle the scheduler admits up to
``max_batch`` queued requests, the service runs them as one batch, and
every slot is free again.

Admission is **deficit-round-robin over per-group subqueues** (a group is
one (model, input-form) pair, the unit one batch can serve).  Each cycle
serves the group at the head of the round-robin ring with a quantum of
``max_batch`` slots, then rotates it to the tail; every request costs one
slot, so DRR's deficit counters reduce to rotate-after-service.  This
gives:

  * **within-group FIFO**: each subqueue is a deque, arrival order kept;
  * **grouped slots**: one (model, input-form) group per cycle;
  * **bounded wait**: a group with a pending head request is served within
    ``n_groups`` admit cycles, however hot the other groups run.

Futures carry the full result lifecycle::

    pending --cancel()--> cancelled
       |
       +--(cycle dispatch)--> dispatched --(device work done)--> done
       |
       +--(cycle raises)----> failed          # result() re-raises

Binding a batch does not block.  The bound batch object reports readiness
through ``is_ready()`` (the service's batch: a CUDA event recorded after
the batch's predict, or always ready on the CPU) and gives its labels
through ``__array__``, which waits for the device work; ``done()`` polls
readiness without blocking, and exceptions raised by a service cycle are
bound into exactly the affected futures, so a failed cycle never loses a
request.
"""

from __future__ import annotations

import collections
import itertools
import threading
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

__all__ = ["PredictRequest", "PredictFuture", "RequestQueue",
           "QueueFullError", "CancelledError"]


class QueueFullError(RuntimeError):
    """Raised by ``RequestQueue.push`` (and ``ClassifierService.submit``)
    when the queue already holds ``max_depth`` requests.

    Bounded-queue backpressure: under sustained overload an unbounded queue
    converts overload into unbounded memory growth and unbounded latency;
    a bounded queue converts it into explicit, countable rejections the
    caller can retry, shed, or surface.  The rejection is counted in
    ``RequestQueue.rejected`` / ``ClassifierService.stats()["rejected"]``.
    """


class PredictFuture:
    """Result handle for one submitted request.

    States: *pending* (queued, cancellable) -> *dispatched* (bound to a row
    of the async device batch) -> resolved; or terminally *failed* (a
    service-cycle exception was bound; ``result()`` re-raises it) or
    *cancelled* (``cancel()`` won before dispatch).

    ``done()`` is True only when ``result()`` would not block: the label is
    resolved, an exception/cancellation is bound, or the device work of the
    bound batch has finished (non-blocking ``is_ready`` poll).  "The batch
    was dispatched, the result may still be in flight" is
    ``dispatched()``.

    ``result(timeout=...)`` / ``exception(timeout=...)`` wait up to
    ``timeout`` seconds for the request to leave *pending* (a background
    dispatch thread makes this the queueing delay); with ``timeout=None``
    they fail fast with ``RuntimeError`` instead of risking a deadlock when
    nothing is driving the service.
    """

    __slots__ = ("_lock", "_event", "_state", "_batch", "_row", "_resolved",
                 "_exc")

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()   # set on dispatch/failure/cancel
        self._state = "pending"
        self._batch = None
        self._row = -1
        self._resolved: Optional[int] = None
        self._exc: Optional[BaseException] = None

    # -------------------------------------------------- producer (service) --
    def _bind(self, batch_labels, row: int) -> None:
        """Bind to one row of the async batched device result."""
        with self._lock:
            if self._state != "pending":          # cancelled raced the cycle
                return
            self._batch = batch_labels
            self._row = row
            self._state = "dispatched"
            self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        """Bind a service-cycle exception; ``result()`` re-raises it."""
        with self._lock:
            if self._state == "cancelled":
                return
            self._exc = exc
            self._batch = None
            self._state = "failed"
            self._event.set()

    # ------------------------------------------------------ consumer state --
    def cancel(self) -> bool:
        """Cancel if still pending (undelivered).  Returns True when this
        call (or an earlier one) cancelled the request; False once the
        request was dispatched or failed — matching
        ``concurrent.futures.Future.cancel`` semantics."""
        with self._lock:
            if self._state == "pending":
                self._state = "cancelled"
                self._event.set()
                return True
            return self._state == "cancelled"

    def cancelled(self) -> bool:
        return self._state == "cancelled"

    def dispatched(self) -> bool:
        """True once the request's batch went to the device (the result may
        still be in flight) or the future is terminally failed/resolved."""
        return self._state in ("dispatched", "failed") \
            or self._resolved is not None

    def done(self) -> bool:
        """True iff ``result()`` would not block: resolved, failed,
        cancelled, or the bound batch's device work has finished."""
        if (self._resolved is not None or self._exc is not None
                or self._state == "cancelled"):
            return True
        batch = self._batch
        if batch is None:
            return False
        is_ready = getattr(batch, "is_ready", None)   # non-blocking poll
        return bool(is_ready()) if is_ready is not None else True

    def _wait(self, timeout: Optional[float]) -> None:
        """Leave *pending* or raise (RuntimeError on no-timeout, else
        TimeoutError)."""
        if self._event.is_set():
            return
        if timeout is None:
            raise RuntimeError("request not dispatched yet — drive the "
                               "service (step()/run_until_drained()/"
                               "serve_forever()), or pass a timeout")
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not dispatched within {timeout}s")

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The exception bound by a failed service cycle, or None once the
        request dispatched cleanly.  Raises CancelledError if cancelled."""
        self._wait(timeout)
        if self._state == "cancelled":
            raise CancelledError()
        return self._exc

    def result(self, timeout: Optional[float] = None) -> int:
        """The int label.  Re-raises the bound exception for a failed cycle
        and CancelledError for a cancelled request; ``timeout`` bounds the
        wait for dispatch (the device work itself is already enqueued and is
        waited for here)."""
        if self._resolved is None:
            self._wait(timeout)
            if self._state == "cancelled":
                raise CancelledError()
            if self._exc is not None:
                raise self._exc
            self._resolved = int(np.asarray(self._batch)[self._row])
            self._batch = None               # drop the batch ref
        return self._resolved


@dataclass
class PredictRequest:
    """One classify request: raw features (or a pre-encoded hypervector)."""
    uid: int
    model_name: str
    x: np.ndarray                 # (F,) raw features or (D,) encoded
    encoded: bool = False         # x is already phi(x)
    t_arrival: float = 0.0        # load-gen timestamp (service-clock seconds)
    future: PredictFuture = field(default_factory=PredictFuture)

    @property
    def group(self) -> tuple:
        """(model, input form) — the unit one batch serves."""
        return (self.model_name, self.encoded)


class RequestQueue:
    """Deficit-round-robin queue with grouped slot admission.

    Requests land in per-group FIFO subqueues; ``admit(max_batch)`` serves
    the group at the head of the round-robin ring (up to ``max_batch``
    requests, arrival order kept) and rotates it to the tail, so any group
    with a pending head request is admitted within ``n_groups`` cycles.
    All mutating entry points are lock-protected, so submit threads and a
    background dispatch thread can share the queue.

    ``max_group_wait_cycles`` records the worst head-of-group wait observed
    (in admit cycles).

    ``max_depth`` bounds the total queued requests across all groups:
    a ``push`` past the bound raises ``QueueFullError`` and increments
    ``rejected``.  The default ``None`` leaves the queue unbounded.
    """

    def __init__(self, max_depth: Optional[int] = None):
        if max_depth is not None and int(max_depth) < 1:
            raise ValueError("max_depth must be >= 1 (or None for unbounded)")
        self.max_depth = None if max_depth is None else int(max_depth)
        self._lock = threading.Lock()
        self._groups: dict[tuple, collections.deque] = {}   # insertion order
        self._ring: collections.deque[tuple] = collections.deque()
        self._waiting_since: dict[tuple, int] = {}
        self._uids = itertools.count()
        self.admitted = 0
        self.cycles = 0
        self.rejected = 0
        self.max_group_wait_cycles = 0

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._groups.values())

    def __iter__(self) -> Iterator[PredictRequest]:
        """Snapshot iteration in service order: ring order, FIFO per group."""
        with self._lock:
            order = list(self._ring)
            return iter([r for g in order for r in self._groups[g]])

    def next_uid(self) -> int:
        return next(self._uids)

    def n_groups(self) -> int:
        """Groups with queued requests (the bounded-wait denominator)."""
        with self._lock:
            return len(self._ring)

    def push(self, req: PredictRequest) -> PredictFuture:
        with self._lock:
            if self.max_depth is not None and \
                    sum(len(q) for q in self._groups.values()) \
                    >= self.max_depth:
                self.rejected += 1
                raise QueueFullError(
                    f"request queue full ({self.max_depth} queued) — the "
                    f"service is not draining as fast as requests arrive; "
                    f"retry later or shed load")
            group = req.group
            sub = self._groups.get(group)
            if sub is None:
                sub = self._groups[group] = collections.deque()
            if not sub:                      # group becomes ready this cycle
                self._ring.append(group)
                self._waiting_since[group] = self.cycles
            sub.append(req)
        return req.future

    def admit(self, max_batch: int) -> list[PredictRequest]:
        """Pop the next cycle's batch (possibly empty).

        Serves the ring-head group with a quantum of ``max_batch`` slots
        (every request costs one slot, so DRR's deficit counters degenerate
        to rotate-after-service), skipping requests whose future was
        cancelled while queued.  An admit on an empty queue is not a cycle.
        """
        with self._lock:
            batch: list[PredictRequest] = []
            while self._ring and not batch:
                group = self._ring.popleft()
                sub = self._groups[group]
                wait = self.cycles - self._waiting_since.get(group,
                                                             self.cycles)
                while sub and len(batch) < max_batch:
                    req = sub.popleft()
                    if req.future.cancelled():
                        continue
                    batch.append(req)
                if sub:                      # backlog: rotate to the tail
                    self._ring.append(group)
                    self._waiting_since[group] = self.cycles + 1
                else:
                    del self._groups[group]
                    self._waiting_since.pop(group, None)
                if batch:
                    self.max_group_wait_cycles = max(
                        self.max_group_wait_cycles, wait)
            if not batch:
                return []
            self.admitted += len(batch)
            self.cycles += 1
            return batch

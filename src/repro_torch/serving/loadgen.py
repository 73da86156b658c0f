"""Load generation for the classifier service: closed-loop saturation and
open-loop Poisson arrivals, with p50 / p99 latency and requests a second
(port of ``repro.serving.loadgen``).

  * **closed loop**: every request is queued up front and the load generator
    cycles the service flat out; the number that matters is requests a
    second at saturation.
  * **open loop**: arrivals follow a seeded exponential inter-arrival
    clock that does not wait for the service, so queue growth under
    overload shows; latency is completion minus *scheduled* arrival.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.queue import QueueFullError
from repro_torch.serving.service import ClassifierService

__all__ = ["LoadResult", "closed_loop", "open_loop_poisson"]


@dataclasses.dataclass(frozen=True)
class LoadResult:
    """One load-generation run's summary (times in seconds / ms as named)."""
    mode: str
    n_requests: int
    wall_s: float
    rps: float                  # completed requests per second of wall clock
    p50_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    n_rejected: int = 0         # submits refused by a bounded queue

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


def _summarize(mode: str, latencies_s: np.ndarray, wall_s: float,
               n_rejected: int = 0) -> LoadResult:
    lat_ms = np.asarray(latencies_s, np.float64) * 1e3
    return LoadResult(
        mode=mode, n_requests=int(lat_ms.size), wall_s=float(wall_s),
        rps=float(lat_ms.size / max(wall_s, 1e-9)),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        mean_ms=float(lat_ms.mean()), max_ms=float(lat_ms.max()),
        n_rejected=int(n_rejected))


def closed_loop(service: ClassifierService, model_name: str, xs,
                *, encoded: bool = False) -> LoadResult:
    """Saturation: queue everything, cycle flat out, then take the results
    in dispatch order (DRR admission: FIFO within a group).  The cycles do
    not wait for the device, so it works while the host assembles the next
    batch."""
    xs = np.asarray(xs)
    t_start = service.now()
    for x in xs:
        service.submit(model_name, x, encoded=encoded, t_arrival=t_start)
    dispatched = []
    while len(service.queue):
        dispatched.extend(service.step())
    lat = []
    for req in dispatched:
        req.future.result()
        lat.append(service.now() - req.t_arrival)
    wall = service.now() - t_start
    return _summarize("closed_loop", np.asarray(lat), wall)


def open_loop_poisson(service: ClassifierService, model_name: str, xs,
                      *, rate_rps: float, n_requests: int, seed: int = 0,
                      encoded: bool = False) -> LoadResult:
    """Poisson arrivals at ``rate_rps`` from a numpy generator seeded with
    `seed`; latency is measured from the *scheduled* arrival.  With a
    bounded service queue an arrival that finds it full is rejected and
    counted in ``LoadResult.n_rejected``, not retried."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    xs = np.asarray(xs)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    t_start = service.now()
    completions: dict[int, float] = {}
    n_rejected = 0
    i = 0
    while i < n_requests or len(service.queue):
        now = service.now() - t_start
        while i < n_requests and arrivals[i] <= now:
            try:
                service.submit(model_name, xs[i % len(xs)], encoded=encoded,
                               t_arrival=t_start + arrivals[i])
            except QueueFullError:
                n_rejected += 1
            i += 1
        batch = service.step()
        if batch:
            last = batch[-1].future._batch
            if last is not None:
                last.wait()
            t_done = service.now()
            for req in batch:
                req.future.result()
                completions[req.uid] = t_done - req.t_arrival
        elif i < n_requests:
            # idle until the next scheduled arrival (open loop: the clock
            # is not fast-forwarded)
            time.sleep(max(min(arrivals[i] - now, 1e-3), 0.0))
    wall = service.now() - t_start
    lat = np.asarray([completions[uid] for uid in sorted(completions)])
    return _summarize("open_loop_poisson", lat, wall, n_rejected)

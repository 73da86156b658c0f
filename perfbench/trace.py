"""The reduction of a traced window to what the per-layer metrics read.

A traced run records its window under ``torch.profiler`` (host and CUDA
activity) with the harness's own ranges around the calls it makes into
the program (``perfbench.window`` around the whole window; inside it
``perfbench.encode``, ``perfbench.predict_encoded``,
``perfbench.train_step``, ``perfbench.collect``), exports the Chrome
trace and reads it back here:

  * device operations: every kernel, copy and memset on the card, each
    attributed to the harness range the host was in when it launched it
    (the launch is found by the CUPTI correlation id);
  * busy time: the union of the device operations' intervals inside the
    window, so overlapping streams count once;
  * idle gaps: the window's stretches with no device operation, each
    named by the harness range the host was in when the gap began.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import gzip
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
PREFIX = "perfbench."
OUTSIDE = "outside a harness range"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float          # seconds on the trace's clock
    end: float
    span: str             # the harness range its launch lies in


@dataclasses.dataclass
class Traced:
    """One traced window: its device operations, the harness ranges and
    the window's bounds (seconds)."""
    ops: list
    spans: list           # (start, end, name), harness ranges but the window
    window: tuple         # (start, end)
    unattributed: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        lo, hi = self.window
        out: list = []
        for op in sorted(self.ops, key=lambda o: o.start):
            s, e = max(op.start, lo), min(op.end, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def in_window(self) -> list:
        lo, hi = self.window
        return [op for op in self.ops if op.end > lo and op.start < hi]

    def span_count(self, name: str) -> int:
        return sum(1 for _, _, n in self.spans if n == name)

    def device_s(self, span: str) -> float:
        """Seconds of device operations launched inside range `span`."""
        return sum(op.end - op.start for op in self.ops if op.span == span)

    @functools.cached_property
    def _starts(self) -> list:
        return [s for s, _, _ in self.spans]

    def host_span_at(self, t: float) -> str:
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        lo, hi = self.window
        return WINDOW if lo <= t < hi else OUTSIDE

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name) and the
        idle time of the window by the harness range the host was in."""
        by_name: collections.Counter = collections.Counter()
        for op in self.in_window():
            by_name[op.name] += op.end - op.start
        gaps: collections.Counter = collections.Counter()
        t = self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1],) * 2]:
            if s > t:
                gaps[self.host_span_at(t)] += s - t
            t = max(t, e)
        return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}


def reduce_events(events: list) -> Traced:
    """A ``Traced`` from a Chrome trace's ``traceEvents`` (timestamps in
    microseconds)."""
    launch_at: dict = {}
    spans, window, device = [], None, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, ts, ts + dur, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch_at[corr] = ts
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW} range")
    spans.sort()
    traced = Traced(ops=[], spans=spans, window=window)
    for name, s, e, corr in device:
        t = launch_at.get(corr)
        if t is None:
            traced.unattributed += 1
            span = OUTSIDE
        else:
            span = traced.host_span_at(t)
        traced.ops.append(DeviceOp(name, s, e, span))
    return traced


def load(path: Path) -> Traced:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return reduce_events(json.load(f)["traceEvents"])

"""The program's own spans in a traced window: device time, launches and
idle time of the training step by the ``repro_torch.*`` range they came
from.

The program marks its layers with ``repro_torch.spans.span``, a
``record_function`` while a profiler records, so its ranges lie in the
trace the harness writes, on the same clock as the device operations and
beside the harness's own ``perfbench.*`` ranges (``perfbench/trace.py``
reads those alone).  This module reads that trace again and puts each
device operation launched inside a ``perfbench.train_step`` range down to
one span:

  * the innermost layer span (a ``repro_torch.*`` range but the
    ``repro_torch.train.*`` ones) open on the launching thread at the
    launch;
  * else, where that thread was evaluating a backward node
    (``autograd::engine::evaluate_function: <Node>``), the innermost layer
    span open around the forward operation that made the node: the one
    with the node's ``Sequence number`` on the thread its ``Fwd thread
    id`` names;
  * else the innermost ``repro_torch.train.*`` range open on the launching
    thread, or else on any thread (the backward runs on autograd's own
    thread while the step's thread waits in ``repro_torch.train.backward``);
  * else ``outside``.

Each idle stretch of the window that begins inside a
``perfbench.train_step`` range is put down by the same rule, at the time it
begins, on the thread that launched the operation that ends it.

Ranges are kept per thread: host ranges nest on one thread, not across
threads.  ``Fwd thread id`` is the profiler's own number for a thread,
not the system's: each is mapped to the thread whose forward operations
carry most of its nodes' sequence numbers.  A metric reads the trace of
its own run: among the ``<config>.*`` traces (the cells of a
configuration share that prefix), the one whose ``perfbench.window`` is
the traced window's.  The parse is cached on the trace file's path,
modification time and size, so the metrics of one run read the file once.

Run as ``python -m perfbench.spans [TRACE]`` after a traced run
(``--trace 1``) to print the table of a step by span: the trace given, or
else the newest one under ``build/perfbench``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import argparse
import gzip
import json
import sys
from pathlib import Path

from perfbench import trace

PREFIX = "repro_torch."
TRAIN = "repro_torch.train."
STEP = "perfbench.train_step"
OUTSIDE = "outside"
NODE = "autograd::engine::evaluate_function: "
TRACES = "build/perfbench"


def innermost(intervals: list, times: list) -> list:
    """For each time of `times`, the payload of the innermost interval of
    `intervals` ((start, end, payload), nested as one thread's ranges
    are) that holds it, or None."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [None] * len(times)
    stack: list = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def _by_thread(queries: list, intervals: dict) -> list:
    """``innermost`` for (thread, time) queries against per-thread
    intervals."""
    groups: dict = collections.defaultdict(list)
    for q, (tid, t) in enumerate(queries):
        groups[tid].append(q)
    out = [None] * len(queries)
    for tid, qs in groups.items():
        found = innermost(intervals.get(tid, []), [queries[q][1] for q in qs])
        for q, f in zip(qs, found):
            out[q] = f
    return out


class Threads:
    """One trace's host ranges by thread, and the rule that puts a
    (thread, time) of the host down to a span."""

    def __init__(self, events: list):
        self.layer = collections.defaultdict(list)   # tid -> (s, e, name)
        self.train = collections.defaultdict(list)   # tid -> (s, e, name)
        self.nodes = collections.defaultdict(list)   # tid -> (s, e, node)
        self.forward = collections.defaultdict(dict)  # tid -> {seq: ts}
        self.seen: set = set()
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts = float(ev["ts"]) * 1e-6
            iv = (ts, ts + float(ev.get("dur", 0)) * 1e-6)
            tid = ev.get("tid")
            if cat == "user_annotation" and name.startswith(PREFIX):
                self.seen.add(name)
                (self.train if name.startswith(TRAIN)
                 else self.layer)[tid].append((*iv, name))
            elif cat == "cpu_op":
                args = ev.get("args") or {}
                seq = args.get("Sequence number")
                if seq is None:
                    continue
                fwd = args.get("Fwd thread id", 0)
                if name.startswith(NODE):
                    self.nodes[tid].append(
                        (*iv, (name[len(NODE):], seq, fwd)))
                elif not fwd:
                    first = self.forward[tid].get(seq, ts)
                    self.forward[tid][seq] = min(first, ts)
        self.any_train = [iv for ivs in self.train.values() for iv in ivs]
        self.fwd_tid = self._map_fwd_threads()

    def _map_fwd_threads(self) -> dict:
        """The profiler's forward-thread numbers -> the trace's thread
        ids, by the most sequence numbers in common."""
        wanted: dict = collections.defaultdict(set)
        for ivs in self.nodes.values():
            for _, _, (_, seq, fwd) in ivs:
                wanted[fwd].add(seq)
        return {fwd: max(self.forward, default=None,
                         key=lambda tid: len(seqs & self.forward[tid].keys()))
                for fwd, seqs in wanted.items()}

    def node_span(self, nodes: list) -> list:
        """The innermost layer span around the forward operation of each
        (name, seq, fwd) node, or None."""
        queries, idx = [], []
        for q, node in enumerate(nodes):
            if node is None:
                continue
            _, seq, fwd = node
            tid = self.fwd_tid.get(fwd)
            ts = self.forward.get(tid, {}).get(seq)
            if ts is not None:
                queries.append((tid, ts))
                idx.append(q)
        out = [None] * len(nodes)
        for q, name in zip(idx, _by_thread(queries, self.layer)):
            out[q] = name
        return out

    def assign(self, queries: list) -> list:
        """The span each (thread, time) of the host is put down to."""
        out = _by_thread(queries, self.layer)
        rest = [q for q, name in enumerate(out) if name is None]
        linked = self.node_span(_by_thread([queries[q] for q in rest],
                                           self.nodes))
        for q, name in zip(rest, linked):
            out[q] = name
        rest = [q for q, name in enumerate(out) if name is None]
        own = _by_thread([queries[q] for q in rest], self.train)
        anyt = innermost(self.any_train, [queries[q][1] for q in rest])
        for q, a, b in zip(rest, own, anyt):
            out[q] = a or b or OUTSIDE
        return out

    def links(self) -> collections.Counter:
        """(node name, the layer span it links to) over every backward
        node of the trace."""
        nodes = [iv[2] for ivs in self.nodes.values() for iv in ivs]
        return collections.Counter(
            (n[0], s) for n, s in zip(nodes, self.node_span(nodes)))


@dataclasses.dataclass
class Reading:
    """The training steps of one traced window by span: device seconds
    and launches of the operations launched inside them, and the idle
    seconds that began inside them."""
    window: tuple | None
    steps: int
    seen: set
    device_s: collections.Counter
    launches: collections.Counter
    idle_s: collections.Counter

    def table(self) -> str:
        names = sorted(set(self.device_s) | set(self.idle_s),
                       key=lambda n: -self.device_s[n])
        n = max(self.steps, 1)
        rows = [f"  {k:<30} {1e3 * self.device_s[k] / n:10.3f} "
                f"{self.launches[k] / n:9.1f} {1e3 * self.idle_s[k] / n:9.3f}"
                for k in names]
        total = (f"  {'whole step':<30} "
                 f"{1e3 * sum(self.device_s.values()) / n:10.3f} "
                 f"{sum(self.launches.values()) / n:9.1f} "
                 f"{1e3 * sum(self.idle_s.values()) / n:9.3f}")
        head = (f"  {'span':<30} {'device ms':>10} {'launches':>9} "
                f"{'idle ms':>9}   (a step, {self.steps} steps)")
        return "\n".join([head, *rows, total])


def reduce_events(events: list) -> Reading:
    """A ``Reading`` from a Chrome trace's ``traceEvents``."""
    threads = Threads(events)
    launch: dict = {}
    steps, window, device = [], None, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]) * 1e-6, float(ev.get("dur", 0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS:
            device.append((ts, ts + dur, corr))
        elif cat in trace.LAUNCH_CATS and corr is not None:
            launch[corr] = (ev.get("tid"), ts)
        elif cat == "user_annotation" and name == trace.WINDOW:
            window = (ts, ts + dur)
        elif cat == "user_annotation" and name == STEP:
            steps.append((ts, ts + dur))
    steps.sort()
    starts = [s for s, _ in steps]

    def in_step(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < steps[i][1]

    # operations launched inside a step, by span
    ops = [(s, e, launch[c]) for s, e, c in device
           if c in launch and in_step(launch[c][1])]
    device_s: collections.Counter = collections.Counter()
    launches: collections.Counter = collections.Counter()
    for (s, e, _), name in zip(ops, threads.assign([o[2] for o in ops])):
        device_s[name] += e - s
        launches[name] += 1

    # idle stretches of the window that begin inside a step, by span
    idle_s: collections.Counter = collections.Counter()
    if window is not None:
        lo, hi = window
        busy: list = []
        for s, e, c in sorted(device, key=lambda d: d[0]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e, c])
        gaps, t = [], lo
        for s, e, c in busy + [[hi, hi, None]]:
            if s > t and in_step(t):
                tid = launch[c][0] if c in launch else None
                gaps.append((s - t, (tid, t)))
            t = max(t, e)
        for (g, _), name in zip(gaps, threads.assign([q for _, q in gaps])):
            idle_s[name] += g
    return Reading(window=window, steps=len(steps), seen=threads.seen,
                   device_s=device_s, launches=launches, idle_s=idle_s)


def _read(path: str) -> Reading:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return reduce_events(json.load(f)["traceEvents"])


def _stamp(path: Path) -> tuple:
    st = path.stat()
    return str(path), st.st_mtime_ns, st.st_size


@functools.lru_cache(maxsize=2)
def _parse(path: str, mtime_ns: int, size: int) -> Reading:
    return _read(path)


@functools.lru_cache(maxsize=1)
def _report(path: str, mtime_ns: int, size: int) -> None:
    table = _parse(path, mtime_ns, size).table()
    print(f"perfbench: spans of {path}:\n{table}", file=sys.stderr)


def traces(root: Path, pattern: str = "*") -> list:
    """The ``<pattern>.trace.json.gz`` files under `root`'s
    ``build/perfbench``, newest first."""
    return sorted((root / TRACES).glob(f"{pattern}.trace.json.gz"),
                  key=lambda p: p.stat().st_mtime_ns, reverse=True)


def reading(ctx, root: Path) -> Reading | None:
    """The ``Reading`` of the trace whose window is the traced window,
    its table printed once to standard error; None where the window has
    no device operation or no step, no trace of the configuration has
    that window, or the program no span."""
    if not ctx.traced.ops or not ctx.traced.span_count(STEP):
        return None
    for path in traces(root, f"{ctx.config['name']}.*"):
        stamp = _stamp(path)
        r = _parse(*stamp)
        if r.window == tuple(ctx.traced.window):
            _report(*stamp)
            return r if r.seen else None
    return None


def device_ms(ctx, root: Path, span: str) -> float | None:
    """Milliseconds of device time a step put down to `span`, over the
    steps of the traced window; None where the program has no such
    span."""
    r = reading(ctx, root)
    if r is None or span not in r.seen:
        return None
    return 1e3 * r.device_s[span] / ctx.traced.span_count(STEP)


def idle_ms(ctx, root: Path) -> float | None:
    """Milliseconds a step of idle time put down to one of the program's
    spans."""
    r = reading(ctx, root)
    if r is None:
        return None
    idle = sum(v for k, v in r.idle_s.items() if k != OUTSIDE)
    return 1e3 * idle / ctx.traced.span_count(STEP)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", nargs="?", type=Path,
                    help="a Chrome trace (.json or .json.gz); default: the "
                         f"newest under {TRACES}")
    args = ap.parse_args(argv)
    path = args.trace
    if path is None:
        found = traces(Path("."))
        if not found:
            print(f"perfbench: no trace under {TRACES}", file=sys.stderr)
            return 1
        path = found[0]
    print(_read(str(path)).table())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``perfbench/spans.py``, the reader of the program's own spans: on
synthetic Chrome-trace events, each launch put down to the innermost span
of its own thread, a backward node linked by its sequence number to the
layer of its forward operation, idle stretches put down the same way; on
a CPU trace of the small train cell, the backward nodes of attention, the
router and the experts linked to their layers; and the six metrics that
read the spans silent where a trace has no device operation or the
program no span."""

from __future__ import annotations

import gzip
import json
import os
import shutil

import pytest
import torch

from perfbench import harness, small_cells, spans, trace

ROOT = harness.ROOT
METRICS = ("attention_ms.train", "moe_route_ms.train",
           "moe_experts_ms.train", "head_ms.train", "optimizer_ms.train",
           "dispatch_gap_ms.train")
MAIN, AUTOGRAD = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid,
              correlation=corr)


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, 0, correlation=corr)


def _step_events():
    """One step: a forward with attention and the MoE routing, a backward
    on autograd's thread, the optimizer.  Times in microseconds."""
    return [
        _x("user_annotation", "perfbench.window", 0, 1000),
        _x("user_annotation", "perfbench.train_step", 10, 900),
        _x("user_annotation", "repro_torch.train.forward", 20, 300),
        _x("user_annotation", "repro_torch.attention", 30, 100),
        _x("cpu_op", "aten::softmax", 40, 10, **{
            "Sequence number": 7, "Fwd thread id": 0}),
        _launch(41, 1),                        # attention, main thread
        _x("user_annotation", "repro_torch.moe.route", 200, 50),
        _x("cpu_op", "aten::cumsum", 205, 10, **{
            "Sequence number": 9, "Fwd thread id": 0}),
        _launch(206, 2),                       # moe.route
        _launch(260, 3),                       # the forward, no layer
        _launch(100, 4, tid=AUTOGRAD),         # another thread, same time
        _x("user_annotation", "repro_torch.train.backward", 330, 400),
        _x("cpu_op", f"{spans.NODE}SoftmaxBackward0", 340, 50, AUTOGRAD,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _launch(345, 5, tid=AUTOGRAD),         # linked to attention
        _x("cpu_op", f"{spans.NODE}CumsumBackward0", 400, 50, AUTOGRAD,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _launch(405, 6, tid=AUTOGRAD),         # linked to moe.route
        _x("cpu_op", f"{spans.NODE}MulBackward0", 460, 50, AUTOGRAD,
           **{"Sequence number": 3, "Fwd thread id": 1}),
        _launch(465, 7, tid=AUTOGRAD),         # no forward op: backward
        _x("user_annotation", "repro_torch.train.optimizer", 750, 50),
        _launch(760, 8),
        _launch(950, 9),                       # after the step
        _kernel(50, 100, 1), _kernel(210, 20, 2), _kernel(270, 10, 3),
        _kernel(150, 10, 4), _kernel(350, 30, 5), _kernel(410, 40, 6),
        _kernel(470, 5, 7), _kernel(770, 60, 8), _kernel(960, 10, 9),
    ]


def test_launches_go_to_the_innermost_span_of_their_own_thread():
    r = spans.reduce_events(_step_events())
    assert r.steps == 1
    assert r.seen == {"repro_torch.train.forward", "repro_torch.attention",
                      "repro_torch.moe.route", "repro_torch.train.backward",
                      "repro_torch.train.optimizer"}
    us = {k: round(v * 1e6, 6) for k, v in r.device_s.items()}
    # attention: its own launch (100) and its backward node's (30); the
    # other thread's launch at 100 us is no attention: the forward's
    assert us == {"repro_torch.attention": 130, "repro_torch.moe.route": 60,
                  "repro_torch.train.forward": 20,
                  "repro_torch.train.backward": 5,
                  "repro_torch.train.optimizer": 60}
    # every operation launched inside the step once, the one after it not
    assert sum(r.launches.values()) == 8
    assert r.launches["repro_torch.attention"] == 2


def test_a_backward_node_links_to_its_forward_operations_layer():
    th = spans.Threads(_step_events())
    assert th.fwd_tid == {1: MAIN}
    assert th.links() == {("SoftmaxBackward0", "repro_torch.attention"): 1,
                          ("CumsumBackward0", "repro_torch.moe.route"): 1,
                          ("MulBackward0", None): 1}
    # a thread in no span and no node, in no train span anywhere: outside
    assert th.assign([(MAIN, 5.0e-6), (AUTOGRAD, 345.0e-6),
                      (AUTOGRAD, 700.0e-6)]) == [
        spans.OUTSIDE, "repro_torch.attention", "repro_torch.train.backward"]


def test_idle_stretches_go_to_the_span_of_the_thread_that_ends_them():
    r = spans.reduce_events(_step_events())
    us = {k: round(v * 1e6, 6) for k, v in r.idle_s.items()}
    # busy 50-160, 210-230, 270-280, 350-380, 410-450, 470-475, 770-830,
    # 960-970.  The idle stretches that begin inside the step (10-910), by
    # the thread that launched the operation ending each, at its start:
    # 160-210 main, in the forward; 230-270 main, in the routing; 280-350
    # autograd's, in nothing of its own: the forward on the main thread;
    # 380-410 autograd's, in the attention's backward node; 450-470
    # autograd's, between nodes: the backward; 475-770 main, in the
    # backward; 830-960 main, in no span of the program
    assert us == {"repro_torch.train.forward": 50 + 70,
                  "repro_torch.moe.route": 40,
                  "repro_torch.attention": 30,
                  "repro_torch.train.backward": 20 + 295,
                  spans.OUTSIDE: 130}
    # the window's idle time before and after the step is no step's
    t = trace.reduce_events(_step_events())
    assert sum(r.idle_s.values()) == pytest.approx(
        t.window_s - t.busy_s - (50 + 30) * 1e-6)


def test_the_innermost_range_holds_at_its_edges():
    ivs = [(0.0, 10.0, "outer"), (2.0, 4.0, "a"), (4.0, 6.0, "b"),
           (5.0, 5.5, "c")]
    assert spans.innermost(ivs, [3.0, 1.0, 4.0, 5.2, 5.5, 9.0, 10.0]) == [
        "a", "outer", "b", "c", "b", "outer", None]


def _trace_root(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cpu_trace_of_the_train_cell_links_each_layers_backward(
        tmp_path):
    root = _trace_root(tmp_path)
    cell = small_cells.train_cell(root)
    cell.traffic = dict(cell.traffic, trace_seconds=0.01)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = harness.run_cell(cell, 2**31 + 21, 0.01, True,
                               torch.device("cpu"), root=root)
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["checks"]
    # no device operation on the CPU: none of the six metrics reports
    assert not set(METRICS) & set(out["metrics"])
    path = root / harness.TRACE_FILE.format(workload=cell.name)
    with gzip.open(path, "rt") as f:
        links = spans.Threads(json.load(f)["traceEvents"]).links()
    linked = {}
    for (node, span), _ in links.items():
        linked.setdefault(node, set()).add(span)
    assert linked["SoftmaxBackward0"] == {"repro_torch.attention",
                                          "repro_torch.moe.route"}
    assert "repro_torch.moe.experts" in linked["BmmBackward0"]
    assert "repro_torch.head" in linked["_HeadFnBackward"]


def _ctx(traced, config="granite-moe-1b-loghd"):
    return harness.Context(traced=traced, config={"name": config},
                           traffic={}, card="cpu", power_limit_w=None,
                           counts={"steps": 1})


def _write(root, events, cell="granite-moe-1b-loghd.train-4k"):
    path = root / harness.TRACE_FILE.format(workload=cell)
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return trace.load(path)


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_is_none_without_device_operations(name):
    traced = trace.Traced(ops=[], spans=[(0.0, 1.0, spans.STEP)],
                          window=(0.0, 1.0))
    assert harness.load_metric(ROOT, name).read(_ctx(traced)) is None


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_reads_the_spans_and_is_none_without_them(name,
                                                              tmp_path):
    root = _trace_root(tmp_path)
    reader = harness.load_metric(root, name)
    want = {"attention_ms.train": 0.130, "moe_route_ms.train": 0.060,
            "moe_experts_ms.train": None, "head_ms.train": None,
            "optimizer_ms.train": 0.060,
            "dispatch_gap_ms.train": (120 + 40 + 30 + 315) * 1e-3}[name]
    got = reader.read(_ctx(_write(root, _step_events())))
    assert got == pytest.approx(want) if want is not None else got is None
    # a program without spans: the same step with none of its ranges
    bare = [e for e in _step_events()
            if not e["name"].startswith(spans.PREFIX)]
    assert reader.read(_ctx(_write(root, bare))) is None


def test_a_metric_reads_the_trace_of_its_own_window(tmp_path):
    root = _trace_root(tmp_path)
    reader = harness.load_metric(root, "attention_ms.train")
    own = _write(root, _step_events(), "granite-moe-1b-loghd.train-1k")
    # a newer trace of the other cell of the configuration, another
    # window and no span of the program
    other = [dict(e, dur=990) if e["name"] == trace.WINDOW else e
             for e in _step_events()
             if not e["name"].startswith(spans.PREFIX)]
    path = root / harness.TRACE_FILE.format(
        workload="granite-moe-1b-loghd.train-4k")
    _write(root, other)
    t = spans.traces(root)[-1].stat().st_mtime_ns
    os.utime(path, ns=(t + 10**9, t + 10**9))
    assert spans.traces(root)[0] == path
    assert reader.read(_ctx(own)) == pytest.approx(0.130)
    # no trace with the traced window: nothing to read
    lost = trace.Traced(ops=own.ops, spans=own.spans, window=(0.0, 5e-4))
    assert reader.read(_ctx(lost)) is None


def test_main_prints_the_table_of_the_newest_trace(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    assert spans.main([]) == 1
    path = tmp_path / harness.TRACE_FILE.format(
        workload="granite-moe-1b-loghd.train-4k")
    path.parent.mkdir(parents=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": _step_events()}, f)
    want = spans.reduce_events(_step_events()).table()
    for argv in ([], [str(path)]):
        capsys.readouterr()
        assert spans.main(argv) == 0
        out = capsys.readouterr()
        assert out.out == want + "\n" and out.err == ""
    assert "repro_torch.attention" in want and "whole step" in want

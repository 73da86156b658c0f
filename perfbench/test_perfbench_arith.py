"""The yardstick's arithmetic and imports: each metric's operations and
bytes at the cells' shapes against hand-worked values, the frozen peak
table, the reduction of a trace, and an import walk of every file."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.frozen import flops, peaks

ROOT = harness.ROOT
PKG = ROOT / "perfbench"
CLASSIFY = harness.resolve_cell(ROOT, "isolet-loghd.classify")
TRAIN = harness.resolve_cell(ROOT, "granite-moe-1b-loghd.train-4k")


def _metric(name):
    return harness.load_metric(ROOT, name)


def test_encode_counts_at_the_classify_shape():
    ops, n_bytes = _metric("encode_roofline.classify").ops_bytes(
        CLASSIFY.config, CLASSIFY.traffic)
    # 2 x 1,559 x 617 x 10,000; x, W, bias, centre read, h written
    assert ops == 2 * 1559 * 617 * 10_000 == pytest.approx(1.924e10, rel=1e-3)
    assert n_bytes == 4 * (1559 * 617 + 617 * 10_000 + 2 * 10_000
                           + 1559 * 10_000)
    assert n_bytes == pytest.approx(91.0e6, rel=1e-3)
    bound = peaks.bound_s("NVIDIA H100 80GB HBM3", ops, n_bytes, "tf32")
    assert bound == pytest.approx(38.87e-6, rel=1e-3)      # by operations


def test_decode_counts_at_the_classify_shape():
    ops, n_bytes = _metric("decode_roofline.classify").ops_bytes(
        CLASSIFY.config, CLASSIFY.traffic)
    assert ops == 2 * 1559 * 10_000 * 10 + 3 * 1559 * 26 * 10
    assert n_bytes == 4 * (1559 * 10_000 + 10 * 10_000 + 26 * 10) + 8 * 1559
    assert n_bytes == pytest.approx(62.77e6, rel=1e-3)
    bound = peaks.bound_s("NVIDIA H100 80GB HBM3", ops, n_bytes, "tf32")
    assert bound == pytest.approx(18.74e-6, rel=1e-3)      # by bytes


def test_classify_mfu_counts_encode_and_decode():
    assert _metric("classify_mfu").ops(CLASSIFY.config, CLASSIFY.traffic) \
        == 2 * 1559 * 617 * 10_000 + 2 * 1559 * 10_000 * 10 + 3 * 1559 * 26 * 10


def test_train_flops_at_the_train_4k_shape():
    # granite-moe-1b with the LogHD head: 24 layers of attention (3.15 M)
    # and 32 experts (50.36 M with the router), 8 of them active
    m = TRAIN.config["model"]
    shape = flops.model_shape(m)
    attn = 1024 * 16 * 64 * 2 + 1024 * 8 * 64 * 2
    moe = 1024 * 32 + 32 * 3 * 1024 * 512
    total = 49_155 * 1024 + 18 * 1024 + 49_155 * 18 + 24 * (attn + moe)
    assert flops.param_count(shape) == total
    active = total - 24 * 24 * 3 * 1024 * 512
    assert flops.active_param_count(shape) == active
    tokens = 8 * 4096
    matmul = 2.0 * (active - 49_155 * 1024) * tokens
    attn_f = 24 * 2.0 * 16 * 128 * 8 * 4096 * 4096 / 2
    want = 3 * (matmul + attn_f)
    got = _metric("train_mfu").step_flops(TRAIN.config, TRAIN.traffic)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(9.43e13, rel=2e-3)


def test_frozen_peaks_are_the_data_sheets():
    sxm = peaks.rates("NVIDIA H100 80GB HBM3")
    assert (sxm["bf16"], sxm["tf32"], sxm["float32"], sxm["bytes"]) == (
        989e12, 495e12, 67e12, 3.35e12)
    pcie = peaks.rates("NVIDIA H100 PCIe")
    assert (pcie["bf16"], pcie["tf32"], pcie["bytes"]) == (756e12, 378e12,
                                                           2.0e12)
    assert peaks.part("NVIDIA H100 PCIe") == "PCIe"


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_trace_reduction_takes_the_union_and_attributes_launches():
    events = [
        _ev("user_annotation", "perfbench.window", 0, 100),
        _ev("user_annotation", "perfbench.encode", 10, 5),
        _ev("user_annotation", "perfbench.predict_encoded", 16, 4),
        _ev("user_annotation", "perfbench.collect", 55, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 17, 1, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 18, 1, corr=3),
        _ev("kernel", "enc", 20, 30, corr=1),
        _ev("kernel", "dec", 40, 20, corr=2),     # overlaps enc by 10
        _ev("gpu_memcpy", "DtoH", 70, 5, corr=3),
        _ev("kernel", "lost", 80, 2, corr=9),
    ]
    t = trace.reduce_events(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((40 + 5 + 2) * 1e-6)
    assert t.device_s("perfbench.encode") == pytest.approx(30e-6)
    assert t.device_s("perfbench.predict_encoded") == pytest.approx(25e-6)
    assert t.span_count("perfbench.encode") == 1 and t.unattributed == 1
    gaps = dict(t.breakdown()["idle_gaps"])
    # idle 0-20, 75-80 and 82-100 with the host in the window alone, and
    # 60-70 with the host collecting
    assert gaps == {"perfbench.window": pytest.approx(43e-6),
                    "perfbench.collect": pytest.approx(10e-6)}
    idle = _metric("device_idle.classify").read(harness.Context(
        traced=t, config={}, traffic={}, card="x", power_limit_w=None,
        counts={}))
    assert idle == pytest.approx(53.0)


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_the_jax_package(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.relative_to(PKG).parts:
        assert "repro_torch" not in found


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.api", types.ModuleType("x"))
    assert "repro" in harness.forbidden_modules()


def test_benchmark_names_match_the_issue():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [m["name"] for m in bench["end_to_end"]] == [
        "classify_rows_s", "train_tokens_s", "setup_s"]
    assert [m["name"] for m in bench["per_layer"]] == [
        "encode_roofline.classify", "decode_roofline.classify",
        "classify_mfu", "device_idle.classify", "train_mfu",
        "launches_per_step.train", "device_idle.train"]


def test_main_prints_no_result_when_the_jax_package_was_loaded(
        monkeypatch, capsys):
    import sys
    import types

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(harness, "set_cache_dirs", lambda root: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.main(["--workload", "isolet-loghd.classify", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "jax" in out.err

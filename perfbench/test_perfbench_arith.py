"""The yardstick's arithmetic and imports: each metric's operations and
bytes at the cells' shapes against hand-worked values, the frozen peak
table, the reduction of a trace, and an import walk of every file."""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.frozen import flops, peaks

ROOT = harness.ROOT
PKG = ROOT / "perfbench"
CLASSIFY = harness.resolve_cell(ROOT, "isolet-loghd.classify")
TRAIN = harness.resolve_cell(ROOT, "granite-moe-1b-loghd.train-4k")
TRAIN_1K = harness.resolve_cell(ROOT, "granite-moe-1b-loghd.train-1k")


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


def test_train_flops_at_the_train_1k_shape():
    # the same model and 32,768 tokens a step as train-4k, at 32 x 1,024:
    # the matmul term is train-4k's, attention a quarter of it
    m = TRAIN_1K.config["model"]
    shape = flops.model_shape(m)
    active = flops.active_param_count(shape)
    tokens = 32 * 1024
    matmul = 2.0 * (active - 49_155 * 1024) * tokens
    attn_f = 24 * 2.0 * 16 * 128 * 32 * 1024 * 1024 / 2
    want = 3 * (matmul + attn_f)
    got = _metric("train_mfu").step_flops(TRAIN_1K.config, TRAIN_1K.traffic)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(7.95e13, rel=2e-3)


@pytest.mark.parametrize("arch,smoke", [("deepseek-v3-671b", False),
                                        ("deepseek-v3-671b", True),
                                        ("granite-moe-1b-a400m", False)])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_frozen_flops_equal_the_programs_roofline(arch, smoke, shape):
    from repro_torch.configs import SHAPES, get_config, get_smoke_config
    from repro_torch.launch import roofline
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    spec = SHAPES[shape]
    m = flops.model_shape(dataclasses.asdict(cfg))
    assert flops.param_count(m) == cfg.param_count()
    assert flops.active_param_count(m) == cfg.active_param_count()
    got = flops.analytic_flops(m, spec.seq_len, spec.global_batch, spec.kind)
    want = roofline.analytic_flops(cfg, spec)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def _deepseek_cut(**kw) -> dict:
    """DeepSeek-V3 at the widths published, cut to one dense and four MoE
    layers with the LogHD head."""
    from repro_torch.configs import get_config
    m = dataclasses.asdict(get_config("deepseek-v3-671b"))
    return dict(m, n_prefix=1, n_periods=4, head="loghd", **kw)


@pytest.mark.parametrize("kind,seq,batch", [("train", 4096, 8),
                                            ("prefill", 4096, 8),
                                            ("decode", 4096, 64)])
def test_held_experts_count_their_share_of_the_routing(kind, seq, batch):
    held = _deepseek_cut(n_experts=8, n_routed_experts=256)
    whole = _deepseek_cut(n_experts=256)

    def total(m, **kw):
        return flops.analytic_flops(flops.model_shape(dict(m, **kw)), seq,
                                    batch, kind)["total"]

    # routed experts: a token's 8 choices land on this chip's 8 of 256
    # experts 8 x 8 / 256 times on average
    routed_held = total(held) - total(held, moe_d_ff=0)
    routed_whole = total(whole) - total(whole, moe_d_ff=0)
    assert routed_held == pytest.approx(routed_whole * 8 / 256, rel=1e-12)
    # attention, the shared expert, the dense layer and the router alike
    assert total(held, moe_d_ff=0) == total(whole, moe_d_ff=0)
    # without the key, the experts held are the experts routed over
    assert total(dict(whole, n_routed_experts=256)) == total(whole)
    d, f = 7168, 2048
    assert flops.param_count(flops.model_shape(whole)) \
        - flops.param_count(flops.model_shape(held)) == 4 * 248 * 3 * d * f
    if kind == "train":
        cut = flops.model_shape(held)
        assert flops.param_count(cut) == pytest.approx(3.854e9, rel=1e-3)
        assert flops.active_param_count(cut) - 129_280 * d \
            == pytest.approx(1.562e9, rel=1e-3)


def test_frozen_flops_refuse_the_recurrent_mixers():
    m = dict(TRAIN.config["model"], pattern=[{"mixer": "mamba",
                                              "ffn": "moe"}])
    with pytest.raises(ValueError, match="mamba"):
        flops.analytic_flops(flops.model_shape(m), 4096, 8, "train")


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


# The accepted names: every end-to-end and per-layer metric the benchmark
# has held.  Entries may be added; none of these may go or be renamed.
END_TO_END = ("classify_rows_s", "train_tokens_s", "setup_s")
PER_LAYER = ("encode_roofline.classify", "decode_roofline.classify",
             "classify_mfu", "device_idle.classify", "train_mfu",
             "launches_per_step.train", "device_idle.train",
             "attention_ms.train", "moe_route_ms.train",
             "moe_experts_ms.train", "head_ms.train", "optimizer_ms.train")


def names_lost(root: Path) -> list:
    """What ``root``'s ``BENCHMARK.json`` does wrong by the accepted
    names: each one not there exactly once, and each per-layer entry
    without its reader ``perfbench/metrics/<name>.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    lost = []
    for key, accepted in (("end_to_end", END_TO_END),
                          ("per_layer", PER_LAYER)):
        names = [m["name"] for m in bench[key]]
        lost += [f"{key} {n!r} appears {names.count(n)} times"
                 for n in accepted if names.count(n) != 1]
    lost += [f"per_layer {m['name']!r} has no reader"
             for m in bench["per_layer"]
             if not (root / "perfbench" / "metrics"
                     / f"{m['name']}.py").is_file()]
    return lost


def test_benchmark_names_match_the_issue():
    assert names_lost(ROOT) == []


def _drop(key, name):
    def edit(bench, metrics):
        bench[key] = [m for m in bench[key] if m["name"] != name]
    return edit


def _rename(key, name):
    def edit(bench, metrics):
        for m in bench[key]:
            if m["name"] == name:
                m["name"] = name + "_v2"
                (metrics / f"{m['name']}.py").write_text(
                    "def read(ctx):\n    return None\n")
    return edit


def _add(reader: bool, key="per_layer"):
    def edit(bench, metrics):
        bench[key].append({"name": "expert_tokens.train", "unit": "tokens",
                           "better": "higher", "source": "program_counter",
                           "layer": "MoE experts", "moves": "train_tokens_s",
                           "workloads": ["granite-moe-1b-loghd.train-4k"]})
        if reader:
            (metrics / "expert_tokens.train.py").write_text(
                "def read(ctx):\n    return None\n")
    return edit


def _twice(key, name):
    def edit(bench, metrics):
        bench[key] += [m for m in bench[key] if m["name"] == name]
    return edit


@pytest.mark.parametrize("edit,kept", [
    (lambda bench, metrics: None, True),
    (_add(reader=True), True),
    (_add(reader=False), False),
    (_drop("per_layer", "train_mfu"), False),
    (_drop("per_layer", "optimizer_ms.train"), False),
    (_rename("per_layer", "attention_ms.train"), False),
    (_drop("end_to_end", "setup_s"), False),
    (_rename("end_to_end", "train_tokens_s"), False),
    (_twice("per_layer", "head_ms.train"), False),
], ids=["as_is", "added_with_reader", "added_without_reader",
        "removed_train_mfu", "removed_span_metric", "renamed_span_metric",
        "removed_setup_s", "renamed_train_tokens_s", "duplicated"])
def test_the_name_guard_fails_a_loss_and_passes_an_addition(tmp_path, edit,
                                                           kept):
    shutil.copytree(ROOT / "perfbench" / "metrics",
                    tmp_path / "perfbench" / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    edit(bench, tmp_path / "perfbench" / "metrics")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert (names_lost(tmp_path) == []) == kept, names_lost(tmp_path)


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

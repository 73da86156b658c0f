"""The DeepSeek-V3 cell (``deepseek-v3-ep32-loghd.mla-train-4k``) cut to CPU
sizes, from its own files: a sound whole run is correct, the planted
faults are caught, a program without the configuration fails before any
weight is drawn, the routing counters reach the window's counts and the
four new readers read numbers, and the frozen FLOPs at the cell's shape
equal a count made by hand."""

from __future__ import annotations

import gzip
import json
import shutil
import time
from unittest import mock

import pytest
import torch

from perfbench import harness, trace
from perfbench.drivers import lm_train_mla
from perfbench.frozen import flops

ROOT = harness.ROOT
CPU = torch.device("cpu")
SEED = 2**31 + 13
CELL = "deepseek-v3-ep32-loghd.mla-train-4k"
NEW_METRICS = ("mla_latent_ms.train", "moe_shared_ms.train", "mlp_ms.train",
               "moe_drop_pct.train")
# the program's smoke config of deepseek-v3-ep32, trained with remat
SMALL = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=4, head_dim=48,
             d_ff=128, n_prefix=1, n_periods=2, n_experts=4,
             n_routed_experts=16, top_k=4, n_group=4, topk_group=2,
             moe_d_ff=32, shared_expert_ff=32, mla_q_lora=32, mla_kv_lora=16,
             mla_nope_dim=32, mla_rope_dim=16, mla_v_dim=32, dtype="float32",
             loss_chunk=64)


def mla_cell(root=ROOT) -> harness.Cell:
    cell = harness.resolve_cell(root, CELL)
    cell.config = dict(cell.config, model=dict(cell.config["model"], **SMALL),
                       program_smoke=True,
                       program_overrides={"loss_chunk": 64,
                                          "remat_policy": "full"})
    cell.traffic = dict(cell.traffic, batch=2, seq_len=128)
    return cell


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.2, False, CPU, **kw)


def test_sound_mla_run_is_correct(one_thread):
    out = _run(mla_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "step_gap",
                                  "bias_gap"}
    assert set(out["metrics"]) == {"train_tokens_s", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged_is_caught(one_thread):
    import repro_torch.runtime.train_loop as tl
    with mock.patch.object(tl, "adamw_update", lambda *a, **k: None):
        out = _run(mla_cell())
    assert not out["correct"]
    assert out["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(one_thread):
    import repro_torch.runtime.train_loop as tl
    full = tl.loss_fn

    def half(params, cfg, tokens, targets, mesh=None, **kw):
        b = tokens.shape[0] // 2
        return full(params, cfg, tokens[:b], targets[:b], mesh, **kw)
    with mock.patch.object(tl, "loss_fn", half):
        out = _run(mla_cell())
    assert not out["correct"], out["checks"]
    assert out["checks"]["bias_gap"]["value"] > \
        out["checks"]["bias_gap"]["limit"]


def test_a_program_without_the_configuration_fails_before_any_draw():
    cell = harness.resolve_cell(ROOT, CELL)
    cell.config = dict(cell.config, program_config="no-such-config")
    t0 = time.perf_counter()
    with mock.patch.object(lm_train_mla, "make_weights",
                           side_effect=AssertionError("a weight drawn")), \
            pytest.raises(KeyError, match="no-such-config"):
        _run(cell)
    assert time.perf_counter() - t0 < 5


def test_a_configuration_the_program_does_not_equal_is_refused():
    cell = mla_cell()
    cell.config["model"] = dict(cell.config["model"], n_group=2)
    with pytest.raises(ValueError, match="n_group"):
        lm_train_mla.Port(cell.config, CPU)


def _as_device_trace(path):
    """The CPU trace at `path` with each host operation given a launch and
    a 1 us kernel of its own, as a card's trace would have."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    extra = []
    for i, ev in enumerate(e for e in events if e.get("cat") == "cpu_op"):
        corr = 10**6 + i
        extra += [dict(ev, cat="cuda_runtime", name="cudaLaunchKernel",
                       dur=0, args={"correlation": corr}),
                  {"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": ev["ts"], "dur": 1, "tid": 0, "pid": 0,
                   "args": {"correlation": corr}}]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events + extra}, f)
    return trace.load(path)


def test_counters_reach_counts_and_the_new_readers_read_a_trace(
        tmp_path, one_thread):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = mla_cell(tmp_path)
    cell.traffic = dict(cell.traffic, trace_seconds=0.01)
    seen = {}
    window = lm_train_mla.Train.window

    def spy(self, seconds, span):
        stats = window(self, seconds, span)
        seen.update(stats["counts"])
        return stats
    with mock.patch.object(lm_train_mla.Train, "window", spy):
        out = harness.run_cell(cell, SEED, 0.01, True, CPU, root=tmp_path)
    assert out["correct"], out["checks"]
    steps, m = seen["steps"], cell.config["model"]
    loads = seen["expert_loads"]
    assert len(loads) == m["n_periods"]
    assert all(len(row) == m["n_routed_experts"] for row in loads)
    # every token's k choices counted once a step, in the forward alone
    assert all(sum(row) == steps * 2 * 128 * m["top_k"] for row in loads)
    held = sum(sum(row[:m["n_experts"]]) for row in loads)
    assert seen["held_choices"] == held > 0
    assert 0 <= seen["dropped_choices"] <= held
    drop = out["metrics"]["moe_drop_pct.train"]["value"]
    assert drop == pytest.approx(100 * seen["dropped_choices"] / held)
    # no device operation on the CPU: the span readers are silent there,
    # and read the same trace once its host operations have kernels
    assert not {"mla_latent_ms.train", "moe_shared_ms.train",
                "mlp_ms.train"} & set(out["metrics"])
    path = tmp_path / harness.TRACE_FILE.format(workload=CELL)
    ctx = harness.Context(traced=_as_device_trace(path), config=cell.config,
                          traffic=cell.traffic, card="cpu",
                          power_limit_w=None, counts=seen)
    for name in NEW_METRICS:
        got = harness.load_metric(tmp_path, name).read(ctx)
        assert got is not None and got > 0, name
    for name in ("attention_ms.train", "moe_route_ms.train",
                 "moe_experts_ms.train", "head_ms.train"):
        assert harness.load_metric(tmp_path, name).read(ctx) > 0, name


def test_the_frozen_flops_at_the_cells_shape_equal_a_hand_count():
    cell = harness.resolve_cell(ROOT, CELL)
    m = flops.model_shape(cell.config["model"])
    d, v, n = 7168, 129_280, 19
    head = n * d + v * n
    mla = (d * 1536 + 1536 * 128 * (128 + 64) + d * (512 + 64)
           + 512 * 128 * (128 + 128) + 128 * 128 * d)
    dense = 3 * d * 18_432
    # router over 256; a token's 8 choices land on 8 of 256 held experts
    # a quarter of an expert's worth; the shared expert on every token
    moe = d * 256 + 8 * 8 / 256 * 3 * d * 2048 + 3 * d * 2048
    active = head + 5 * mla + dense + 4 * moe
    assert active == 1_562_021_632
    tokens = 4 * 4096
    attn = 5 * 2 * 128 * (192 + 128) * 4 * 4096 * 4096 / 2
    want = 3 * (2 * active * tokens + attn)
    got = flops.analytic_flops(m, 4096, 4, "train")
    assert got["total"] == pytest.approx(want, rel=1e-12)
    assert got["total"] == pytest.approx(1.948e14, rel=1e-3)
    assert flops.param_count(m) == pytest.approx(3.854e9, rel=1e-3)

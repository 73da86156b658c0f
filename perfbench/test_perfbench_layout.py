"""The benchmark's files: every cell resolves by name, the contract's
limits on ``BENCHMARK.json``, the run without a card or without the
program, the frozen generators against the program's, and a new mix and
metric added as files alone."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.frozen import synth, tokens

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expansion", "experts_per_tok", "d_model", "d_ff")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve_cell(ROOT, name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (ROOT / "perfbench" / "configs" / f"{w['config']}.json").is_file()
    assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert Path(cell.driver.__file__).name == f"{cell.traffic['driver']}.py"
    assert hasattr(cell.driver, "build") and hasattr(cell.driver, "CONTROL")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = harness.load_metric(ROOT, m["name"])
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_benchmark_json_keeps_the_contracts_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and set(m["workloads"]) <= set(CELLS)
        assert ("roofline" not in m["name"] and "mfu" not in m["name"]
                ) or m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _run(cwd: Path, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = _run(ROOT, "--workload", CELLS[0], "--seed", str(2**31 + 7),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", CELLS[0], "--seed", "3", "--seconds",
               "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name,seed", [("isolet", None), ("isolet", 2**31 + 5),
                                       ("page", 17)])
def test_frozen_surrogate_is_byte_identical_to_the_programs(name, seed):
    from repro_torch.data import synth as program
    kw = {"seed": seed, "max_train": 700}
    got, want = synth.load_dataset(name, **kw), program.load_dataset(name, **kw)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x_tr, y_tr, x_pool, y_pool, _ = synth.load_pool(name, 3, **kw)
    assert x_tr.tobytes() == want[0].tobytes()
    assert x_pool[0].tobytes() == want[2].tobytes()
    assert y_pool[0].tobytes() == want[3].tobytes()
    assert not np.array_equal(x_pool[1], x_pool[2])


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_frozen_tokens_are_byte_identical_to_the_programs(seed):
    from repro_torch.data.tokens import TokenPipeline
    kw = dict(vocab=49_155, seq_len=64, global_batch=3, seed=seed)
    got = tokens.TokenPipeline(**kw, device="cpu")
    want = TokenPipeline(**kw, device="cpu")
    for step in (0, 1, 57):
        a, b = got.batch(step), want.batch(step)
        for k in ("tokens", "targets"):
            assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    assert not torch.equal(got.batch(0)["tokens"], got.batch(1)["tokens"])


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in [root / "BENCHMARK.json",
                      *sorted((root / "perfbench").rglob("*"))]
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_mix_and_metric_are_new_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    mix = json.loads((ROOT / "perfbench/traffic/classify.json").read_text())
    (tmp_path / "perfbench/traffic/classify-64.json").write_text(
        json.dumps(dict(mix, batch_rows=64)))
    (tmp_path / "perfbench/metrics/rows_per_call.classify-64.py").write_text(
        "def read(ctx):\n    return ctx.traffic['batch_rows']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "isolet-loghd.classify-64",
                               "config": "isolet-loghd",
                               "traffic": "classify-64", "chips": 1,
                               "why": "64-row batches"})
    bench["per_layer"].append({"name": "rows_per_call.classify-64",
                               "unit": "rows", "better": "higher",
                               "source": "program_counter",
                               "layer": "device", "moves": "classify_rows_s",
                               "workloads": ["isolet-loghd.classify-64"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "isolet-loghd.classify" in m["workloads"]:
            m["workloads"].append("isolet-loghd.classify-64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {Path("BENCHMARK.json")}
    cell = harness.resolve_cell(tmp_path, "isolet-loghd.classify-64")
    assert cell.traffic["batch_rows"] == 64
    assert cell.driver.__name__ == "perfbench.drivers.classify"
    assert [m["name"] for m in cell.per_layer] == ["rows_per_call.classify-64"]
    reader = harness.load_metric(tmp_path, "rows_per_call.classify-64")
    ctx = harness.Context(traced=None, config=cell.config,
                          traffic=cell.traffic, card="cpu",
                          power_limit_w=None, counts={})
    assert reader.read(ctx) == 64

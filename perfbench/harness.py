"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

A cell ``<config>.<mix>`` is found by name: ``perfbench/configs/<config>.json``
(the sizes, the family and the limits of its check),
``perfbench/traffic/<mix>.json`` (the mix's parameters, naming its driver
``perfbench/drivers/<driver>.py``) and, for each per-layer metric that
``BENCHMARK.json`` lists for the cell, ``perfbench/metrics/<metric>.py``.
Adding a cell, a mix on an existing driver or a metric adds files and
entries and edits none.

A run: check the card, let the driver set up (make the inputs from the
seed, build the program's state, warm up every shape the mix uses), which
is ``setup_s``; measure for ``--seconds`` (``--trace 1``: the mix's
``trace_seconds`` under the profiler); read the peak memory; reduce the
trace; free the program's state and let the driver compare what the timed
path produced with the plain reference; refuse to report if the JAX
package or its libraries were loaded; print each compared number beside its limit on
standard error and, as the last line of standard output, the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_FILE = "build/perfbench/{workload}.trace.json.gz"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: list
    per_layer: list


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def for_cell(metrics: list, cell: str) -> list:
    """The metrics of `metrics` that cell `cell` reports."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def resolve_cell(root: Path, name: str) -> Cell:
    """Cell `name` of ``root/BENCHMARK.json`` with its files loaded."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                driver=driver, end_to_end=for_cell(bench["end_to_end"], name),
                per_layer=for_cell(bench["per_layer"], name))


def load_metric(root: Path, name: str):
    """The reader module ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is the JAX
    package's or one of its libraries'."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the run in fixed directories of the
    checkout (the port builds its kernels into ``build/repro_torch``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


def power_limit_w() -> float | None:
    """The card's power limit by ``nvidia-smi`` (None where it cannot be
    read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def span(name: str):
    """A harness range around a call into the program, seen in a trace."""
    import torch
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's ``read`` gets: the traced window, the
    cell's files, the card's name and power limit, and the driver's
    counts of the traced window."""
    traced: object
    config: dict
    traffic: dict
    card: str
    power_limit_w: float | None
    counts: dict


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             *, system=None, t_start: float | None = None,
             root: Path = ROOT) -> dict:
    """Set up, measure, check: the result dict of one run of `cell` on
    `device` (the test suite passes a CPU device and a small cell)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.type == "cuda"
    driver = cell.driver.build(cell.config, cell.traffic, seed, device,
                               system)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    traced = None
    if trace:
        from perfbench import trace as trace_mod
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            stats = driver.window(cell.traffic["trace_seconds"], span)
        path = root / TRACE_FILE.format(workload=cell.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        traced = trace_mod.load(path)
    else:
        stats = driver.window(seconds, span)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    card = torch.cuda.get_device_name(device) if on_card else "cpu"

    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": card,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        ctx = Context(traced=traced, config=cell.config, traffic=cell.traffic,
                      card=card, power_limit_w=power_limit_w() if on_card
                      else None, counts=stats.get("counts", {}))
        for m in cell.per_layer:
            reader = load_metric(root, m["name"])
            value = reader.read(ctx)
            if value is None:
                continue
            entry = {"value": float(value), "unit": m["unit"]}
            peak_of = getattr(reader, "PEAK", None)
            if peak_of:
                entry["peak"] = peak_of
                entry["power_limit_w"] = ctx.power_limit_w
            metrics[m["name"]] = entry
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        breakdown = traced.breakdown()
        print(f"perfbench: trace {path}: {len(traced.ops)} device ops, "
              f"{traced.unattributed} without a launch", file=sys.stderr)
    else:
        values = driver.end_to_end(stats)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    driver.release()
    checks = driver.check()
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and stats["failed"] == 0
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(stats["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    args = parse_args(argv)
    set_cache_dirs(ROOT)
    cell = resolve_cell(ROOT, args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        print("perfbench: the program (repro_torch, under src/) is not in "
              "this checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the JAX package or its libraries were loaded in "
              f"the run: {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"perfbench check {name}: {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0

#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of LogHD on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, then runs
the main path through the public entry points at the paper's full width:
the isolet surrogate (F=617, C=26, 6,238 train / 1,559 test rows),
``make_classifier("loghd", ..., dim=10000, k=2, extra_bundles=5,
refine_epochs=0)`` -> fit -> predict -> the 1-bit and 4-bit bit-flip sweeps.
It checks the launch counts of that run, that the fit repeats bit for bit,
that kernel and plain predict agree, and that the sweep's p=0 row equals the
clean accuracy of the quantized model; then it times every kernel, its plain
version and a library call with CUDA events.

Output: a JSON line with one entry per kernel, the card's name and power
limit as ``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0; without a CUDA device, or outside a checkout, it exits with
an error before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Tolerances of the JAX package's own kernel tests (tests/test_kernels.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
P_GRID = [0.0, 0.05, 0.1, 0.2, 0.3, 0.4]
N_TRIALS = 3
KERNELS = {
    "bundle_sim": ("src/repro_torch/kernels/csrc/bundle_sim.cu",
                   "src/repro/kernels/bundle_sim/bundle_sim.py:61"),
    "profile_decode": ("src/repro_torch/kernels/csrc/profile_decode.cu",
                       "src/repro/kernels/profile_decode/profile_decode.py:50"),
    "flip_corrupt": ("src/repro_torch/kernels/csrc/flip_corrupt.cu",
                     "src/repro/kernels/flip_corrupt/flip_corrupt.py:116"),
}


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> dict:
    """Published peaks (NVIDIA data sheets) used for the bounds: memory
    bytes/s, float32 flop/s outside the tensor cores, and int32 op/s (half
    the float32 rate: Hopper has 64 INT32 and 128 FP32 lanes per SM)."""
    if "PCIe" in name:
        mem, f32 = 2.0e12, 51e12
    else:
        mem, f32 = 3.35e12, 67e12
    return {"bytes": mem, "float32": f32, "int32": f32 / 2}


def bound_ms(rates: dict, n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / rates["bytes"] * 1e3
    t_ops = n_ops / rates[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 25, inner: int = 10) -> float:
    """Median over `reps` runs of the CUDA-event time per call, each run
    timing `inner` back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 20):
    """Device time per call: the time of every kernel and copy that `calls`
    calls ran on the card, from torch.profiler, over `calls`; None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    # device-side events only: a CPU op's device time repeats its kernels'
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / calls / 1e3 if total else None


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    abs error at the main path's shape."""
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels.bundle_sim import (bundle_similarity,
                                                bundle_similarity_ref)
    from repro_torch.kernels.flip_corrupt import (flip_corrupt,
                                                  flip_corrupt_ref)
    from repro_torch.kernels.profile_decode import (profile_decode_scores,
                                                    profile_decode_scores_ref)
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for (b, d, n) in [(1559, 10000, 10), (37, 1000, 3), (64, 1000, 40),
                      (37, 617, 5)]:
        for dtype in (torch.float32, torch.bfloat16):
            h = torch.randn((b, d), generator=g, device=dev).to(dtype)
            m = l2_normalize(torch.randn((n, d), generator=g, device=dev))
            got = bundle_similarity(h, m)
            want = bundle_similarity_ref(h, m)
            torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            err = max_err(got, want)
            log(f"bundle_sim     ({b}, {d}, {n}) {dtype}: max_abs_err {err:.3e}")
            check(got.shape == (b, n) and got.dtype == torch.float32,
                  "bundle_sim output shape / dtype")
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if (b, d, n) == (1559, 10000, 10) and dtype == torch.float32:
                errs["bundle_sim"] = err
    for (b, n, c) in [(1559, 10, 26), (37, 7, 45), (100, 40, 70)]:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((b, n), generator=g, device=dev).to(dtype)
            p = torch.randn((c, n), generator=g, device=dev).to(dtype)
            got = profile_decode_scores(a, p)
            want = profile_decode_scores_ref(a, p)
            torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            err = max_err(got, want)
            log(f"profile_decode ({b}, {n}, {c}) {dtype}: max_abs_err {err:.3e}")
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if (b, n, c) == (1559, 10, 26) and dtype == torch.float32:
                errs["profile_decode"] = err
    worst = 0.0
    for shape in [(10, 10000), (26, 10)]:
        for bits in (1, 4, 8):
            lo, hi = (0, 2) if bits == 1 else (-(1 << (bits - 1)),
                                               1 << (bits - 1))
            codes = torch.randint(lo, hi, shape, generator=g, device=dev,
                                  dtype=torch.int64).to(torch.int8)
            scale = torch.tensor(0.0123, device=dev)
            for p in (0.0, 0.1, 1.0):
                for seed in (42, (1 << 31) - 1):
                    got = flip_corrupt(codes, scale, bits, p, seed)
                    want = flip_corrupt_ref(codes, scale, p, seed, bits=bits)
                    torch.cuda.synchronize()
                    check(torch.equal(got.view(torch.int32),
                                      want.view(torch.int32)),
                          f"flip_corrupt not bit-exact at {shape} bits={bits} "
                          f"p={p} seed={seed}")
                    worst = max(worst, max_err(got, want))
    log(f"flip_corrupt: bit-exact over 2 shapes x bits {{1,4,8}} x "
        f"p {{0,0.1,1}} x 2 seeds")
    errs["flip_corrupt"] = worst
    return errs


def phase_main_path(torch, dev) -> dict:
    """isolet LogHD fit -> predict -> 1-bit and 4-bit sweeps, through the
    public entry points on the card, with launch counting."""
    from repro_torch.api import dispatch, make_classifier
    from repro_torch.data.synth import load_dataset
    from repro_torch.kernels import common

    x_tr, y_tr, x_te, y_te, spec = load_dataset("isolet")
    log(f"dataset {spec.name}: F={spec.n_features} C={spec.n_classes} "
        f"train={len(x_tr)} test={len(x_te)}")
    kw = dict(dim=10_000, k=2, extra_bundles=5, refine_epochs=0,
              codebook_method="distance")
    y_dev = torch.as_tensor(y_te, device=dev)

    common.reset_launches()
    t0 = time.perf_counter()
    clf = make_classifier("loghd", spec.n_classes, spec.n_features, **kw)
    clf = clf.fit(x_tr, y_tr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    labels = clf.predict(x_te)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    acc = float((labels == y_dev).float().mean())
    model = clf.model
    h_te = clf.encode(x_te)

    sweeps, sweep_s = {}, 0.0
    for bits in (1, 4):
        before = common.launches["flip_corrupt"]
        t0 = time.perf_counter()
        accs = clf.sweep_under_flips(
            bits, P_GRID, h_te, y_te, n_trials=N_TRIALS, scope="all",
            predict_encoded=dispatch.predict_encoded,
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        sweep_s += time.perf_counter() - t0
        sweeps[bits] = (accs, common.launches["flip_corrupt"] - before)
    launches = dict(common.launches)
    log(f"main path launches: {launches}")

    # checks, after the counts were read
    check(labels.shape == (len(x_te),), "predict shape")
    check(0.0 <= acc <= 1.0 and acc > 0.5,
          f"clean accuracy {acc} is below 0.5")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} never launched on the path")
    plain = dispatch.predict_encoded(model, h_te, use_kernels=False)
    agree = float((plain == labels).float().mean())
    log(f"clean accuracy {acc:.4f}; kernel vs plain labels agree on "
        f"{agree:.5f} of {len(x_te)} rows")
    check(agree >= 0.999, f"kernel and plain labels agree on only {agree}")

    clf2 = make_classifier("loghd", spec.n_classes, spec.n_features, **kw)
    model2 = clf2.fit(x_tr, y_tr).model
    for leaf in ("bundles", "profiles"):
        check(torch.equal(getattr(model, leaf), getattr(model2, leaf)),
              f"second fit differs in {leaf}")
    log(f"second fit: bundles and profiles bitwise equal; sigma_inv equal: "
        f"{torch.equal(model.sigma_inv, model2.sigma_inv)}")

    for bits, (accs, n_flip) in sweeps.items():
        check(accs.shape == (len(P_GRID), N_TRIALS), "sweep shape")
        q = model.quantized(bits)
        qacc = (dispatch.predict_encoded(q, h_te) == y_dev).float().mean()
        qacc = float(qacc.cpu().numpy())
        log(f"sweep bits={bits} (rows p, columns trials; "
            f"clean quantized accuracy {qacc:.4f}):")
        for p, row in zip(P_GRID, accs):
            log(f"  p={p:<5} " + " ".join(f"{a:.4f}" for a in row))
        check(all(a == qacc for a in accs[0]),
              f"bits={bits}: p=0 row {accs[0]} != clean quantized {qacc}")
        want = len(P_GRID) * N_TRIALS * 2
        check(n_flip == want,
              f"bits={bits}: flip_corrupt launched {n_flip} times, not {want}")
    log(f"wall: fit {fit_s:.3f} s, predict {predict_s:.3f} s "
        f"(encode + kernels), sweeps {sweep_s:.3f} s")
    return {"launches": launches, "model": model, "h_te": h_te,
            "acc": acc, "fit_s": fit_s, "predict_s": predict_s,
            "sweep_s": sweep_s}


def phase_times(torch, main: dict, rates: dict) -> dict:
    """Kernel, plain and library times at the main path's shapes."""
    import torch.nn.functional as F
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels.bundle_sim import (bundle_similarity,
                                                bundle_similarity_ref)
    from repro_torch.kernels.flip_corrupt import (flip_corrupt,
                                                  flip_corrupt_ref)
    from repro_torch.kernels.profile_decode import (profile_decode_scores,
                                                    profile_decode_scores_ref)
    model, h = main["model"], main["h_te"].contiguous()
    m = l2_normalize(model.bundles).contiguous()
    acts = bundle_similarity(h, m)
    prof = model.profiles.contiguous()
    q = model.quantized(4).bundles
    b, d = h.shape
    n, c = m.shape[0], prof.shape[0]
    nq = q.codes.numel()
    bits = q.bits

    cases = {
        "bundle_sim": dict(
            kernel=lambda: bundle_similarity(h, m),
            plain=lambda: bundle_similarity_ref(h, m),
            library=lambda: F.normalize(h, dim=-1) @ m.T,
            bytes=b * d * 4 + n * d * 4 + b * n * 4,
            ops=2 * b * d * n + 2 * b * d, op_type="float32"),
        "profile_decode": dict(
            kernel=lambda: profile_decode_scores(acts, prof),
            plain=lambda: profile_decode_scores_ref(acts, prof),
            library=lambda: torch.addmm(
                -(acts * acts).sum(1, keepdim=True) - (prof * prof).sum(1),
                acts, prof.T, alpha=2.0),
            bytes=(b * n + c * n) * 4 + b * c * 4,
            ops=2 * b * c * n + 2 * (b + c) * n + 2 * b * c,
            op_type="float32"),
        "flip_corrupt": dict(
            kernel=lambda: flip_corrupt(q.codes, q.scale, bits, 0.1, 7),
            plain=lambda: flip_corrupt_ref(q.codes, q.scale, 0.1, 7,
                                           bits=bits),
            library=None,
            bytes=nq * 1 + nq * 4 + 4, ops=nq * (24 * bits + 8),
            op_type="int32"),
    }
    out = {}
    for name, cs in cases.items():
        t = {}
        for role in ("kernel", "plain", "library"):
            fn = cs[role]
            t[role] = (time_ms(torch, fn), device_ms(torch, fn)) if fn else (
                None, None)
        b_ms, b_by = bound_ms(rates, cs["bytes"], cs["ops"], cs["op_type"])
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         device_ms=t["kernel"][1],
                         plain_device_ms=t["plain"][1],
                         library_device_ms=t["library"][1],
                         bound_ms=b_ms, bound_by=b_by)
        log(f"time {name:<15} bound {b_ms:.5f} ms by {b_by} "
            f"({cs['bytes']} B, {cs['ops']} ops); per call, CUDA events | "
            f"profiler device time: " + "; ".join(
                f"{role} {t[role][0]} | {t[role][1]} ms" for role in t))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, capability "
        f"{torch.cuda.get_device_capability(0)}")
    build_s = _build.build_all()
    log(f"kernel build: {build_s:.2f} s for {_build.kernel_names()}")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    rates = card_rates(kind)

    errs = phase_kernels(torch, dev)
    main_run = phase_main_path(torch, dev)
    times = phase_times(torch, main_run, rates)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_run["launches"].get(name, 0),
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

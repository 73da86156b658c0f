#!/usr/bin/env python3
"""Time the kernels of other checkouts beside this checkout's, on one
NVIDIA Hopper card, in one call.

Run from the root of a checkout, with one card visible:

    mkdir -p build/ab_parent
    git archive PARENT_COMMIT | tar -x -C build/ab_parent
    python3 chip_kernel_ab.py [--only flip_corrupt] build/ab_parent \
        [OTHER_CHECKOUT ...]

Each argument is the root of another checkout of this repo.  Every
checkout runs in a process of its own, which builds that checkout's
kernels and times them through its public wrappers,
``bundle_similarity(h, m)``, ``hdc_encode(x, proj, bias, center, kind)``,
``bundle_update(m, c, h, lr)``, ``profile_decode_scores(acts, profiles)``
and ``loghd_head_logits(h, m, p)``, with this checkout's ``chip_smoke.py``
inputs, cases, bounds and timers (its ``shape_row``: device time per call
from ``torch.profiler`` after warm-up, beside the plain version, the
library call, for ``bundle_sim`` also ``(h @ m.T) * rsqrt(||h||^2 +
1e-12)``, for ``hdc_encode`` also cuBLAS's ``x @ W``).  ``profile_decode``
and ``loghd_head`` rows add ``span_ms``, a call's span in a CUDA graph
(``chip_smoke.graph_span_ms``: a kernel pair chained by programmatic
dependent launch counts once); a ``pair`` row gives the span of
``bundle_sim`` followed by ``profile_decode`` at chip_smoke's chain shapes
(the chained launch where the checkout has one, and with it off), beside
each kernel's span alone.  The processes run the other checkouts, this one
twice, then the other checkouts in reverse, so drift on the card shows as
the gap between a checkout's two runs.  Each row also gives
``host_enqueue_us``, the host time a call of the wrapper takes to return
when calls run back to back (the launch path's cost in a host-bound loop).
Shapes: ``bundle_sim`` at ``chip_smoke.BS_TIME_SHAPES``, ``hdc_encode`` at
``chip_smoke.ENC_TIME_ROWS`` rows of isolet width (F = 617, D = 10,000),
``bundle_update`` at each matched-memory family's minibatch (n, B, D),
``profile_decode`` at ``chip_smoke.PD_SHAPES`` (float32) and
``loghd_head`` at B = 4 and 512 of qwen3-1.7b's head (D = 2,048, n = 20,
V = 151,936; bf16 h and M, bf16 and float32 P), ``flip_corrupt`` at one
point of (10, 10,000) 4-bit codes and at the sweeps' chunks (``FC_CHUNKS``,
18 points each: the batched ``flip_corrupt_grid`` launch, or in a
checkout without it the chunk's 36 or 18 one-point launches, as device
time summed over the launches and as the span of the sequence in a CUDA
graph), then the sweeps' walls through ``sweep_under_flips``.  ``--only
flip_corrupt`` times those last two alone.  Prints one JSON line per
process and shape, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ENC_F, ENC_D = 617, 10000
# (n, B, D) of the matched-memory families at budget 0.4: LogHD
# refinement, hybrid, SparseHD retraining, conventional (chip_smoke.py
# records the same from the fits it runs)
UPD_SHAPES = [(10, 64, 10000), (20, 64, 10000), (26, 64, 4000),
              (26, 256, 10000)]
# flip_corrupt's sweep chunks: (name, leaf shapes, bits)
FC_CHUNKS = [("loghd all", [(10, 10000), (26, 10)], 1),
             ("loghd all", [(10, 10000), (26, 10)], 4),
             ("conventional hv", [(26, 10000)], 1)]
LR = 3e-4


def host_us(torch, fn, calls: int = 400) -> float:
    """Host microseconds a call of fn takes to return, calls back to back
    with no synchronisation (the wrapper's own cost while the device keeps
    up)."""
    for _ in range(40):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def time_checkout(checkout: Path, only: list) -> None:
    """Build `checkout`'s kernels and print a row per shape (only
    flip_corrupt's and the sweeps' when `only` is ["flip_corrupt"])."""
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(checkout / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build_all()
    dev = torch.device("cuda")
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    g = torch.Generator(device=dev).manual_seed(0)
    name = os.path.relpath(checkout, ROOT)

    def emit(kernel: str, shape, case: dict, roles, **extra) -> None:
        row = cs.shape_row(torch, rates, shape, case, roles)
        row.update(extra)
        row["host_enqueue_us"] = host_us(torch, case["kernel"])
        # the kernel's device time by launch (the normalisation apart): each
        # launch's mean time, as device_ms counts it
        cs.warm(torch, case["kernel"])
        row["kernel_by_launch_device_ms"] = {
            re.search(r"(\w+)(?:<[^>]*>)?\(", ev).group(1): ms / cnt
            * round(cnt)
            for ms, cnt, ev in cs.profile_calls(torch, case["kernel"], 40)[2]}
        print(json.dumps({"checkout": name, "kernel": kernel, **row}),
              flush=True)

    if only == ["flip_corrupt"]:
        time_flips(torch, cs, dev, g, emit, name)
        return
    for shape in cs.BS_TIME_SHAPES:
        h, m = cs.bs_inputs(torch, dev, g, *shape)
        emit("bundle_sim", shape, cs.bs_case(torch, h, m),
             ("kernel", "plain", "library", "library_rsqrt"))
    for rows in cs.ENC_TIME_ROWS:
        x, w, bias, center = cs.enc_inputs(torch, dev, g, rows, ENC_F, ENC_D)
        emit("hdc_encode", (rows, ENC_F, ENC_D),
             cs.enc_case(torch, x, w, bias, center),
             ("kernel", "plain", "library", "gemm"))
    for shape in UPD_SHAPES:
        m, c, h = cs.update_inputs(torch, dev, g, *shape)
        emit("bundle_update", shape, cs.update_case(torch, m, c, h, LR),
             ("kernel", "plain", "library"))
    for (b, n, c) in cs.PD_SHAPES:
        case = cs.pd_case(torch, torch.randn((b, n), generator=g, device=dev),
                          torch.randn((c, n), generator=g, device=dev))
        emit("profile_decode", (b, n, c), case,
             ("kernel", "plain", "library"),
             span_ms=cs.graph_span_ms(torch, case["kernel"]))
    time_pairs(torch, cs, dev, g, name)
    time_head(torch, cs, dev, g, emit)
    time_flips(torch, cs, dev, g, emit, name)


def time_flips(torch, cs, dev, g, emit, name: str) -> None:
    """flip_corrupt at one point of (10, 10,000) 4-bit codes (p = 0.1)
    and at the sweeps' chunks, 6 p x 3 trials = 18 points with the sweeps'
    seeds: LogHD "all" at 1 and 4 bits (bundles (10, 10,000) and profiles
    (26, 10)) and conventional "hv" at 1 bit (prototypes (26, 10,000)), on
    random codes.  A checkout without ``flip_corrupt_grid`` runs a chunk
    as its G x L one-point launches.  Then the sweeps' walls through
    ``sweep_under_flips`` on isolet models fitted without refinement."""
    leaves = cs.fc_leaves(torch, dev, g, [(10, 10000)], 4)
    case = cs.fc_case(torch, leaves, [0.1], [[7]])
    emit("flip_corrupt", [1, [10, 10000]], case, ("kernel", "plain"),
         bits=4, points=1, span_ms=cs.graph_span_ms(torch, case["kernel"]))
    for fam, shapes, bits in FC_CHUNKS:
        leaves = cs.fc_leaves(torch, dev, g, shapes, bits)
        ps, seeds = cs.sweep_points(len(shapes))
        case = cs.fc_case(torch, leaves, ps, seeds)
        emit("flip_corrupt", [len(ps)] + [list(s) for s in shapes], case,
             ("kernel",), name=fam, bits=bits, points=len(ps),
             batched=case["batched"],
             launches=cs.fc_launches(case["kernel"]),
             span_ms=cs.graph_span_ms(torch, case["kernel"]))
    time_sweeps(torch, cs, name)


def time_sweeps(torch, cs, name: str, reps: int = 5) -> None:
    """Wall seconds of the sweeps chip_smoke.py runs (isolet, 6 p x 3
    trials): LogHD "all" at 1 and 4 bits, conventional "hv" at 1 bit, each
    the median of `reps`, on models fitted without refinement."""
    import statistics
    from repro_torch.api import dispatch, make_classifier
    from repro_torch.data.synth import load_dataset
    x_tr, y_tr, x_te, y_te, spec = load_dataset("isolet")
    loghd = make_classifier("loghd", spec.n_classes, spec.n_features,
                            dim=10_000, k=2, extra_bundles=5,
                            refine_epochs=0,
                            codebook_method="distance").fit(x_tr, y_tr)
    conv = make_classifier("conventional", spec.n_classes, spec.n_features,
                           dim=10_000, refine_epochs=0).fit(x_tr, y_tr)
    for fam, clf, bits, scope in (("loghd all", loghd, 1, "all"),
                                  ("loghd all", loghd, 4, "all"),
                                  ("conventional hv", conv, 1, "hv")):
        h = clf.encode(x_te)
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf.sweep_under_flips(bits, cs.P_GRID, h, y_te,
                                  n_trials=cs.N_TRIALS, scope=scope,
                                  predict_encoded=dispatch.predict_encoded,
                                  generator=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"checkout": name, "kernel": "sweep", "name": fam,
                          "bits": bits, "wall_s": statistics.median(
                              walls[1:]), "walls_s": walls[1:]}), flush=True)


def time_pairs(torch, cs, dev, g, name: str) -> None:
    """bundle_sim then profile_decode at 64 and 1,559 rows of D = 10,000
    queries against n = 10 unit bundles and 26 profiles: each alone and the
    pair, as spans in a CUDA graph; the pair chained by programmatic
    dependent launch where the checkout's wrapper takes ``pdl``, and
    without."""
    import inspect
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels import common
    from repro_torch.kernels.bundle_sim import bundle_similarity
    from repro_torch.kernels.profile_decode import profile_decode_scores
    chained = "pdl" in inspect.signature(profile_decode_scores).parameters
    m = l2_normalize(torch.randn((10, 10000), generator=g, device=dev))
    prof = torch.randn((26, 10), generator=g, device=dev) * 0.3
    for rows in (cs.MAX_BATCH, 1559):
        h = torch.randn((rows, 10000), generator=g, device=dev)
        acts = bundle_similarity(h, m)
        kw = {"pdl": True} if chained else {}
        row = {"checkout": name, "kernel": "pair", "shape": [rows, 10000, 10,
                                                             26],
               "bundle_sim_span_ms": cs.graph_span_ms(
                   torch, lambda: bundle_similarity(h, m)),
               "profile_decode_span_ms": cs.graph_span_ms(
                   torch, lambda: profile_decode_scores(acts, prof)),
               "pair_span_ms": cs.graph_span_ms(
                   torch, lambda: profile_decode_scores(
                       bundle_similarity(h, m), prof, **kw)),
               "chained": chained}
        if chained:
            with common.pdl(False):
                row["pair_span_no_pdl_ms"] = cs.graph_span_ms(
                    torch, lambda: profile_decode_scores(
                        bundle_similarity(h, m), prof, pdl=True))
        print(json.dumps(row), flush=True)


def time_head(torch, cs, dev, g, emit) -> None:
    """loghd_head at qwen3-1.7b's decode step (B = 4) and a 512-row
    prefill, bf16 h and M against bf16 and float32 P."""
    from repro_torch.kernels.loghd_head import (loghd_head_logits,
                                                loghd_head_logits_ref)
    d, n, v = 2048, 20, 151936
    m = (torch.randn((n, d), generator=g, device=dev) / d ** 0.5).to(
        torch.bfloat16)
    p16 = (torch.randn((v, n), generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    for b in (4, 512):
        h = torch.randn((b, d), generator=g, device=dev).to(torch.bfloat16)
        for p in (p16, p16.float()):
            def library(h=h, p=p):
                a = h.float() @ m.float().T
                pf = p.float()
                return torch.addmm(-(a * a).sum(1, keepdim=True)
                                   - (pf * pf).sum(1), a, pf.T, alpha=2.0)
            case = dict(
                kernel=lambda h=h, p=p: loghd_head_logits(h, m, p),
                plain=lambda h=h, p=p: loghd_head_logits_ref(h, m, p),
                library=library,
                bytes=(b * d * 2 + n * d * 2 + v * n * p.element_size()
                       + b * v * 4),
                ops=(2 * b * d * n + 2 * b * v * n + 2 * v * n + 2 * b * n
                     + 3 * b * v), op_type="float32")
            emit("loghd_head", (b, d, n, v), case,
                 ("kernel", "plain", "library"),
                 p_dtype=str(p.dtype).split(".")[1],
                 span_ms=cs.graph_span_ms(torch, case["kernel"],
                                          copies=20 if b < 64 else 4))


def main() -> int:
    args = sys.argv[1:]
    only = []
    if args[:1] == ["--only"]:
        only, args = args[1].split(","), args[2:]
    if args[:1] == ["--one"]:
        time_checkout(Path(args[1]).resolve(), only)
        return 0
    import torch
    if only not in ([], ["flip_corrupt"]):
        print("--only takes flip_corrupt", file=sys.stderr)
        return 1
    others = [Path(a).resolve() for a in args]
    if not torch.cuda.is_available() or not others:
        print("usage (on a card): python3 chip_kernel_ab.py CHECKOUT ...",
              file=sys.stderr)
        return 1
    for other in others:
        if not (other / "src" / "repro_torch").is_dir():
            print(f"{other} is not the root of a checkout", file=sys.stderr)
            return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    for checkout in others + [ROOT, ROOT] + others[::-1]:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        *(["--only", ",".join(only)] if only else []),
                        "--one", str(checkout)], check=True, timeout=900)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the ``bundle_sim``, ``hdc_encode`` and ``bundle_update`` kernels of
other checkouts beside this checkout's, on one NVIDIA Hopper card, in one
call.

Run from the root of a checkout, with one card visible:

    mkdir -p build/ab_parent
    git archive PARENT_COMMIT | tar -x -C build/ab_parent
    python3 chip_kernel_ab.py build/ab_parent [OTHER_CHECKOUT ...]

Each argument is the root of another checkout of this repo.  Every
checkout runs in a process of its own, which builds that checkout's
kernels and times them through its public wrappers,
``bundle_similarity(h, m)``, ``hdc_encode(x, proj, bias, center, kind)``
and ``bundle_update(m, c, h, lr)``, with this checkout's ``chip_smoke.py``
inputs, cases, bounds and timers (its ``shape_row``: device time per call
from ``torch.profiler`` after warm-up, beside the plain version, the
library call, for ``bundle_sim`` also ``(h @ m.T) * rsqrt(||h||^2 +
1e-12)``, for ``hdc_encode`` also cuBLAS's ``x @ W``).  The processes run the other checkouts, this one
twice, then the other checkouts in reverse, so drift on the card shows as
the gap between a checkout's two runs.  Each row also gives
``host_enqueue_us``, the host time a call of the wrapper takes to return
when calls run back to back (the launch path's cost in a host-bound loop).
Shapes: ``bundle_sim`` at
``chip_smoke.BS_TIME_SHAPES`` (B = 1, 64, 1,559 against n = 10 and 26
bundles, D = 10,000, float32), ``hdc_encode`` at
``chip_smoke.ENC_TIME_ROWS`` rows of isolet width (F = 617, D = 10,000),
``bundle_update`` at each matched-memory family's minibatch (n, B, D).
Prints one JSON line per process and shape, then the card's name and
power limit.
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


def time_checkout(checkout: Path) -> None:
    """Build `checkout`'s kernels and print a row per shape."""
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

    def emit(kernel: str, shape, case: dict, roles) -> None:
        row = cs.shape_row(torch, rates, shape, case, roles)
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


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        time_checkout(Path(sys.argv[2]).resolve())
        return 0
    import torch
    others = [Path(a).resolve() for a in sys.argv[1:]]
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
                        "--one", str(checkout)], check=True, timeout=900)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

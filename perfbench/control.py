"""Read a cell's compared numbers for its control or a planted fault, at
the cell's own size on the card, over several seeds in one process.

    python3 perfbench/control.py --workload isolet-loghd.classify \
        --seeds 11 12 13 [--seconds 10] [--fault <name>]

Without ``--fault`` the driver's ``CONTROL`` (the plain reference one
precision below the configuration's, see ``reference/precision.py``)
takes the program's place; with it, the program runs with that fault
planted (``FAULTS``).  Each seed prints one JSON line of its checks.
Runs never count toward a cell's metrics: this is how the limits of
``configs/<config>.json`` were set against the control and the faults.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(_ROOT, "src"), _ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness  # noqa: E402


def _half_batch():
    """The training step's loss over half of each batch, the mean taken
    over the rest."""
    import repro_torch.runtime.train_loop as tl
    full = tl.loss_fn

    def half(params, cfg, tokens, targets, mesh=None, **kw):
        b = tokens.shape[0] // 2
        return full(params, cfg, tokens[:b], targets[:b], mesh, **kw)
    return mock.patch.object(tl, "loss_fn", half)


def _altered_label():
    """Each predict call's last label is moved to the next class."""
    import repro_torch.api.dispatch as dp
    plain = dp.predict_encoded

    def altered(model, h, use_kernels=None):
        labels = plain(model, h, use_kernels).clone()
        labels[-1] = (labels[-1] + 1) % model.profiles.shape[0]
        return labels
    return mock.patch.object(dp, "predict_encoded", altered)


FAULTS = {"half_batch": _half_batch, "altered_label": _altered_label}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    harness.set_cache_dirs(harness.ROOT)
    cell = harness.resolve_cell(harness.ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fault:
            system, patch = None, FAULTS[args.fault]()
        else:
            system = cell.driver.CONTROL(cell.config, device)
            patch = contextlib.nullcontext()
        with patch:
            out = harness.run_cell(cell, seed, args.seconds, False, device,
                                   system=system, t_start=t0)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "system": getattr(system, "name", "repro_torch"),
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "wall_s": time.perf_counter() - t0,
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()}}), flush=True)
        del out, system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

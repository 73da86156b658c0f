"""Serving launcher CLI: batched decode over a synthetic request stream
(port of ``repro.launch.serve``), on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --smoke --requests 6 --max-new 16 [--device cpu]

The requests are the reference launcher's: ``--requests`` prompts of
3 + i mod 5 tokens drawn by ``np.random.default_rng(seed)``, served by
``--slots`` slots with ``max_len`` 256, greedy.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def requests_for(cfg, n: int, seed: int) -> list:
    """The launcher's request stream: prompt i has 3 + i % 5 tokens."""
    from repro_torch.runtime.serve_loop import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=3 + i % 5)
                    .astype(np.int32))
            for i in range(n)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=args.device)
    reqs = requests_for(cfg, args.requests, args.seed)
    sync = (torch.cuda.synchronize if params.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = run_serving(cfg, params, reqs,
                      ServeLoopConfig(batch_slots=args.slots,
                                      max_new_tokens=args.max_new,
                                      max_len=256))
    sync()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests, {total} tokens in {dt:.1f}s "
          f"({total / dt:.1f} tok/s) on {params.device} "
          f"({cfg.name}, head {cfg.head})")
    for uid in sorted(out):
        print(f"  req {uid}: {out[uid][:10].tolist()}...")
    return out


if __name__ == "__main__":
    main()

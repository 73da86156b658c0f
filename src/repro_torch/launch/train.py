"""Training launcher CLI (port of ``repro.launch.train``), on the card
unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --steps 20 [--device cpu]

The loop resumes from the newest committed checkpoint in ``--ckpt-dir``
(default: ``repro_ckpt`` under the temporary directory), so a scheduler
may kill and restart the job freely; a straggler abort exits with status
75 (EX_TEMPFAIL) for the scheduler to reschedule it elsewhere.

``--mesh debug`` trains on the ("data", "model") mesh of (world, 1),
``--mesh production`` on the (16, 16) one (256 ranks), laid out by
``models/sharding.py``.  Under ``torchrun`` the ranks join the group it
sets up (``env://``); a single process makes a group of one rank itself
(NCCL on the card, gloo with ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 2 --mesh debug --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "debug", "production"],
                    default="none")
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime.train_loop import (StragglerAbort,
                                                TrainLoopConfig,
                                                run_training)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    extra = {"ckpt_dir": args.ckpt_dir} if args.ckpt_dir else {}
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           peak_lr=args.peak_lr,
                           microbatches=args.microbatches, **extra)
    made = False
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch.mesh import (join_group, make_debug_mesh,
                                             make_production_mesh)
        made = join_group(args.device)
        mesh = (make_debug_mesh(args.device) if args.mesh == "debug"
                else make_production_mesh(device=args.device))
    try:
        out = run_training(cfg, mesh=mesh, loop=loop,
                           global_batch=args.global_batch,
                           seq_len=args.seq_len, device=args.device)
    except StragglerAbort as e:
        logging.error("straggler abort: %s", e)
        sys.exit(75)  # EX_TEMPFAIL: the scheduler should reschedule
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()
    if out["losses"]:
        logging.info("done on %s: resumed=%s loss %.4f -> %.4f",
                     out["params"].device, out["resumed"], out["losses"][0],
                     out["losses"][-1])
    else:
        logging.info("done: resumed=%s at step %d, nothing left to run",
                     out["resumed"], out["first_step"])
    return out


if __name__ == "__main__":
    main()

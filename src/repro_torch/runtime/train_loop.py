"""Fault-tolerant training loop (port of ``repro.runtime.train_loop``).

  * deterministic step-indexed data (``data/tokens.py``) and atomic async
    checkpoints (``checkpoint/ckpt.py``) give a bit-exact restart: the loop
    resumes from ``latest_step()`` and draws the batches it would have
    drawn;
  * the checkpoint is the reference's ``{"params", "opt"}`` tree (stacked
    parameters in their dtypes, the reference's AdamW tree), so a run
    started in either package resumes in the other
    (``models.convert.train_state``);
  * straggler watchdog: each step's wall time, taken around the loss's
    ``item()`` (the step's one synchronisation, as the reference's
    ``float(loss)``), is held against the running median of the last 50;
    after ``straggler_limit`` consecutive steps slower than
    ``straggler_factor`` x median the loop checkpoints and raises
    ``StragglerAbort``, so that the launcher can reschedule the job;
  * microbatch gradient accumulation in float32, the remat policy of the
    model config, the cosine LR.

The step runs eagerly and updates the parameters and the optimizer
state in place.  On a mesh (``launch/mesh.py``; every rank of the process
group runs the loop) the model and the AdamW state are laid out by
``models/sharding.py``, each batch enters split over the dp axes
(``batch_spec``), the newest checkpoint is restored onto the mesh
(elastic: it may have been written on another mesh, or none), and rank 0
writes the gathered checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint)
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import rank
from repro_torch.models import sharding as shd
from repro_torch.models.convert import (load_train_state, stacked_layers,
                                        train_state, train_state_shardings)
from repro_torch.models.model import DecoderLM, init_params, loss_fn
from repro_torch.models.moe import update_router_biases
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.spans import span

log = logging.getLogger("repro_torch.train")


class StragglerAbort(RuntimeError):
    """Raised after persistent stragglers; the launcher should reschedule."""


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    warmup_steps: int = 10
    peak_lr: float = 3e-4
    straggler_factor: float = 3.0
    straggler_limit: int = 5
    seed: int = 0


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    loop: TrainLoopConfig, mesh=None) -> Callable:
    """``(params, opt_state, batch, step) -> (params, opt_state, loss)``:
    the loss and its gradients (summed over ``loop.microbatches`` slices
    of the batch in float32, then averaged), then one AdamW step at the
    cosine LR of `step`, then the MoE layers' router-bias updates
    (DeepSeek-V3's, ``models/moe.py``; none in other configs).  The
    parameters, the state and the biases are updated in place; the loss
    is a float32 scalar tensor, not synchronised.  On
    `mesh` the parameters and the state must be laid out on it
    (``shard_model``, ``shard_opt_state``) and the batch is the global
    one."""
    def grads_of(params, tokens, targets) -> tuple:
        leaves = list(params.parameters())
        with span("repro_torch.train.forward"):
            loss = loss_fn(params, cfg, tokens, targets, mesh)
        with span("repro_torch.train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def train_step(params: DecoderLM, opt_state: dict, batch: dict, step):
        dev = params.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        targets = torch.as_tensor(batch["targets"], device=dev)
        names = [n for n, _ in params.named_parameters()]
        if loop.microbatches > 1:
            b = tokens.shape[0] // loop.microbatches
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in params.parameters()]
            for i in range(loop.microbatches):
                sl = slice(i * b, (i + 1) * b)
                l, grads = grads_of(params, tokens[sl], targets[sl])
                loss = loss + l
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
            loss = loss / loop.microbatches
            grads = [a / loop.microbatches for a in acc]
            del acc
        else:
            loss, grads = grads_of(params, tokens, targets)
        lr = cosine_schedule(int(step), peak_lr=loop.peak_lr,
                             warmup_steps=loop.warmup_steps,
                             total_steps=loop.total_steps)
        with span("repro_torch.train.optimizer"):
            adamw_update(opt_state, dict(params.named_parameters()),
                         dict(zip(names, grads)), opt_cfg, lr=lr)
            update_router_biases(params)
        return params, opt_state, loss
    return train_step


def run_training(cfg: ModelConfig, *, mesh=None,
                 loop: Optional[TrainLoopConfig] = None,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 global_batch: int = 8, seq_len: int = 128,
                 inject_straggler_at: Optional[int] = None,
                 stop_after: Optional[int] = None, device=None,
                 params: Optional[DecoderLM] = None,
                 batches: Optional[Callable[[int], dict]] = None) -> dict:
    """Run (or resume) training, on `mesh` when one is given.  Returns
    {params, losses, resumed, first_step}.

    `device` (None: the card, raising without one) holds the model and
    the batches.  `params` starts from given weights instead of
    ``init_params(cfg, loop.seed)``, and `batches` (step -> {"tokens",
    "targets"}, tensors or numpy arrays) replaces the ``TokenPipeline`` of
    (global_batch, seq_len, loop.seed): the tests pass the reference's
    initial weights and batches this way.  A committed checkpoint in
    ``loop.ckpt_dir`` overrides both the weights and the first step.
    `inject_straggler_at`: test hook, sleeps 0.5 s in that step.
    `stop_after`: simulate a preemption after that step (checkpointing
    first), the LR schedule still pinned to ``loop.total_steps``."""
    loop = loop or TrainLoopConfig()
    dev = params.device if params is not None else resolve_device(device)
    if batches is None:
        batches = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                                global_batch=global_batch, seed=loop.seed,
                                device=dev).batch
    model = params if params is not None else init_params(cfg, loop.seed,
                                                          dev)
    model = shd.shard_model(model, mesh)
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg,
                           stacked_layers(model))
    sharded = shd.mesh_of(model.embed.table) is not None

    step0, resumed = 0, False
    latest = latest_step(loop.ckpt_dir)
    if latest is not None:
        restored = restore_checkpoint(
            loop.ckpt_dir, latest, train_state(model, opt_state, spec=True),
            train_state_shardings(model, opt_state) if sharded else None,
            device=dev)
        opt_state = load_train_state(restored, model)
        del restored
        step0, resumed = latest, True
        log.info("resumed from step %d", step0)

    step_fn = make_train_step(cfg, opt_cfg, loop, mesh)
    ckpt = AsyncCheckpointer(loop.ckpt_dir)

    def save(step: int) -> None:
        tree = train_state(model, opt_state)   # gathered on every rank
        if rank() == 0:
            ckpt.save(step, tree)
    losses: list = []
    durations: list = []
    slow_streak = 0
    for step in range(step0, loop.total_steps):
        t0 = time.monotonic()
        model, opt_state, loss = step_fn(model, opt_state, batches(step),
                                         step)
        loss = loss.item()
        if inject_straggler_at is not None and step == inject_straggler_at:
            time.sleep(0.5)  # test hook: simulated slow host
        dt = time.monotonic() - t0
        losses.append(loss)

        # ---- straggler watchdog
        if len(durations) >= 5:
            med = float(np.median(durations))
            if dt > loop.straggler_factor * med:
                slow_streak += 1
                log.warning("straggling step %d: %.3fs vs median %.3fs "
                            "(streak %d)", step, dt, med, slow_streak)
                if slow_streak >= loop.straggler_limit:
                    save(step + 1)
                    ckpt.wait()
                    raise StragglerAbort(
                        f"{slow_streak} consecutive slow steps at {step}")
            else:
                slow_streak = 0
        durations.append(dt)
        if len(durations) > 50:
            durations.pop(0)

        if (step + 1) % loop.log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step + 1, loss, dt)
        if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.total_steps:
            save(step + 1)
        if stop_after is not None and step + 1 >= stop_after:
            save(step + 1)
            break
    ckpt.wait()
    return {"params": model, "losses": losses, "resumed": resumed,
            "first_step": step0}

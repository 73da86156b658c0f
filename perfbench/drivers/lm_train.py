"""Decoder LM training steps (family "lm").

Set-up makes every weight on the card from the seed (``make_weights``: one
generator, one draw a leaf stacked over the layers), builds the program's
model from them, its AdamW state and the step that
``repro_torch.runtime.train_loop.make_train_step`` returns, and drives
that step through its first ``prelude_steps`` steps, which also warm up
every shape of the window.  The window runs the same step object on, one
step a call, each call drawing its own batch of ``batch`` x ``seq_len``
tokens from the frozen step-indexed pipeline and ending in the loss's
``item()``.

The check (the reference, ``perfbench/reference/lm.py``, follows the
first three steps from the same weights and batches): each step's loss
(``loss_gap``, relative), each leaf's first gradient as the optimizer got
it (clipped), read from the first moment after step 1 as mu / (1 - b1)
(``grad_gap``), and each leaf's change after the three steps
(``step_gap``); a leaf's gap is the difference of the two norms over the
larger of the reference's norm of that leaf and of the median leaf,
and the number is the worst leaf's.  Leaves whose reference gradient is
under a thousandth of the median leaf's are left out of both.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from perfbench.frozen.tokens import TokenPipeline
from perfbench.reference import lm as ref
from perfbench.reference.precision import FP8

EXCLUDE_BELOW = 1e-3


def leaves(m: dict) -> list:
    """(name, shape of one layer's leaf, scale, per-layer) of every weight
    in draw order; scale 0 is a zero leaf (the norms)."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, f, v = m["n_experts"], m["moe_d_ff"], m["vocab"]
    n = max(1, math.ceil(math.log(v) / math.log(m["loghd_k"]))) \
        + m["loghd_extra"]
    out = [("embed.table", (v, d), 0.02, False)]
    out += [("ln1", (d,), 0.0, True), ("ln2", (d,), 0.0, True),
            ("attn.wq", (d, h * hd), d ** -0.5, True),
            ("attn.wk", (d, kv * hd), d ** -0.5, True),
            ("attn.wv", (d, kv * hd), d ** -0.5, True),
            ("attn.wo", (h * hd, d), (h * hd) ** -0.5, True)]
    if m["pattern"][0]["ffn"] == "moe":
        out += [("moe.router", (d, e), d ** -0.5, True),
                ("moe.wi", (e, d, f), d ** -0.5, True),
                ("moe.wg", (e, d, f), d ** -0.5, True),
                ("moe.wo", (e, f, d), f ** -0.5, True)]
    else:
        out += [("mlp.wi", (d, m["d_ff"]), d ** -0.5, True),
                ("mlp.wg", (d, m["d_ff"]), d ** -0.5, True),
                ("mlp.wo", (m["d_ff"], d), m["d_ff"] ** -0.5, True)]
    out += [("final_norm", (d,), 0.0, False),
            ("head.bundles", (n, d), d ** -0.5, False),
            ("head.profiles", (v, n), 0.05, False)]
    return out


def make_weights(m: dict, seed: int, device):
    """Yield (name, tensor) for every weight, each in the dtype the
    configuration stores it in, drawn N(0, 1) * scale in float32 from one
    generator on `device` seeded with `seed`: one draw a leaf, stacked
    over the layers for the per-layer ones (named ``layers.{l}.<leaf>``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, m["dtype"])
    layers = m["n_periods"]
    for name, shape, scale, per_layer in leaves(m):
        full = (layers, *shape) if per_layer else shape
        if scale:
            w = torch.randn(full, generator=gen, device=device)
            w = w.mul_(scale).to(ref.stored_dtype(name, dtype))
        else:
            w = torch.zeros(full, device=device)
        if per_layer:
            for layer in range(layers):
                yield f"layers.{layer}.{name}", w[layer]
        else:
            yield name, w


def port_name(name: str) -> str:
    """The program's parameter name of reference leaf `name`."""
    if name.startswith("layers."):
        _, layer, rest = name.split(".", 2)
        return f"body.0.{layer}.{rest}"
    return name


class Port:
    """The program: its model, AdamW state and ``make_train_step``."""

    name = "repro_torch"

    def __init__(self, cfg: dict, device):
        import dataclasses
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.models.moe import MoEConfig
        from repro_torch.optim.adamw import AdamWConfig
        self.device = device
        get = get_smoke_config if cfg.get("program_smoke") else get_config
        pc = dataclasses.replace(get(cfg["program_config"]),
                                 **cfg.get("program_overrides", {}))
        for key, want in cfg["model"].items():
            have = getattr(pc, key)
            if key in ("pattern", "prefix_pattern"):
                have = [dataclasses.asdict(b) for b in have]
            if have != want:
                raise ValueError(f"the program's {cfg['program_config']} has "
                                 f"{key} = {have!r}, the configuration "
                                 f"states {want!r}")
        if MoEConfig.router_aux_weight != cfg["router_aux_weight"]:
            raise ValueError("the program's router_aux_weight differs")
        o = cfg["optimizer"]
        self.opt_cfg = AdamWConfig(lr=o["peak_lr"], b1=o["b1"], b2=o["b2"],
                                   eps=o["eps"],
                                   weight_decay=o["weight_decay"],
                                   clip_norm=o["clip_norm"],
                                   moment_dtype=o["moment_dtype"])
        self.pc, self.o = pc, o

    def build(self, weights) -> None:
        from repro_torch.models.convert import stacked_layers
        from repro_torch.models.model import DecoderLM
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                    make_train_step)
        model = DecoderLM(self.pc, device=self.device)
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, w in weights:
                params[port_name(name)].copy_(w)
        loop = TrainLoopConfig(total_steps=self.o["total_steps"],
                               warmup_steps=self.o["warmup_steps"],
                               peak_lr=self.o["peak_lr"])
        self.model = model
        self.opt = adamw_init(params, self.opt_cfg, stacked_layers(model))
        self.step_fn = make_train_step(self.pc, self.opt_cfg, loop)

    def step(self, batch: dict, step: int) -> torch.Tensor:
        self.model, self.opt, loss = self.step_fn(self.model, self.opt,
                                                  batch, step)
        return loss

    def first_moment(self, name: str) -> torch.Tensor:
        return self.opt["mu"][port_name(name)]

    def param(self, name: str) -> torch.Tensor:
        return dict(self.model.named_parameters())[port_name(name)]

    def release(self) -> None:
        self.model = self.opt = self.step_fn = None


class Control:
    """The reference in the program's place, its products in fp8: the
    control that the check has to fail."""

    name = "reference at fp8"

    def __init__(self, cfg: dict, device):
        self.step_ref = ref.Step(cfg, FP8)

    def build(self, weights) -> None:
        self.p = {n: w.float() for n, w in weights}
        self.opt = self.step_ref.init_opt(self.p)

    def step(self, batch: dict, step: int) -> torch.Tensor:
        loss, g = self.step_ref.grads(self.p, batch["tokens"],
                                      batch["targets"])
        self.step_ref.update(self.p, g, self.opt, self.step_ref.lr(step))
        return loss

    def first_moment(self, name: str) -> torch.Tensor:
        return self.opt["mu"][name]

    def param(self, name: str) -> torch.Tensor:
        return self.p[name]

    def release(self) -> None:
        self.p = self.opt = None


CONTROL = Control


def _gap(got: dict, want: dict, keep: list) -> float:
    """The worst leaf's |norm got - norm want| over max(norm want, the
    median leaf's norm want)."""
    med = statistics.median(want[n] for n in keep)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
               for n in keep)


class Train:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, system):
        if cfg["family"] != "lm":
            raise ValueError(f"{cfg['name']} is no LM configuration")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.system = system if system is not None else Port(cfg, device)
        m = cfg["model"]
        self.pipe = TokenPipeline(vocab=m["vocab"], seq_len=traffic["seq_len"],
                                  global_batch=traffic["batch"], seed=seed,
                                  device=device)
        self.b1 = cfg["optimizer"]["b1"]

    def names(self) -> list:
        m = self.cfg["model"]
        return [f"layers.{layer}.{n}" if per_layer else n
                for n, _, _, per_layer in leaves(m)
                for layer in (range(m["n_periods"]) if per_layer else [0])]

    def _norms(self, get) -> dict:
        return {n: float(torch.linalg.vector_norm(get(n).float()))
                for n in self.names()}

    def change_norms(self, param, device) -> dict:
        """Each leaf's ||param(name) - its initial weight||."""
        out = {}
        for n, w0 in make_weights(self.cfg["model"], self.seed, device):
            out[n] = float(torch.linalg.vector_norm(
                param(n).detach().float() - w0.float()))
        return out

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        sys_ = self.system
        sys_.build(make_weights(self.cfg["model"], self.seed, self.device))
        self.losses = []
        for s in range(self.traffic["prelude_steps"]):
            loss = sys_.step(self.pipe.batch(s), s)
            self.losses.append(float(loss.item()))
            if s == 0:
                c1 = 1.0 - self.b1
                self.grad_norms = {
                    n: v / c1 for n, v in self._norms(
                        sys_.first_moment).items()}
        self.change = self.change_norms(sys_.param, self.device)
        self.next_step = self.traffic["prelude_steps"]

    # ----------------------------------------------------------- window

    def window(self, seconds: float, span) -> dict:
        steps = failed = 0
        with span("perfbench.window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                s = self.next_step
                with span("perfbench.train_step"):
                    loss = self.system.step(self.pipe.batch(s), s)
                with span("perfbench.collect"):
                    value = loss.item()
                failed += not math.isfinite(value)
                steps += 1
                self.next_step += 1
            elapsed = time.perf_counter() - t0
        tokens = self.traffic["batch"] * self.traffic["seq_len"]
        return {"attempted": steps, "failed": failed, "elapsed": elapsed,
                "tokens": steps * tokens,
                "counts": {"steps": steps, "batch": self.traffic["batch"],
                           "seq_len": self.traffic["seq_len"]}}

    def end_to_end(self, stats: dict) -> dict:
        return {"train_tokens_s": stats["tokens"] / stats["elapsed"]}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        self.system.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        step = ref.Step(self.cfg)
        p = {n: w.float() for n, w in make_weights(self.cfg["model"],
                                                   self.seed, self.device)}
        batches = [(b["tokens"], b["targets"]) for b in
                   (self.pipe.batch(s) for s in range(3))]
        losses, grad_ref = [], None
        for i, (loss, _, state) in enumerate(step.train(p, batches)):
            losses.append(float(loss))
            if i == 0:
                grad_ref = {n: float(torch.linalg.vector_norm(mu))
                            / (1.0 - self.b1)
                            for n, mu in state["mu"].items()}
        del state
        change_ref = self.change_norms(p.__getitem__, self.device)
        med = statistics.median(grad_ref.values())
        keep = [n for n in grad_ref if grad_ref[n] >= EXCLUDE_BELOW * med]
        print(f"perfbench: {len(keep)} of {len(grad_ref)} leaves compared",
              file=sys.stderr)
        lim = self.cfg["limits"]
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(self.losses[:3], losses))
        return {"loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
                "grad_gap": {"value": _gap(self.grad_norms, grad_ref, keep),
                             "limit": lim["grad_gap"]},
                "step_gap": {"value": _gap(self.change, change_ref, keep),
                             "limit": lim["step_gap"]}}


def build(cfg: dict, traffic: dict, seed: int, device, system=None):
    return Train(cfg, traffic, seed, device, system)

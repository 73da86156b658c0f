"""DeepSeek-V3 training steps on one chip's share of expert parallelism
(family "lm", latent attention, a dense prefix, held experts).

As ``lm_train``: set-up makes every weight on the card from the seed (one
generator, one draw a leaf stacked over the layers of its kind), builds the
program's model from them, its AdamW state and the step that
``repro_torch.runtime.train_loop.make_train_step`` returns, and drives that
step through its first ``prelude_steps`` steps; the window runs the same
step object, one step a call on a batch of its own from the frozen
step-indexed pipeline, ending in the loss's ``item()``.  The program is
``program_config`` (a config of the port's own registry); it is looked up
before any weight is drawn, so a program without it fails at once.

The routing counters (choices on held experts, those the capacity dropped,
each routed expert's load) are zeroed before the window and read once
after it, into the window's ``counts`` (``held_choices``,
``dropped_choices``, ``expert_loads``: each MoE layer's list).

The check (``perfbench/reference/lm_mla.py`` follows the first three steps
from the same weights and batches): ``loss_gap``, ``grad_gap`` and
``step_gap`` as ``lm_train`` reads them, and ``bias_gap``, the share of the
MoE layers' router-bias entries that differ from the reference's after the
three steps by more than half a bias step.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from perfbench.drivers.lm_train import EXCLUDE_BELOW, _gap
from perfbench.frozen.tokens import TokenPipeline
from perfbench.reference import lm_mla as ref
from perfbench.reference.precision import FP8

ALL, DENSE, MOE = "all", "dense", "moe"


def leaves(m: dict) -> list:
    """(name, shape of one layer's leaf, scale, kind) of every weight in
    draw order; kind names the layers a leaf is stacked over (None: not a
    layer's), scale 0 is a zero leaf (the norms)."""
    d, h, v = m["d_model"], m["n_heads"], m["vocab"]
    lq, lkv = m["mla_q_lora"], m["mla_kv_lora"]
    dn, dr, dv = m["mla_nope_dim"], m["mla_rope_dim"], m["mla_v_dim"]
    f, fe, fs = m["d_ff"], m["moe_d_ff"], m["shared_expert_ff"]
    eh, er = m["n_experts"], m["n_routed_experts"]
    n = max(1, math.ceil(math.log(v) / math.log(m["loghd_k"]))) \
        + m["loghd_extra"]
    return [
        ("embed.table", (v, d), 0.02, None),
        ("ln1", (d,), 0.0, ALL), ("ln2", (d,), 0.0, ALL),
        ("mla.wq_a", (d, lq), d ** -0.5, ALL),
        ("mla.q_a_norm", (lq,), 0.0, ALL),
        ("mla.wq_b", (lq, h * (dn + dr)), lq ** -0.5, ALL),
        ("mla.wkv_a", (d, lkv + dr), d ** -0.5, ALL),
        ("mla.kv_a_norm", (lkv,), 0.0, ALL),
        ("mla.wkv_b", (lkv, h * (dn + dv)), lkv ** -0.5, ALL),
        ("mla.wo", (h * dv, d), (h * dv) ** -0.5, ALL),
        ("mlp.wi", (d, f), d ** -0.5, DENSE),
        ("mlp.wg", (d, f), d ** -0.5, DENSE),
        ("mlp.wo", (f, d), f ** -0.5, DENSE),
        ("moe.router", (d, er), d ** -0.5, MOE),
        ("moe.wi", (eh, d, fe), d ** -0.5, MOE),
        ("moe.wg", (eh, d, fe), d ** -0.5, MOE),
        ("moe.wo", (eh, fe, d), fe ** -0.5, MOE),
        ("moe.shared_wi", (d, fs), d ** -0.5, MOE),
        ("moe.shared_wg", (d, fs), d ** -0.5, MOE),
        ("moe.shared_wo", (fs, d), fs ** -0.5, MOE),
        ("final_norm", (d,), 0.0, None),
        ("head.bundles", (n, d), d ** -0.5, None),
        ("head.profiles", (v, n), 0.05, None)]


def layers_of(m: dict, kind) -> range:
    """The layers a leaf of `kind` is stacked over."""
    p, total = m["n_prefix"], m["n_prefix"] + m["n_periods"]
    return {ALL: range(total), DENSE: range(p), MOE: range(p, total)}[kind]


def make_weights(m: dict, seed: int, device):
    """Yield (name, tensor) for every weight, each in the dtype the
    configuration stores it in, drawn N(0, 1) * scale in float32 from one
    generator on `device` seeded with `seed`: one draw a leaf, stacked over
    the layers of its kind (named ``layers.{l}.<leaf>``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, m["dtype"])
    for name, shape, scale, kind in leaves(m):
        layers = layers_of(m, kind) if kind else None
        full = (len(layers), *shape) if kind else shape
        if scale:
            w = torch.randn(full, generator=gen, device=device)
            w = w.mul_(scale).to(ref.stored_dtype(name, dtype))
        else:
            w = torch.zeros(full, device=device)
        if kind:
            for i, layer in enumerate(layers):
                yield f"layers.{layer}.{name}", w[i]
        else:
            yield name, w
        del w


def port_name(name: str, n_prefix: int) -> str:
    """The program's parameter (or buffer) name of reference leaf `name`."""
    if name.startswith("layers."):
        _, layer, rest = name.split(".", 2)
        layer = int(layer)
        if layer < n_prefix:
            return f"prefix.0.{layer}.{rest}"
        return f"body.0.{layer - n_prefix}.{rest}"
    return name


class Port:
    """The program: its model, AdamW state and ``make_train_step``."""

    name = "repro_torch"

    def __init__(self, cfg: dict, device):
        import dataclasses
        from repro_torch.configs import get_config, get_smoke_config
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
        o = cfg["optimizer"]
        self.opt_cfg = AdamWConfig(lr=o["peak_lr"], b1=o["b1"], b2=o["b2"],
                                   eps=o["eps"],
                                   weight_decay=o["weight_decay"],
                                   clip_norm=o["clip_norm"],
                                   moment_dtype=o["moment_dtype"])
        self.pc, self.o = pc, o
        self.n_prefix = cfg["model"]["n_prefix"]

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
                params[port_name(name, self.n_prefix)].copy_(w)
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
        return self.opt["mu"][port_name(name, self.n_prefix)]

    def param(self, name: str) -> torch.Tensor:
        return dict(self.model.named_parameters())[
            port_name(name, self.n_prefix)]

    def bias(self, layer: int) -> torch.Tensor:
        return dict(self.model.named_buffers())[port_name(
            f"layers.{layer}.moe.router_bias", self.n_prefix)]

    def reset_counters(self) -> None:
        from repro_torch.models.moe import reset_routing_counters
        reset_routing_counters(self.model)

    def counters(self) -> dict:
        from repro_torch.models.moe import routing_counters
        return routing_counters(self.model)

    def release(self) -> None:
        self.model = self.opt = self.step_fn = None


class Control:
    """The reference in the program's place, its products in fp8: the
    control that the check has to fail."""

    name = "reference at fp8"

    def __init__(self, cfg: dict, device):
        self.step_ref = ref.Step(cfg, FP8)
        self.device = device

    def build(self, weights) -> None:
        self.p = {n: w.float() for n, w in weights}
        self.opt = self.step_ref.init_opt(self.p)
        self.biases = self.step_ref.init_biases(self.device)

    def step(self, batch: dict, step: int) -> torch.Tensor:
        sr = self.step_ref
        loss, g = sr.grads(self.p, self.biases, batch["tokens"],
                           batch["targets"])
        sr.update(self.p, g, self.opt, sr.lr(step))
        sr.update_biases(self.biases)
        return loss

    def first_moment(self, name: str) -> torch.Tensor:
        return self.opt["mu"][name]

    def param(self, name: str) -> torch.Tensor:
        return self.p[name]

    def bias(self, layer: int) -> torch.Tensor:
        return self.biases[layer]

    def reset_counters(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.p = self.opt = self.biases = None


CONTROL = Control


class Train:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, system):
        if cfg["family"] != "lm":
            raise ValueError(f"{cfg['name']} is no LM configuration")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.system = system if system is not None else Port(cfg, device)
        m = cfg["model"]
        self.m = m
        self.pipe = TokenPipeline(vocab=m["vocab"], seq_len=traffic["seq_len"],
                                  global_batch=traffic["batch"], seed=seed,
                                  device=device)
        self.b1 = cfg["optimizer"]["b1"]
        self.moe_layers = layers_of(m, MOE)

    def names(self) -> list:
        return [f"layers.{layer}.{n}" if kind else n
                for n, _, _, kind in leaves(self.m)
                for layer in (layers_of(self.m, kind) if kind else [0])]

    def change_norms(self, param, device) -> dict:
        """Each leaf's ||param(name) - its initial weight||."""
        out = {}
        for n, w0 in make_weights(self.m, self.seed, device):
            out[n] = float(torch.linalg.vector_norm(
                param(n).detach().float() - w0.float()))
        return out

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        sys_ = self.system
        sys_.build(make_weights(self.m, self.seed, self.device))
        self.losses = []
        for s in range(self.traffic["prelude_steps"]):
            loss = sys_.step(self.pipe.batch(s), s)
            self.losses.append(float(loss.item()))
            if s == 0:
                c1 = 1.0 - self.b1
                self.grad_norms = {
                    n: float(torch.linalg.vector_norm(
                        sys_.first_moment(n).float())) / c1
                    for n in self.names()}
            if s == 2:
                self.biases = {layer: sys_.bias(layer).detach().float()
                               .clone() for layer in self.moe_layers}
        self.change = self.change_norms(sys_.param, self.device)
        self.next_step = self.traffic["prelude_steps"]

    # ----------------------------------------------------------- window

    def window(self, seconds: float, span) -> dict:
        steps = failed = 0
        self.system.reset_counters()
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
        counts = {"steps": steps, "batch": self.traffic["batch"],
                  "seq_len": self.traffic["seq_len"]}
        c = self.system.counters()
        if c:
            counts.update(held_choices=c["held"],
                          dropped_choices=c["dropped"],
                          expert_loads=c["loads"])
            loads = [x for row in c["loads"] for x in row]
            if steps and loads:
                print(f"perfbench: routing over {steps} steps: "
                      f"{c['held']} held choices, {c['dropped']} dropped; "
                      f"expert loads a step min {min(loads) / steps:g} "
                      f"median {statistics.median(loads) / steps:g} "
                      f"max {max(loads) / steps:g}", file=sys.stderr)
        return {"attempted": steps, "failed": failed, "elapsed": elapsed,
                "tokens": steps * tokens, "counts": counts}

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
        p = {n: w.float() for n, w in make_weights(self.m, self.seed,
                                                   self.device)}
        biases = step.init_biases(self.device)
        batches = [(b["tokens"], b["targets"]) for b in
                   (self.pipe.batch(s) for s in range(3))]
        losses, grad_ref = [], None
        for i, (loss, _, state) in enumerate(step.train(p, biases, batches)):
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
        for what, got, want in (("grad", self.grad_norms, grad_ref),
                                ("step", self.change, change_ref)):
            worst = max(keep, key=lambda n: abs(got[n] - want[n]))
            print(f"perfbench: {what}_gap's worst leaf {worst}: "
                  f"{got[worst]!r} against {want[worst]!r}", file=sys.stderr)
        half = self.m["bias_update_rate"] / 2
        differ = sum(int((self.biases[layer] - biases[layer]).abs()
                         .gt(half).sum()) for layer in self.moe_layers)
        entries = len(self.moe_layers) * self.m["n_routed_experts"]
        lim = self.cfg["limits"]
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(self.losses[:3], losses))
        return {"loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
                "grad_gap": {"value": _gap(self.grad_norms, grad_ref, keep),
                             "limit": lim["grad_gap"]},
                "step_gap": {"value": _gap(self.change, change_ref, keep),
                             "limit": lim["step_gap"]},
                "bias_gap": {"value": differ / entries,
                             "limit": lim["bias_gap"]}}


def build(cfg: dict, traffic: dict, seed: int, device, system=None):
    return Train(cfg, traffic, seed, device, system)

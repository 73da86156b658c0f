"""DeepSeek-V3 in the port (``deepseek-v3-ep32``: the sigmoid group-limited
router with its correction bias, a held share of the experts, YaRN latent
attention) against the plain reference ``perfbench/reference/lm_mla.py``
at small sizes on the CPU, with seeded random weights: the router, the
bias update, YaRN's closed form, prefill and absorbed decode against the
forward, the share test of expert parallelism, and a whole training
step."""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.drivers import lm_train_mla  # noqa: E402
from perfbench.frozen import flops  # noqa: E402
from perfbench.reference import lm_mla  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, PORT_ONLY_NAMES,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models.layers import Yarn, rope_frequencies  # noqa: E402
from repro_torch.models.mla import MLA, MLAConfig  # noqa: E402
from repro_torch.models.model import (DecoderLM, decode_step,  # noqa: E402
                                      forward, init_decode_state, loss_fn)
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.models.convert import (router_biases,  # noqa: E402
                                        stacked_layers, train_state)
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: E402
                                            make_train_step, run_training)

ARCH = "deepseek-v3-ep32"
OPT = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "clip_norm": 1.0, "moment_dtype": "float32", "peak_lr": 2.2e-4,
       "warmup_steps": 1, "total_steps": 10}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(**kw):
    return dataclasses.replace(get_smoke_config(ARCH), **kw)


def ref_cfg(cfg) -> dict:
    """The reference's configuration file for program config `cfg`."""
    return {"model": dataclasses.asdict(cfg), "optimizer": OPT,
            "rms_norm_eps": 1e-6}


def moe_cfg(**kw) -> pmoe.MoEConfig:
    base = dict(d_model=32, d_ff=16, n_experts=64, top_k=8,
                shared_expert_ff=16, router="sigmoid_group",
                n_routed_experts=64, n_group=8, topk_group=4,
                routed_scaling_factor=2.5, balance_weight=1e-4,
                bias_update_rate=1e-3)
    return pmoe.MoEConfig(**{**base, **kw})


def ref_step(mc: pmoe.MoEConfig) -> lm_mla.Step:
    model = dataclasses.asdict(smoke(
        d_model=mc.d_model, n_experts=mc.n_experts, top_k=mc.top_k,
        n_routed_experts=mc.n_routed, n_group=mc.n_group,
        topk_group=mc.topk_group, moe_d_ff=mc.d_ff,
        shared_expert_ff=mc.shared_expert_ff,
        capacity_factor=mc.capacity_factor))
    return lm_mla.Step({"model": model, "optimizer": OPT,
                        "rms_norm_eps": 1e-6})


def make_moe(mc, seed=0):
    m = pmoe.MoE(mc, device="cpu", dtype=torch.float32)
    m.init_weights(torch.Generator().manual_seed(seed))
    return m


# ------------------------------------------------------------- configs ---

def test_the_port_only_config_keeps_the_shared_registry():
    assert PORT_ONLY_NAMES == [ARCH] and ARCH not in ARCH_NAMES
    cfg = get_config(ARCH)
    base = get_config("deepseek-v3-671b")
    for f in dataclasses.fields(base):
        if f.name not in ("name", "n_prefix", "n_periods", "n_experts",
                          "head"):
            assert getattr(cfg, f.name) == getattr(base, f.name), f.name
    assert (cfg.n_prefix, cfg.n_periods, cfg.n_experts, cfg.n_routed,
            cfg.head, cfg.loghd_bundles) == (1, 4, 8, 256, "loghd", 19)
    # the parameters on the chip, as the benchmark's frozen count has them
    shape = flops.model_shape(dataclasses.asdict(cfg))
    assert cfg.param_count() == flops.param_count(shape)
    assert cfg.active_param_count() == flops.active_param_count(shape)
    with pytest.raises(KeyError):
        get_config("deepseek-v3-ep64")


def test_a_plain_config_keeps_the_softmax_router_and_every_expert():
    m = DecoderLM(get_smoke_config("granite-moe-1b-a400m"), device="cpu")
    moes = [x for x in m.modules() if isinstance(x, pmoe.MoE)]
    assert moes and all(not x.cfg.held_share for x in moes)
    assert not any(name.endswith("router_bias")
                   for name, _ in m.named_buffers())
    assert pmoe.routing_counters(m) == {}


def test_the_softmax_router_refuses_a_held_share():
    with pytest.raises(ValueError, match="8 held of 64"):
        make_moe(moe_cfg(router="softmax", n_experts=8))
    assert not moe_cfg(router="softmax", n_routed_experts=0).held_share


def test_the_mesh_path_refuses_a_held_share():
    moe = make_moe(moe_cfg(n_experts=8))
    mesh = SimpleNamespace(device_mesh=object(), axis_names=("data", "model"))
    with pytest.raises(ValueError, match="8 of 64"):
        pmoe.moe_block(moe, torch.zeros(1, 4, 32), mesh)


# -------------------------------------------------------------- router ---

def test_the_router_matches_the_reference():
    mc = moe_cfg()
    moe = make_moe(mc)
    with torch.no_grad():
        moe.router_bias.copy_(torch.randn(64, generator=torch.Generator()
                                          .manual_seed(3)) * 0.05)
    x = torch.randn(2 * 32, 32, generator=torch.Generator().manual_seed(1))
    r = moe.route(x, seq_len=32)
    experts, gates, aux, load = ref_step(mc).route(moe.router.detach(), x,
                                                   moe.router_bias, 32)
    assert torch.equal(r.experts, experts)
    torch.testing.assert_close(r.gates, gates, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(r.aux, aux, rtol=1e-6, atol=0)
    assert torch.allclose(r.gates.sum(-1), torch.full((64,), 2.5))
    # the group limit decides some tokens' choices here
    s = torch.sigmoid(x @ moe.router.detach()) + moe.router_bias
    plain = pmoe.top_k(s, 8)[1]
    assert (plain.sort(-1)[0] != r.experts.sort(-1)[0]).any(-1).sum() > 5
    assert int(load.sum()) == 64 * 8


def test_the_group_limit_on_a_hand_made_case():
    """Eight experts in four groups of two, two groups kept, top-2: the two
    best single experts lie in groups whose second expert is weak, so the
    two even groups win and the choice is inside them."""
    mc = moe_cfg(d_model=4, n_experts=8, n_routed_experts=8, top_k=2,
                 n_group=4, topk_group=2, routed_scaling_factor=1.0)
    moe = make_moe(mc)
    want = torch.tensor([0.95, 0.0, 0.6, 0.6, 0.55, 0.55, 0.9, 0.05])
    with torch.no_grad():
        moe.router_bias.copy_(want - 0.5)   # x = 0: every s is 1/2
    r = moe.route(torch.zeros(3, 4))
    assert r.experts.tolist() == [[2, 3]] * 3
    assert r.gates.tolist() == [[0.5, 0.5]] * 3
    experts = ref_step(mc).route(moe.router.detach(), torch.zeros(3, 4),
                                 moe.router_bias, 3)[0]
    assert experts.tolist() == [[2, 3]] * 3


def test_the_bias_update_follows_the_sign_of_the_load_error():
    mc = moe_cfg(bias_update_rate=0.05)
    moe = make_moe(mc)
    x = torch.randn(4 * 16, 32, generator=torch.Generator().manual_seed(2))
    with torch.enable_grad():
        moe.route(x, seq_len=16)
        with pmoe.replay():
            moe.route(x, seq_len=16)      # a recomputation counts nothing
    load = moe.step_load.clone()
    assert int(load.sum()) == 64 * 8 and int(moe.load_count.sum()) == 512
    moe.update_bias()
    gamma = torch.tensor(0.05)
    want = gamma * torch.sign(load.float().mean() - load.float())
    assert torch.equal(moe.router_bias, want)
    assert set(moe.router_bias.unique().tolist()) <= {
        -float(gamma), 0.0, float(gamma)}
    assert int(moe.step_load.sum()) == 0
    # the next routing reads the moved bias, as the reference does
    ref = ref_step(mc)
    r = moe.route(x, seq_len=16)
    assert torch.equal(r.experts, ref.route(moe.router.detach(), x,
                                            moe.router_bias, 16)[0])
    zero = ref.route(moe.router.detach(), x, torch.zeros(64), 16)[0]
    assert not torch.equal(r.experts, zero)


# ---------------------------------------------------------------- YaRN ---

def test_yarn_against_its_closed_form():
    y = Yarn(40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    assert y.correction_range(64, 10_000.0) == (10, 23)
    got = rope_frequencies(64, 10_000.0, yarn=y).double()
    i = torch.arange(32, dtype=torch.float64)
    plain = 10_000.0 ** (-2 * i / 64)
    ramp = torch.clamp((i - 10) / 13, 0, 1)
    torch.testing.assert_close(got, plain * (1 - ramp) + plain / 40 * ramp,
                               rtol=2e-6, atol=0)
    # below the ramp, the plain rope's frequencies exactly
    assert torch.equal(got[:11].float(), rope_frequencies(64, 10_000.0)[:11])
    assert y.attention_factor == 1.0
    want = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert want == pytest.approx(0.135234, abs=5e-7)
    mla = MLA(MLAConfig(d_model=64, n_heads=2, yarn=y), device="meta",
              dtype=torch.float32)
    assert mla._scale() == pytest.approx(want, rel=1e-12)
    m = dataclasses.asdict(get_config(ARCH))
    assert lm_mla.softmax_scale(m) == pytest.approx(want, rel=1e-12)
    torch.testing.assert_close(lm_mla.yarn_inv_freq(m),
                               rope_frequencies(64, 10_000.0, yarn=y),
                               rtol=0, atol=0)
    # no YaRN: the plain table and scale
    assert torch.equal(rope_frequencies(64, 1e4), 1.0 / 1e4 ** (
        torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    plain_mla = MLA(MLAConfig(d_model=64, n_heads=2), device="meta",
                    dtype=torch.float32)
    assert plain_mla._scale() == 1.0 / math.sqrt(192)


def _smoke_model(cfg, seed=0):
    """The port's model of `cfg` with the driver's draw of weights, and
    the reference's float32 copy of them."""
    m = dataclasses.asdict(cfg)
    model = DecoderLM(cfg, device="cpu")
    params = dict(model.named_parameters())
    ref = {}
    with torch.no_grad():
        for name, w in lm_train_mla.make_weights(m, seed, torch.device("cpu")):
            params[lm_train_mla.port_name(name, cfg.n_prefix)].copy_(w)
            ref[name] = w.float().clone()
    return model, ref, m


def test_prefill_then_absorbed_decode_equal_the_forward():
    # a capacity that drops nothing, so a decode step routes as the forward
    cfg = smoke(capacity_factor=16 / 4)
    model, _, _ = _smoke_model(cfg, seed=3)
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, _ = forward(model, cfg, tokens)
        state = init_decode_state(cfg, 2, 16, device="cpu")
        for t in range(12):
            got, state = decode_step(model, cfg, state, tokens[:, t:t + 1], t)
            torch.testing.assert_close(got[:, 0], want[:, t], rtol=1e-4,
                                       atol=1e-4)


# ------------------------------------------------------------- the share ---

def test_the_shares_add_up_to_the_uncut_layer():
    """32 shares of 2 experts each: their routed parts, plus the shared
    expert counted once, equal the reference's layer with all 64 held."""
    whole = make_moe(moe_cfg(), seed=5)
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(6))
    xt = x.reshape(-1, 32)
    total = whole.shared(xt)
    with torch.no_grad():
        for share in range(32):
            part = pmoe.MoE(moe_cfg(n_experts=2, held_offset=2 * share),
                            device="cpu", dtype=torch.float32)
            for name, p in part.named_parameters():
                w = getattr(whole, name)
                p.copy_(w[2 * share:2 * share + 2]
                        if name in ("wi", "wg", "wo") else w)
            total = total + part.routed(xt, seq_len=32)[0]
        ref = ref_step(whole.cfg)
        experts, gates, _, _ = ref.route(whole.router, xt, whole.router_bias,
                                         32)
        want, (held, dropped) = ref.routed(xt, experts, gates, whole.wi,
                                           whole.wg, whole.wo, 0)
        want = want + lm_mla.swiglu(ref.arith, xt, whole.shared_wi,
                                    whole.shared_wg, whole.shared_wo)
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)
        y, _ = whole(x)
        torch.testing.assert_close(y.reshape(-1, 32), want, rtol=1e-5,
                                   atol=1e-6)
    assert held == 64 * 8 and dropped > 0


# ------------------------------------------------------ a training step ---

def test_a_large_leaf_updated_in_slices_equals_the_whole(monkeypatch):
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(9)
    params = {"w": torch.randn(37, 64, generator=gen).bfloat16(),
              "b": torch.randn(64, generator=gen)}
    grads = [{n: torch.randn(p.shape, generator=gen).to(p.dtype)
              for n, p in params.items()} for _ in range(2)]
    cfg = AdamWConfig(lr=1e-2)
    runs = []
    for limit in (adamw.SLICE_ELEMENTS, 5 * 64):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", limit)
        p = {n: v.clone() for n, v in params.items()}
        st = adamw_init(p, cfg)
        for g in grads:
            adamw.adamw_update(st, p, g, cfg)
        runs.append((p, st))
    (p0, s0), (p1, s1) = runs
    for n in params:
        assert torch.equal(p0[n], p1[n])
        assert torch.equal(s0["mu"][n], s1["mu"][n])
        assert torch.equal(s0["nu"][n], s1["nu"][n])


def test_a_training_step_matches_the_reference():
    cfg = smoke(remat_policy="full", loss_chunk=16)
    model, p, m = _smoke_model(cfg, seed=7)
    step = lm_mla.Step(ref_cfg(cfg))
    biases = step.init_biases("cpu")
    gen = torch.Generator().manual_seed(8)
    batches = [torch.randint(0, cfg.vocab, (2, 32), generator=gen)
               for _ in range(2)]
    loss = loss_fn(model, cfg, batches[0], batches[0])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    pmoe.reset_routing_counters(model)
    for mod in model.modules():
        if isinstance(mod, pmoe.MoE):
            mod.step_load.zero_()
    want_loss, want = step.grads(p, biases, batches[0], batches[0])
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    assert len(want) == len(names)
    for n, g in want.items():
        torch.testing.assert_close(grads[lm_train_mla.port_name(
            n, cfg.n_prefix)], g, rtol=1e-4, atol=1e-6)
    # two steps of AdamW and the bias update, through make_train_step
    opt_cfg = AdamWConfig(lr=OPT["peak_lr"], b1=OPT["b1"], b2=OPT["b2"],
                          eps=OPT["eps"], weight_decay=OPT["weight_decay"],
                          clip_norm=OPT["clip_norm"])
    opt = adamw_init(dict(model.named_parameters()), opt_cfg,
                     stacked_layers(model))
    train = make_train_step(cfg, opt_cfg, TrainLoopConfig(
        total_steps=OPT["total_steps"], warmup_steps=OPT["warmup_steps"],
        peak_lr=OPT["peak_lr"]))
    losses = []
    for i, b in enumerate(batches):
        model, opt, loss = train(model, opt, {"tokens": b, "targets": b}, i)
        losses.append(float(loss))
    ref_losses = [float(lo) for lo, _, _ in step.train(
        p, biases, [(b, b) for b in batches])]
    assert losses == pytest.approx(ref_losses, rel=1e-6)
    params = dict(model.named_parameters())
    for n, v in p.items():
        torch.testing.assert_close(
            params[lm_train_mla.port_name(n, cfg.n_prefix)].detach(), v,
            rtol=1e-4, atol=1e-6)
    buffers = dict(model.named_buffers())
    for layer, b in biases.items():
        got = buffers[lm_train_mla.port_name(
            f"layers.{layer}.moe.router_bias", cfg.n_prefix)]
        assert torch.equal(got, b)
        assert b.abs().max() > 0
    counts = pmoe.routing_counters(model)
    assert [sum(row) for row in counts["loads"]] == [2 * 2 * 32 * 4] * 2


def test_a_resumed_run_routes_as_the_run_that_never_stopped(tmp_path):
    """Stopped after step 2 and resumed from its checkpoint, a run gives
    the losses and router biases of the run that went on, bit for bit:
    the checkpoint holds the biases beside the parameters."""
    cfg = smoke(bias_update_rate=0.05)

    def run(ckpt_dir, **kw):
        loop = TrainLoopConfig(total_steps=4, ckpt_dir=str(ckpt_dir),
                               ckpt_every=100, warmup_steps=1, peak_lr=1e-2)
        return run_training(cfg, loop=loop, device="cpu", global_batch=2,
                            seq_len=16, **kw)

    whole = run(tmp_path / "whole")
    first = run(tmp_path / "cut", stop_after=2)
    rest = run(tmp_path / "cut")
    assert rest["resumed"] and rest["first_step"] == 2
    assert first["losses"] + rest["losses"] == whole["losses"]
    want, got = router_biases(whole["params"]), router_biases(rest["params"])
    assert len(want) == cfg.n_periods
    assert all(torch.equal(got[n], b) for n, b in want.items())
    assert all(b.abs().max() > 0 for b in want.values())
    # the tree lists them only where the model has them
    assert "router_bias" in train_state(whole["params"], {
        "step": 0, "mu": {}, "nu": {}}, spec=True)
    plain = DecoderLM(get_smoke_config("granite-moe-1b-a400m"),
                      device="cpu")
    assert "router_bias" not in train_state(plain, {
        "step": 0, "mu": {}, "nu": {}}, spec=True)

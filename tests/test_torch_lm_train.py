"""The port's LM loss and its gradients on the CPU against the JAX
package's: ``loss_fn`` against ``jax.value_and_grad`` on the smoke configs
of qwen3 (both heads), qwen1.5 and mistral-nemo, the remat policies, the
``loghd_head`` autograd Function and the ``Model`` facade
(``test_torch_lm_train_archs.py`` has gemma3, the frontend stubs and the
chunked cross-entropy).  Weights are carried by
``repro_torch.models.convert``; the reference runs under ``jax.jit``
(eagerly every op compiles on its own); float32, ``device="cpu"``.

Tolerances:
  * losses: rtol 1e-5 (measured within 1e-6: the two packages sum their
    matmuls in different orders);
  * gradients: each leaf within GRAD_RTOL of its largest magnitude
    (measured within 2e-5);
  * the ``loghd_head`` backward against autograd through the plain
    version: rtol 1e-5 in float32, one bfloat16 rounding (2^-8 of a value)
    in bfloat16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import one_thread  # noqa: F401 (a fixture)

from repro import configs as rconfigs
from repro.models import model as R
from repro_torch import configs as pconfigs
from repro_torch.kernels.loghd_head import (loghd_head_autograd,
                                            loghd_head_logits_ref)
from repro_torch.models import model as P
from repro_torch.models.convert import from_reference, unstack_tree
from repro_torch.runtime import train_loop as PT

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# scales and biases the reference initialises to zero, drawn here so that
# qk-norm, the norms' (1 + scale) and the QKV bias get gradients that
# depend on them
_PERTURBED = ("ln1", "ln2", "final_norm", "qnorm", "knorm", "bq", "bk", "bv")


def _cfgs(arch: str, smoke: bool = True, **over):
    get = "get_smoke_config" if smoke else "get_config"
    return (dataclasses.replace(getattr(rconfigs, get)(arch), **over),
            dataclasses.replace(getattr(pconfigs, get)(arch), **over))


def _ref_params(cfg, seed: int = 0, perturb: bool = True):
    rng = np.random.default_rng(seed)
    params = R.init_params(jax.random.PRNGKey(seed), cfg)
    if not perturb:
        return params

    def draw(path, x):
        if getattr(path[-1], "key", None) in _PERTURBED:
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


def _pair(arch: str, seed: int = 0, **over):
    rc, pc = _cfgs(arch, **over)
    params = _ref_params(rc, seed)
    return rc, pc, params, from_reference(jax.tree.map(np.asarray, params),
                                          pc, device="cpu")


def _tokens(vocab: int, b: int, s: int, seed: int):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _ref_value_and_grad(rc, params, tokens, targets, emb=None):
    fn = jax.jit(jax.value_and_grad(lambda p, t, y, e: R.loss_fn(
        p, rc, t, y, embeddings=e)))
    loss, grads = fn(params, None if tokens is None else jnp.asarray(tokens),
                     jnp.asarray(targets),
                     None if emb is None else jnp.asarray(emb))
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(pc, model, tokens, targets, emb=None):
    model.zero_grad(set_to_none=True)
    loss = P.loss_fn(model, pc, None if tokens is None
                     else torch.from_numpy(tokens), torch.from_numpy(targets),
                     embeddings=None if emb is None
                     else torch.from_numpy(emb))
    loss.backward()
    # a parameter the loss does not reach (the embedding table under
    # embeddings=) has no gradient: the reference's is zeros
    return loss.item(), {n: torch.zeros_like(p) if p.grad is None
                         else p.grad.clone()
                         for n, p in model.named_parameters()}


def _assert_grads(got: dict, ref_tree: dict, model, unused=()):
    """Each gradient within GRAD_RTOL of the reference's largest; every one
    nonzero but those of `unused` parameters, which are zero in both."""
    want = unstack_tree(ref_tree, model)
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = np.asarray(want[name])
        assert g.shape == w.shape, name
        if name in unused:
            assert not w.any() and not g.any(), name
            continue
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


# ---------------------------------------------------------- loss, grads ---

@pytest.mark.parametrize("arch,head,emb", [
    ("qwen3-1.7b", "dense", False), ("qwen3-1.7b", "loghd", False),
    ("qwen1.5-4b", "dense", False), ("mistral-nemo-12b", "dense", False)])
def test_loss_and_grads_match_reference(arch, head, emb):
    """Every ported mixer and both heads; chameleon's and musicgen's
    frontend stubs through ``embeddings=``."""
    rc, pc, params, model = _pair(arch, head=head)
    s = 2 * rc.local_window if arch.startswith("gemma") else 16
    targets = _tokens(rc.vocab, 2, s, seed=2)
    if emb:
        x = (0.02 * np.random.default_rng(3).standard_normal(
            (2, s, rc.d_model))).astype(np.float32)
        tokens = None
    else:
        x, tokens = None, _tokens(rc.vocab, 2, s, seed=1)
    want, ref_grads = _ref_value_and_grad(rc, params, tokens, targets, x)
    got, grads = _port_value_and_grad(pc, model, tokens, targets, x)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_grads(grads, ref_grads, model,
                  unused=("embed.table",) if emb else ())


@pytest.mark.parametrize("arch,periods", [
    ("jamba-v0.1-52b", 4), ("xlstm-125m", 4), ("deepseek-v3-671b", 8),
    ("granite-moe-1b-a400m", 8)])
def test_unported_mixers_raise(arch, periods, tmp_path, one_thread):
    """The four configs that raised until their mixers and MoE ffn were
    ported now train (the test keeps its name): with int8 AdamW moments
    (block 32) each moment is int8 exactly where the reference's
    ``adamw_init`` makes it int8 on the stacked leaf (the depths are
    chosen so that stacked expert, mLSTM and Mamba leaves reach 65,536
    elements while one layer's do not), and ``run_training`` takes two
    steps with finite losses and commits its checkpoint."""
    from repro.optim import adamw as RA
    from repro_torch.models.convert import stacked_layers, to_reference
    from repro_torch.optim import adamw as PA
    _, pc = _cfgs(arch, n_periods=periods)
    model = P.init_params(pc, seed=0, device="cpu")
    pcfg = PA.AdamWConfig(moment_dtype="int8", block=32)
    ps = PA.adamw_init(dict(model.named_parameters()), pcfg,
                       stacked_layers(model))
    rs = RA.adamw_init(jax.tree.map(jnp.asarray, to_reference(model)),
                       RA.AdamWConfig(moment_dtype="int8", block=32))
    want = unstack_tree(rs["mu"], model)
    int8 = {n for n, m in ps["mu"].items() if isinstance(m, dict)}
    assert int8 == {n for n, m in want.items() if isinstance(m, dict)}
    assert any(".moe.w" in n or ".mlstm.w" in n or ".mamba.in_proj" in n
               for n in int8)
    # some are int8 only as a stack: one layer alone is too small
    assert any(not PA.int8_eligible(p.shape, 32)
               for n, p in model.named_parameters() if n in int8)
    out = PT.run_training(pc, device="cpu", opt_cfg=pcfg, params=model,
                          loop=PT.TrainLoopConfig(total_steps=2,
                                                  ckpt_dir=str(tmp_path)))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert PT.latest_step(str(tmp_path)) == 2


# ------------------------------------------------------------------ remat ---

class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_equal_gradients(policy):
    """"full" and "dots" recompute each block in the backward (every block
    runs twice) and give the gradients of "none" bit for bit; "dots" keeps
    the weight products, so its backward recomputes none of them while
    "full" recomputes all.  The policy is the model's config's: each
    policy gets its own copy of the same weights."""
    _, pc, _, model = _pair("qwen3-1.7b", head="loghd")
    _, pc_remat, _, remat = _pair("qwen3-1.7b", head="loghd",
                                  remat_policy=policy)
    tokens = _tokens(pc.vocab, 2, 16, seed=7)
    targets = _tokens(pc.vocab, 2, 16, seed=8)
    _, want = _port_value_and_grad(pc, model, tokens, targets)
    runs = []
    real = P.Block.forward

    def counted(self, x, rope):
        runs.append(1)
        return real(self, x, rope)
    P.Block.forward = counted
    try:
        loss = P.loss_fn(remat, pc_remat, torch.from_numpy(tokens),
                         torch.from_numpy(targets))
        forward_runs = len(runs)
        with _CountMM() as mode:
            loss.backward()
    finally:
        P.Block.forward = real
    n_blocks = pc.n_periods * len(pc.pattern)
    assert forward_runs == n_blocks and len(runs) == 2 * n_blocks
    for name, p in remat.named_parameters():
        assert torch.equal(p.grad, want[name]), name
    if policy == "full":
        assert mode.mm > 0
    else:
        # the backward's own products only: recomputation adds none
        model.zero_grad(set_to_none=True)
        loss = P.loss_fn(model, pc, torch.from_numpy(tokens),
                         torch.from_numpy(targets))
        with _CountMM() as plain:
            loss.backward()
        assert mode.mm == plain.mm


def test_unknown_remat_policy_raises():
    _, pc, _, model = _pair("qwen3-1.7b", remat_policy="some")
    with pytest.raises(ValueError, match="remat_policy"):
        P.loss_fn(model, pc, torch.zeros((1, 4), dtype=torch.long),
                  torch.zeros((1, 4), dtype=torch.long))


def test_loss_takes_the_remat_policy_from_the_model():
    """A config that differs from the model's in ``loss_chunk`` alone is
    the model's; one that differs in ``remat_policy`` is not."""
    _, pc, _, model = _pair("qwen3-1.7b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    P.loss_fn(model, dataclasses.replace(pc, loss_chunk=2), tokens, tokens)
    with pytest.raises(ValueError, match="params were built for"):
        P.loss_fn(model, dataclasses.replace(pc, remat_policy="full"),
                  tokens, tokens)


# -------------------------------------------------- loghd_head gradient ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loghd_head_backward_matches_autograd_through_plain(dtype):
    g = torch.Generator().manual_seed(11)
    b, d, n, v = 6, 32, 5, 40
    leaves = [(torch.randn(shape, generator=g) * scale).to(dtype)
              for shape, scale in (((b, d), 1.0), ((n, d), d ** -0.5),
                                   ((v, n), 0.05))]
    up = torch.randn((b, v), generator=g)
    got_in = [t.clone().requires_grad_() for t in leaves]
    ref_in = [t.clone().requires_grad_() for t in leaves]
    got = loghd_head_autograd(*got_in)
    want = loghd_head_logits_ref(*ref_in)
    assert torch.equal(got, want) and got.grad_fn is not None
    got.backward(up)
    want.backward(up)
    for a, r in zip(got_in, ref_in):
        assert a.grad.dtype == dtype
        scale = float(r.grad.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(a.grad, r.grad, rtol=1e-5,
                                       atol=1e-6 * scale)
        else:
            torch.testing.assert_close(a.grad.float(), r.grad.float(),
                                       rtol=2 ** -8, atol=2 ** -8 * scale)


def test_loghd_head_without_grad_keeps_nothing():
    g = torch.Generator().manual_seed(12)
    h, m, p = (torch.randn(s, generator=g) for s in ((3, 8), (4, 8), (9, 4)))
    with torch.no_grad():
        out = loghd_head_autograd(h, m.requires_grad_(), p)
    assert out.grad_fn is None
    assert loghd_head_autograd(h, m.detach(), p).grad_fn is None
    assert torch.equal(out, loghd_head_logits_ref(h, m, p))


def test_model_loss_facade():
    _, pc, _, model = _pair("qwen3-1.7b", head="loghd")
    tok, tgt = (torch.from_numpy(_tokens(pc.vocab, 2, 8, s)) for s in (1, 2))
    facade = P.Model(pc, device="cpu")
    assert torch.equal(facade.loss(model, tok, tgt),
                       P.loss_fn(model, pc, tok, tgt))



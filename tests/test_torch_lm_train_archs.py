"""The port's LM loss and its gradients on the CPU against the JAX
package's, continued from ``test_torch_lm_train.py``: gemma3 (local and
global attention) under the loghd head, chameleon's and musicgen's
frontend stubs through ``embeddings=``, and the sequence-chunked
cross-entropy.  Same weights, reference and tolerances as there.

Tolerances:
  * losses: rtol 1e-5 (measured within 1e-6: the two packages sum their
    matmuls in different orders);
  * gradients: each leaf within GRAD_RTOL of its largest magnitude
    (measured within 2e-5);
  * the chunked loss against the unchunked one: rtol 1e-6 (only the
    float32 order of the NLL's sum differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as R
from repro_torch import configs as pconfigs
from repro_torch.models import model as P
from repro_torch.models.convert import from_reference, unstack_tree

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


@pytest.mark.parametrize("arch,head,emb", [
    ("gemma3-4b", "loghd", False), ("chameleon-34b", "dense", True),
    ("musicgen-large", "dense", True)])
def test_loss_and_grads_match_reference(arch, head, emb):
    """gemma3's local and global attention under the loghd head;
    chameleon's and musicgen's frontend stubs through ``embeddings=``."""
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


@pytest.mark.parametrize("head", ["dense", "loghd"])
def test_chunked_ce_matches_unchunked_and_reference(head):
    """loss_chunk = 8 at S = 32: four checkpointed chunks; the loss and
    every gradient equal the unchunked ones within float32 summation order
    and the reference's chunked loss_fn within the module's tolerances."""
    rc, pc, params, model = _pair("qwen3-1.7b", head=head, loss_chunk=8)
    tokens = _tokens(rc.vocab, 2, 32, seed=5)
    targets = _tokens(rc.vocab, 2, 32, seed=6)
    got, grads = _port_value_and_grad(pc, model, tokens, targets)
    whole, whole_grads = _port_value_and_grad(
        dataclasses.replace(pc, loss_chunk=0), model, tokens, targets)
    np.testing.assert_allclose(got, whole, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, whole_grads[name], rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
    want, ref_grads = _ref_value_and_grad(rc, params, tokens, targets)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_grads(grads, ref_grads, model)


def test_chunked_ce_runs_each_chunk_head_twice():
    """Under the checkpoint the head runs once a chunk in the forward and
    once more in the backward: the launches the card counts."""
    _, pc, _, model = _pair("qwen3-1.7b", head="loghd", loss_chunk=8)
    calls = []
    real = model.head.forward
    model.head.forward = lambda x: (calls.append(x.shape), real(x))[1]
    loss = P.loss_fn(model, pc, torch.from_numpy(_tokens(pc.vocab, 2, 32, 1)),
                     torch.from_numpy(_tokens(pc.vocab, 2, 32, 2)))
    assert len(calls) == 4
    loss.backward()
    assert calls == [(2, 8, pc.d_model)] * 8



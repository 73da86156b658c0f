"""The port's decoder LM on the four configs whose mixers or ffns came
with slice 12 (granite-moe: attn + MoE; deepseek-v3: MLA, a dense prefix
and MoE with a shared expert; jamba: Mamba, attention and MoE; xlstm:
mLSTM and sLSTM), against the JAX package's, at float32 smoke size under
both heads: ``forward`` (logits and the MoE aux loss), ``loss_fn`` and
every gradient (the loghd head in ``test_torch_lm_archs_loghd.py``), and
the serving and training launchers.
``test_torch_lm_archs_serve.py`` (decode and serving)
and ``test_torch_lm_archs_pins.py`` (the reference's own divergences, the
weight round trip, the initial weights) share this module's helpers.  Both packages hold the same weights:
the port's ``init_params`` with its zero norm scales and biases moved by
numpy draws, carried into the reference's tree by ``to_reference``.

Tolerances: logits and states rtol = atol = 1e-4 (as ``test_torch_lm.py``;
measured within 2.9e-5 here and in the decode tests, the Mamba scan's
reordered products included); losses rtol 1e-5 (measured within 1.6e-7);
each gradient within 1e-4 of its leaf's largest magnitude (as
``test_torch_lm_train.py``; measured within 2.5e-5).
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
from repro_torch.models.convert import (from_reference, to_reference,
                                        unstack_tree)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b", "jamba-v0.1-52b",
         "xlstm-125m")
# scales and biases the reference initialises to zero (or one), drawn here
# so that their gradients depend on them
_PERTURBED = ("ln1", "ln2", "final_norm", "q_a_norm", "kv_a_norm", "bz",
              "bi", "bf", "bo", "conv_b", "skip_w")


def _cfgs(arch: str, **over):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **over))


def pair(arch: str, seed: int = 0, **over):
    """(reference config, port config, reference params, port model with
    the same weights) for the smoke config of `arch` with `over`.  The
    weights are the port's ``init_params`` (the reference's eager init
    takes seconds a config; ``test_init_params_match_reference_in_
    distribution`` holds the two inits together) in the reference's
    layout, with the `_PERTURBED` leaves moved by N(0, 0.1^2) numpy
    draws."""
    rc, pc = _cfgs(arch, **over)
    rng = np.random.default_rng(seed)
    tree = to_reference(P.init_params(pc, seed=seed, device="cpu"))

    def perturb(path, x):
        if getattr(path[-1], "key", None) in _PERTURBED:
            return x + (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    model = from_reference(tree, pc, device="cpu")
    return rc, pc, jax.tree.map(jnp.asarray, tree), model


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def port_decode_all(pc, model, tokens: np.ndarray):
    """Teacher-forced decode over `tokens`: (logits (B, S, V), state)."""
    b, s = tokens.shape
    state = P.init_decode_state(pc, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, state = P.decode_step(model, pc, state,
                                  torch.from_numpy(tokens[:, t:t + 1]), t)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, axis=1), state


def ref_decode_all(rc, params, tokens: np.ndarray):
    b, s = tokens.shape
    step = jax.jit(lambda p, st, tok, pos: R.decode_step(p, rc, st, tok, pos))
    state = R.init_decode_state(rc, batch=b, max_len=s)
    outs = []
    for t in range(s):
        lg, state = step(params, state, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, axis=1), state


def ref_forward(rc, params, tokens: np.ndarray):
    logits, aux = jax.jit(lambda p, t: R.forward(p, rc, t))(
        params, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


def check_forward_loss_and_grads(arch: str, head: str) -> None:
    """Logits, the summed aux loss (nonzero exactly where the config has
    MoE blocks), the loss and every parameter's gradient."""
    rc, pc, params, model = pair(arch, head=head)
    tokens = _tokens(rc.vocab, 2, 8, seed=1)
    targets = _tokens(rc.vocab, 2, 8, seed=2)

    want, want_aux = ref_forward(rc, params, tokens)
    got, aux = P.forward(model, pc, torch.from_numpy(tokens))
    assert got.shape == (2, 8, rc.vocab) and got.dtype == torch.float32
    _close(got, want)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=LOSS_RTOL)
    assert (want_aux > 0) == (rc.n_experts > 0)

    loss, grads = jax.jit(jax.value_and_grad(lambda p, t, y: R.loss_fn(
        p, rc, t, y)))(params, jnp.asarray(tokens), jnp.asarray(targets))
    got_loss = P.loss_fn(model, pc, torch.from_numpy(tokens),
                         torch.from_numpy(targets))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    want_g = unstack_tree(jax.tree.map(np.asarray, grads), model)
    for name, p in model.named_parameters():
        w = np.asarray(want_g[name])
        scale = float(np.abs(w).max())
        assert p.grad is not None and scale > 0, name
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """``check_forward_loss_and_grads`` under the dense head (the loghd
    head: ``test_torch_lm_archs_loghd.py``, one file each to keep a file's
    run under a minute: the reference's gradient programs take 3-8 s each
    to trace and compile)."""
    check_forward_loss_and_grads(arch, "dense")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_the_cpu(arch, tmp_path, capsys):
    """``launch/serve.py`` and ``launch/train.py`` with ``--smoke --device
    cpu``: the served tokens are ``run_serving``'s on the seed's weights,
    and two training steps commit a checkpoint."""
    from repro_torch.launch import serve as pserve_cli
    from repro_torch.launch import train as ptrain_cli
    from repro_torch.runtime import serve_loop as pserve
    from repro_torch.runtime.train_loop import latest_step
    out = pserve_cli.main(["--arch", arch, "--smoke", "--requests", "2",
                           "--max-new", "3", "--device", "cpu"])
    assert "served 2 requests, 8 tokens" in capsys.readouterr().out
    _, pc = _cfgs(arch)
    want = pserve.run_serving(pc, P.init_params(pc, seed=0, device="cpu"),
                              pserve_cli.requests_for(pc, 2, seed=0),
                              pserve.ServeLoopConfig(max_new_tokens=3))
    for uid in want:
        np.testing.assert_array_equal(out[uid], want[uid])
    res = ptrain_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                           "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "ck")])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert latest_step(str(tmp_path / "ck")) == 2


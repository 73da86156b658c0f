"""The port's decoder LM and serving loop on the CPU against the JAX
package's: configs, layers, attention, ``forward`` / ``decode_step`` with
weights carried by ``repro_torch.models.convert``, greedy ``run_serving``,
and the reference's decode-order divergence, all at float32 on smoke
configs (the loghd head's bfloat16 behaviour is tested at kernel level in
``test_torch_lm_head.py``).

Tolerance of model-level parity: rtol = atol = 1e-4 on float32 logits
(the two packages sum their matmuls in different orders; the largest
difference seen is about 2e-5 on logits of magnitude 30), and 2e-3 where
decode is held against forward, the reference's own bound
(``tests/test_arch_smoke.py:93``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as R
from repro.runtime import serve_loop as rserve
from repro_torch import configs as pconfigs
from repro_torch.launch import serve as pserve_cli
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import model as P
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.runtime import serve_loop as pserve

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
# scales and biases the reference initialises to zero, drawn here so that
# qk-norm, the norms' (1 + scale) and the QKV bias are exercised
_PERTURBED = ("ln1", "ln2", "final_norm", "qnorm", "knorm", "bq", "bk", "bv")


def _cfgs(arch: str, **over):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **over))


def _ref_params(cfg, seed: int = 0):
    """The reference's init_params with its zero scales and biases
    replaced by N(0, 0.1^2) draws from numpy."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = getattr(path[-1], "key", None)
        if name in _PERTURBED:
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(
        perturb, R.init_params(jax.random.PRNGKey(seed), cfg))


def _pair(arch: str, seed: int = 0, **over):
    rc, pc = _cfgs(arch, **over)
    params = _ref_params(rc, seed)
    model = from_reference(jax.tree.map(np.asarray, params), pc, device="cpu")
    return rc, pc, params, model


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _ref_decode(rc):
    return jax.jit(lambda p, st, tok, pos: R.decode_step(p, rc, st, tok, pos))


def _port_decode_all(pc, model, tokens: np.ndarray) -> np.ndarray:
    b, s = tokens.shape
    state = P.init_decode_state(pc, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, state = P.decode_step(model, pc, state,
                                  torch.from_numpy(tokens[:, t:t + 1]), t)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, axis=1)


def _ref_decode_all(rc, params, tokens: np.ndarray) -> np.ndarray:
    b, s = tokens.shape
    step = _ref_decode(rc)
    state = R.init_decode_state(rc, batch=b, max_len=s)
    outs = []
    for t in range(s):
        lg, state = step(params, state, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, axis=1)


# ---------------------------------------------------------------- configs ---

@pytest.mark.parametrize("arch", rconfigs.ARCH_NAMES)
def test_configs_equal_the_reference(arch):
    assert pconfigs.ARCH_NAMES == rconfigs.ARCH_NAMES
    for getter in ("get_config", "get_smoke_config"):
        got = getattr(pconfigs, getter)(arch)
        want = getattr(rconfigs, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_layers == want.n_layers
        assert got.loghd_bundles == want.loghd_bundles
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    for name, spec in rconfigs.SHAPES.items():
        assert dataclasses.asdict(pconfigs.SHAPES[name]) == \
            dataclasses.asdict(spec)


def test_qwen3_loghd_width():
    cfg = dataclasses.replace(pconfigs.get_config("qwen3-1.7b"), head="loghd")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (28, 2048, 16, 8, 128,
                                                   6144, 151936)
    assert cfg.loghd_bundles == 20 and cfg.dtype == "bfloat16"
    assert cfg.param_count() == 1_723_530_752


# ----------------------------------------------------------------- layers ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    got = players.rms_norm(xt, torch.from_numpy(s))
    want = rlayers.rms_norm(xj, jnp.asarray(s))
    assert got.dtype == xt.dtype
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7))
    got = players.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                              theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gated_mlp_matches():
    params = rlayers.init_gated_mlp(jax.random.PRNGKey(0), 32, 48,
                                    jnp.float32)
    mlp = players.GatedMLP(32, 48, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mlp, k).copy_(torch.from_numpy(np.array(v)))
    x = np.random.default_rng(2).standard_normal((3, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        mlp(torch.from_numpy(x)).detach().numpy(),
        np.asarray(rlayers.gated_mlp(params, jnp.asarray(x))), **TOL)


# -------------------------------------------------------------- attention ---

def _attn_pair(arch: str, mixer: str):
    rc, _ = _cfgs(arch)
    blk = next(b for b in rc.prefix_pattern + rc.pattern if b.mixer == mixer)
    acfg = R._mixer_cfg(rc, blk)
    params = _ref_params(rc)["body"][
        list(rc.pattern).index(blk)]["attn"]
    params = jax.tree.map(lambda a: a[0], params)     # period 0
    mod = pattn.Attention(pattn.AttnConfig(**dataclasses.asdict(acfg)),
                          device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    return acfg, params, mod


@pytest.mark.parametrize("arch,mixer,s", [
    ("qwen3-1.7b", "attn", 12),          # GQA, qk-norm
    ("qwen1.5-4b", "attn", 12),          # MHA, QKV bias
    ("gemma3-4b", "attn_local", 64),     # banded: S = 2 x local_window
    ("gemma3-4b", "attn", 64),
])
def test_attention_forward_and_decode_match(arch, mixer, s):
    acfg, params, mod = _attn_pair(arch, mixer)
    b, d = 2, acfg.d_model
    x = np.random.default_rng(3).standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want = rattn.attention(params, acfg, jnp.asarray(x),
                           jnp.asarray(pos, jnp.int32))
    tpos = torch.from_numpy(pos.copy())
    rope = players.rope_table(tpos, acfg.head_dim, acfg.rope_theta)
    got = mod(torch.from_numpy(x), rope)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    # decode, each slot at its own position (slot 1 runs 3 ahead), against
    # the reference's per-slot decode_attention
    cache_r = rattn.init_kv_cache(acfg, b, s, jnp.float32)
    cache_p = pattn.init_kv_cache(mod.cfg, b, s, torch.float32, "cpu")
    step = jax.jit(lambda c, xt, p_: rattn.decode_attention(params, acfg, xt,
                                                            c, p_))
    for t in range(s - 3):
        p_ = np.array([t, t + 3])
        xt = x[:, t:t + 1]
        want, cache_r = step(cache_r, jnp.asarray(xt),
                             jnp.asarray(p_, jnp.int32))
        tp = torch.from_numpy(p_)
        where = pattn.DecodeIndex.of(tp, cache_p["k"].shape[2],
                                     mod.cfg.window is not None)
        with torch.no_grad():
            got = mod.decode(torch.from_numpy(xt), cache_p["k"][0],
                             cache_p["v"][0],
                             players.rope_table(tp[:, None], acfg.head_dim,
                                                acfg.rope_theta), where)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache_p["k"][0].numpy(),
                               np.asarray(cache_r["k"]), **TOL)


# ------------------------------------------------------------------ model ---

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen1.5-4b", "gemma3-4b"])
@pytest.mark.parametrize("head", ["dense", "loghd"])
def test_forward_and_decode_match_reference(arch, head):
    rc, pc, params, model = _pair(arch, head=head)
    s = 2 * rc.local_window if arch.startswith("gemma") else 12
    tokens = _tokens(rc, 2, s)
    want, _ = jax.jit(lambda p, t: R.forward(p, rc, t))(params,
                                                         jnp.asarray(tokens))
    got, aux = P.forward(model, pc, torch.from_numpy(tokens))
    assert got.shape == (2, s, rc.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    last = P.prefill(model, pc, torch.from_numpy(tokens))
    np.testing.assert_array_equal(last.detach().numpy(),
                                  got[:, -1:].detach().numpy())
    # every teacher-forced decode step against the reference's
    np.testing.assert_allclose(_port_decode_all(pc, model, tokens),
                               _ref_decode_all(rc, params, tokens), **TOL)


def test_embeddings_input_matches_reference():
    """The frontend-stub path (chameleon's vlm): `embeddings=` in place of
    tokens, through forward and decode."""
    rc, pc, params, model = _pair("chameleon-34b")
    emb = (0.02 * np.random.default_rng(4).standard_normal(
        (2, 6, rc.d_model))).astype(np.float32)
    want, _ = R.forward(params, rc, None, embeddings=jnp.asarray(emb))
    got, _ = P.forward(model, pc, embeddings=torch.from_numpy(emb))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    rs = R.init_decode_state(rc, batch=2, max_len=6)
    ps = P.init_decode_state(pc, 2, 6, device="cpu")
    want, _ = R.decode_step(params, rc, rs, None, jnp.asarray(0, jnp.int32),
                            embeddings=jnp.asarray(emb[:, :1]))
    got, _ = P.decode_step(model, pc, ps, None, 0,
                           embeddings=torch.from_numpy(emb[:, :1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head", ["dense", "loghd"])
def test_decode_reproduces_forward_qwen3(head):
    _, pc = _cfgs("qwen3-1.7b", head=head)
    model = P.init_params(pc, seed=2, device="cpu")
    tokens = _tokens(pc, 2, 16, seed=2)
    want, _ = P.forward(model, pc, torch.from_numpy(tokens))
    np.testing.assert_allclose(_port_decode_all(pc, model, tokens),
                               want.detach().numpy(), **DECODE_TOL)


def test_decode_order_divergence_is_the_reference_s():
    """gemma3 smoke with two periods of its 6-block pattern: the reference
    walks the body period-major in forward (model.py:238-245) and
    position-major in decode_step (model.py:389-396), so teacher-forced
    decode is another network.  The port reproduces each order: its
    forward equals the reference's forward, its decode the reference's
    decode, and the two differ in both packages."""
    rc, pc, params, model = _pair("gemma3-4b", n_periods=2)
    tokens = _tokens(rc, 2, 8)
    want_fwd, _ = jax.jit(lambda p, t: R.forward(p, rc, t))(
        params, jnp.asarray(tokens))
    want_fwd = np.asarray(want_fwd)
    want_dec = _ref_decode_all(rc, params, tokens)
    got_fwd = P.forward(model, pc, torch.from_numpy(tokens))[0]
    got_fwd = got_fwd.detach().numpy()
    got_dec = _port_decode_all(pc, model, tokens)
    np.testing.assert_allclose(got_fwd, want_fwd, **TOL)
    np.testing.assert_allclose(got_dec, want_dec, **TOL)
    assert np.abs(want_dec - want_fwd).max() > 0.1
    assert np.abs(got_dec - got_fwd).max() > 0.1


def test_weight_conversion_round_trips():
    for arch, over in (("gemma3-4b", {}), ("qwen1.5-4b", {"head": "loghd"}),
                       ("qwen3-1.7b", {"dtype": "bfloat16"})):
        rc, pc = _cfgs(arch, **over)
        tree = jax.tree.map(np.asarray,
                            R.init_params(jax.random.PRNGKey(5), rc))
        back = to_reference(from_reference(tree, pc, device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        model = P.init_params(pc, seed=1, device="cpu")
        again = from_reference(to_reference(model), pc, device="cpu")
        for (n, a), (_, b) in zip(model.named_parameters(),
                                  again.named_parameters()):
            assert a.dtype == b.dtype and torch.equal(a, b), n
    rc, pc = _cfgs("qwen3-1.7b")
    tree = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0), rc))
    del tree["body"][0]["mlp"]["wo"]
    with pytest.raises(ValueError, match="lacks"):
        from_reference(tree, pc, device="cpu")


def test_init_params_scales_match_reference_in_distribution():
    """Same leaves, shapes and dtypes as the reference's init_params; the
    draws differ (torch.Generator, not threefry), so each leaf's std is
    held to the reference's within 10% and its mean near 0; norm scales
    and biases are zero in both."""
    for arch, head in (("qwen1.5-4b", "dense"), ("qwen3-1.7b", "loghd")):
        rc, pc = _cfgs(arch, head=head)
        want = jax.tree.map(np.asarray,
                            R.init_params(jax.random.PRNGKey(0), rc))
        got = to_reference(P.init_params(pc, seed=0, device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        paths = jax.tree_util.tree_flatten_with_path(want)[0]
        for (path, w), g in zip(paths, jax.tree.leaves(got)):
            name = jax.tree_util.keystr(path)
            assert g.shape == w.shape, name
            if not w.any():
                assert not g.any(), name
                continue
            assert abs(g.std() / w.std() - 1) < 0.1, name
            assert abs(g.mean()) < 4 * w.std() / np.sqrt(w.size), name
    model = P.init_params(pc, seed=0, device="cpu")
    assert model.embed.table.dtype == torch.float32         # smoke dtype
    assert model.head.profiles.shape == (pc.vocab, pc.loghd_bundles)
    # a seed gives one backbone under both heads
    dense = P.init_params(dataclasses.replace(pc, head="dense"), seed=0,
                          device="cpu")
    assert torch.equal(dense.body[0][1].mlp.wo, model.body[0][1].mlp.wo)


def test_unknown_mixer_raises_and_params_check():
    """Every shipped config builds; an unknown mixer raises ValueError, as
    the reference's ``_mixer_cfg`` does; params built for one config
    refuse another."""
    for arch in pconfigs.ARCH_NAMES:
        P.init_params(pconfigs.get_smoke_config(arch), device="cpu")
    rc, pc = _cfgs("qwen3-1.7b", pattern=(rconfigs.BlockSpec("conv"),))
    with pytest.raises(ValueError, match="conv"):
        R.init_params(jax.random.PRNGKey(0), rc)
    with pytest.raises(ValueError, match="unknown mixer 'conv'"):
        P.init_params(dataclasses.replace(
            pc, pattern=(pconfigs.BlockSpec("conv"),)), device="cpu")
    _, pc = _cfgs("qwen3-1.7b")
    model = P.init_params(pc, device="cpu")
    with pytest.raises(ValueError, match="params were built for"):
        P.forward(model, dataclasses.replace(pc, head="loghd"),
                  torch.zeros((1, 2), dtype=torch.int64))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _cfgs("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init_params(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init_decode_state(pc, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.Model(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference({}, pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve_cli.main(["--arch", "qwen3-1.7b", "--smoke"])
    model = P.Model(pc, device="cpu").init(seed=0)
    assert model.device.type == "cpu"
    assert P.init_decode_state(pc, 2, 8, device="cpu")["body"][0][
        "k"].device.type == "cpu"


# ---------------------------------------------------------------- serving ---

def _serve_both(rc, pc, params, model, reqs, serve_kw):
    want = rserve.run_serving(rc, params, [rserve.Request(r.uid, r.prompt)
                                           for r in reqs],
                              rserve.ServeLoopConfig(**serve_kw))
    got = pserve.run_serving(pc, model, reqs,
                             pserve.ServeLoopConfig(**serve_kw))
    assert got.keys() == want.keys()
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]))
    return got


def test_greedy_serving_equals_reference_with_empty_prompt():
    """tests/test_api.py::test_serving_loop_accepts_empty_prompt's shrunken
    qwen3, weights carried from the reference."""
    over = dict(vocab=64, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                d_ff=64, n_periods=1)
    rc, pc, params, model = _pair("qwen3-1.7b", **over)
    reqs = [pserve.Request(uid=0, prompt=np.zeros((0,), np.int32)),
            pserve.Request(uid=1, prompt=np.arange(3) % 64)]
    got = _serve_both(rc, pc, params, model, reqs,
                      dict(batch_slots=2, max_new_tokens=4, max_len=32))
    assert 1 <= len(got[0]) <= 4


def test_greedy_serving_equals_reference_loghd_head():
    """The launcher's traffic (6 requests, prompts of 3 + i mod 5 tokens,
    4 slots, 16 new tokens, max_len 256) on qwen3 smoke with the loghd
    head."""
    rc, pc, params, model = _pair("qwen3-1.7b", head="loghd")
    reqs = pserve_cli.requests_for(pc, 6, seed=0)
    got = _serve_both(rc, pc, params, model, reqs,
                      dict(batch_slots=4, max_new_tokens=16, max_len=256))
    # the prompt's own next token, then 16 generated (as the reference)
    assert all(len(v) == 17 for v in got.values())


def test_serving_stops_at_eos_and_max_len():
    rc, pc, params, model = _pair("qwen3-1.7b")
    reqs = pserve_cli.requests_for(pc, 3, seed=1)
    first = pserve.run_serving(pc, model, reqs,
                               pserve.ServeLoopConfig(max_new_tokens=8))
    eos = int(first[0][2])
    _serve_both(rc, pc, params, model, reqs,
                dict(batch_slots=2, max_new_tokens=8, eos_id=eos))
    out = _serve_both(rc, pc, params, model, reqs,
                      dict(batch_slots=2, max_new_tokens=50, max_len=12))
    assert all(len(r.prompt) + len(out[r.uid]) - 1 <= 11 for r in reqs)


def test_temperature_sampling_is_reproducible_per_seed():
    _, pc = _cfgs("qwen3-1.7b", head="loghd")
    model = P.init_params(pc, seed=3, device="cpu")
    reqs = pserve_cli.requests_for(pc, 5, seed=3)
    serve = pserve.ServeLoopConfig(batch_slots=3, max_new_tokens=12,
                                   temperature=1.0)
    a = pserve.run_serving(pc, model, reqs, serve, seed=7)
    b = pserve.run_serving(pc, model, reqs, serve, seed=7)
    c = pserve.run_serving(pc, model, reqs, serve, seed=8)
    greedy = pserve.run_serving(pc, model, reqs,
                                pserve.ServeLoopConfig(batch_slots=3,
                                                       max_new_tokens=12))
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid])
        assert len(a[uid]) == 13
        assert a[uid].min() >= 0 and a[uid].max() < pc.vocab
    assert any(not np.array_equal(a[u], c[u]) for u in a)
    assert any(not np.array_equal(a[u], greedy[u]) for u in a)


def test_launcher_runs_on_the_cpu(capsys):
    out = pserve_cli.main(["--arch", "qwen3-1.7b", "--smoke", "--requests",
                           "3", "--max-new", "4", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 5 for v in out.values())
    assert "served 3 requests, 15 tokens" in capsys.readouterr().out
    # the same stream and weights through run_serving directly
    _, pc = _cfgs("qwen3-1.7b")
    want = pserve.run_serving(pc, P.init_params(pc, seed=0, device="cpu"),
                              pserve_cli.requests_for(pc, 3, seed=0),
                              pserve.ServeLoopConfig(max_new_tokens=4))
    for uid in want:
        np.testing.assert_array_equal(out[uid], want[uid])

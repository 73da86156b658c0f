"""The port's MoE ffn and its MLA, Mamba, mLSTM and sLSTM mixers on the CPU
against the JAX package's, one module at a time, on the same numpy-seeded
inputs and the reference's own initial weights (copied leaf by leaf).

Tolerances (float32):
  * outputs and states: rtol = atol = 1e-4, as ``test_torch_lm.py`` holds
    logits (the packages sum their products in different orders; measured
    within 1.5e-6 here), except
  * the Mamba scan: the reference runs an associative scan inside a chunk,
    the port a step-by-step loop, so their float32 products come in
    another order: measured within 1.5e-7 of outputs of magnitude 1 at
    the reference's own test shapes; held at rtol = atol = 2e-5;
  * gradients: each leaf within 1e-4 of its largest magnitude (measured
    within 7.2e-7), as ``test_torch_lm_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as rmamba
from repro.models import mla as rmla
from repro.models import moe as rmoe
from repro.models import xlstm as rxlstm
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import mamba as pmamba
from repro_torch.models import mla as pmla
from repro_torch.models import moe as pmoe
from repro_torch.models import xlstm as pxlstm

TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL = 1e-4


def _port(cls, cfg, params):
    """A port module of `cls` holding the reference's `params`."""
    mod = cls(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    return mod


def _x(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _grads_match(ref_fn, params, mod, port_fn, x: np.ndarray):
    """The gradients of sum(out * r) in every parameter and in x, port
    against ``jax.grad``, r a fixed numpy draw."""
    out = jax.eval_shape(ref_fn, params, jnp.asarray(x))
    r = _x(out.shape, 99)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(ref_fn(p, xx) * r),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port_fn(mod, xt) * torch.from_numpy(r)).sum().backward()
    want = dict(jax.tree.map(np.asarray, gp), x=np.asarray(gx))
    got = {n: p.grad for n, p in mod.named_parameters()}
    got["x"] = xt.grad
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g is not None, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


# -------------------------------------------------------------------- MoE ---

def _moe_pair(factor=1.25, shared=0, seed=0):
    cfg = rmoe.MoEConfig(d_model=32, d_ff=24, n_experts=8, top_k=2,
                         capacity_factor=factor, shared_expert_ff=shared)
    params = rmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, params, _port(pmoe.MoE, pmoe.MoEConfig(
        **dataclasses.asdict(cfg)), params)


def _ref_routing(params, cfg, x):
    """The reference's routing of x (T, D), by its own expressions
    (``moe.py:83-103``): chosen experts and the keep mask."""
    probs = jax.nn.softmax((x @ params["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    t = x.shape[0]
    cap = max(1, int(np.ceil(cfg.capacity_factor * t * cfg.top_k
                             / cfg.n_experts)))
    onehot = jax.nn.one_hot(idx.reshape(-1), cfg.n_experts, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(onehot, axis=0) * onehot - 1, axis=-1)
    return np.asarray(idx), np.asarray((pos >= 0) & (pos < cap)), cap


@pytest.mark.parametrize("factor,shared", [(1.25, 0), (4.0, 0), (1.25, 16),
                                           (4.0, 16)])
def test_moe_matches_reference(factor, shared):
    """Outputs, aux loss, chosen experts and dropped tokens at the default
    capacity factor (tokens dropped) and at E / k = 4 (none), with and
    without a shared expert."""
    cfg, params, mod = _moe_pair(factor, shared)
    x = _x((3, 16, cfg.d_model), 1)
    want_y, want_aux = rmoe.moe_block(params, cfg, jnp.asarray(x), None)
    got_y, got_aux = mod(torch.from_numpy(x))
    _close(got_y, want_y)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    experts, keep, cap = _ref_routing(params, cfg, jnp.asarray(
        x.reshape(-1, cfg.d_model)))
    r = mod.route(torch.from_numpy(x.reshape(-1, cfg.d_model)))
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.cap == cap
    dropped = int((~keep).sum())
    if factor == 4.0:
        assert dropped == 0
    else:
        assert dropped > 0      # the capacity bites at the default factor


def test_moe_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = pmoe.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3]])


def test_moe_mesh_raises(tmp_path):
    """Expert parallelism on a mesh of one rank (a gloo group of one: the
    experts' all_to_all runs on it) gives the block without a mesh, y and
    aux; a mesh without a process group is the block itself."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    _, _, mod = _moe_pair(seed=3)
    x = torch.from_numpy(_x((2, 8, 32), 5))
    y0, aux0 = pmoe.moe_block(mod, x)
    y1, aux1 = pmoe.moe_block(mod, x, make_debug_mesh("cpu"))
    assert torch.equal(y1, y0) and torch.equal(aux1, aux0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh("cpu")
        y, aux = pmoe.moe_block(mod, x, mesh)
        torch.testing.assert_close(y.full_tensor(), y0, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(aux, aux0, rtol=1e-6, atol=0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shared", [0, 16])
def test_moe_gradients_match_reference(shared):
    cfg, params, mod = _moe_pair(1.25, shared, seed=2)
    _grads_match(lambda p, x: rmoe.moe_block(p, cfg, x, None)[0], params,
                 mod, lambda m, x: m(x)[0], _x((2, 12, cfg.d_model), 3))
    # and of the aux loss alone, which reaches the router only
    x = _x((2, 12, cfg.d_model), 4)
    g = jax.grad(lambda p: rmoe.moe_block(p, cfg, jnp.asarray(x), None)[1])(
        params)
    mod.zero_grad(set_to_none=True)
    mod(torch.from_numpy(x))[1].backward()
    _close(mod.router.grad, g["router"], dict(rtol=1e-4, atol=1e-7))
    assert mod.wi.grad is None


# -------------------------------------------------------------------- MLA ---

def _mla_pair(seed=0):
    cfg = rmla.MLAConfig(d_model=48, n_heads=4, q_lora=24, kv_lora=16,
                         nope_dim=16, rope_dim=8, v_dim=12)
    params = rmla.init_mla(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for k in ("q_a_norm", "kv_a_norm"):        # exercise the norms' scales
        params[k] = jnp.asarray(0.1 * rng.standard_normal(params[k].shape),
                                jnp.float32)
    return cfg, params, _port(pmla.MLA, pmla.MLAConfig(
        **dataclasses.asdict(cfg)), params)


def _mla_rope(cfg, pos: np.ndarray):
    return players.rope_table(torch.from_numpy(pos), cfg.rope_dim,
                              cfg.rope_theta)


def test_mla_forward_and_decode_match_reference():
    """Training form over (2, 10) and the absorbed decode over the same
    prompt, slot 1 three positions ahead; the compressed cache's contents
    after the prompt."""
    cfg, params, mod = _mla_pair()
    b, s = 2, 10
    x = _x((b, s, cfg.d_model), 5)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    want = rmla.mla_attention(params, cfg, jnp.asarray(x),
                              jnp.asarray(pos, jnp.int32))
    _close(mod(torch.from_numpy(x), _mla_rope(cfg, pos)), want)

    length = s + 3
    cache_r = rmla.init_mla_cache(cfg, b, length, jnp.float32)
    cache_p = pmla.init_mla_cache(cfg, b, length, torch.float32, "cpu")
    step = jax.jit(lambda c, xt, p_: rmla.decode_mla(params, cfg, xt, c, p_))
    for t in range(s):
        p_ = np.array([t, t + 3])
        want, cache_r = step(cache_r, jnp.asarray(x[:, t:t + 1]),
                             jnp.asarray(p_, jnp.int32))
        tp = torch.from_numpy(p_)
        with torch.no_grad():
            got = mod.decode(torch.from_numpy(x[:, t:t + 1]),
                             cache_p["c_kv"][0], cache_p["k_rope"][0],
                             _mla_rope(cfg, p_[:, None]),
                             pattn.DecodeIndex.of(tp, length, False))
        _close(got, want)
    for k in ("c_kv", "k_rope"):
        _close(cache_p[k][0], cache_r[k])


def test_mla_gradients_match_reference():
    cfg, params, mod = _mla_pair(seed=1)
    s = 6
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    _grads_match(lambda p, x: rmla.mla_attention(
        p, cfg, x, jnp.asarray(pos, jnp.int32)), params, mod,
        lambda m, x: m(x, _mla_rope(cfg, pos)), _x((2, s, cfg.d_model), 6))


# ------------------------------------------------------------------ Mamba ---

def _mamba_pair(cfg, seed):
    params = rmamba.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return params, _port(pmamba.Mamba, pmamba.MambaConfig(
        **dataclasses.asdict(cfg)), params)


def _port_mamba_decode(mod, x: np.ndarray):
    st = pmamba.init_mamba_state(mod.cfg, x.shape[0], torch.float32, "cpu")
    outs = []
    with torch.no_grad():
        for i in range(x.shape[1]):
            outs.append(mod.decode(torch.from_numpy(x[:, i:i + 1]),
                                   st["conv"][0], st["ssm"][0])[:, 0])
    return torch.stack(outs, dim=1).numpy(), st


def test_mamba_chunked_forward_matches_recurrent_decode():
    """``tests/test_mamba_equiv.py``'s first case, in the port and across
    the packages: the chunked forward against the step-by-step decode
    (the reference's bound 2e-4), each against the reference's, and the
    decode states."""
    cfg = rmamba.MambaConfig(d_model=32, d_state=8, d_conv=4, expand=2,
                             chunk=8)
    params, mod = _mamba_pair(cfg, 0)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 32, cfg.d_model)) * 0.5)
    y_par = mod(torch.from_numpy(x)).detach().numpy()
    y_seq, st = _port_mamba_decode(mod, x)
    np.testing.assert_allclose(y_par, y_seq, rtol=2e-4, atol=2e-4)
    want_par = rmamba.mamba_block(params, cfg, jnp.asarray(x))
    _close(y_par, want_par, SCAN_TOL)
    state = rmamba.init_mamba_state(cfg, 2, jnp.float32)
    step = jax.jit(lambda s_, xt: rmamba.decode_mamba(params, cfg, xt, s_))
    outs = []
    for i in range(x.shape[1]):
        y_i, state = step(state, jnp.asarray(x[:, i:i + 1]))
        outs.append(np.asarray(y_i[:, 0]))
    _close(y_seq, np.stack(outs, axis=1))
    _close(st["conv"][0], state["conv"])
    _close(st["ssm"][0], state["ssm"])


def test_mamba_chunk_size_invariance():
    """``tests/test_mamba_equiv.py``'s second case: chunk 4 against chunk
    16 at its bound, and each against the reference's."""
    base = rmamba.MambaConfig(d_model=16, d_state=4, chunk=4)
    params, mod = _mamba_pair(base, 2)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 16, 16))
                   * 0.5)
    y4 = mod(torch.from_numpy(x)).detach().numpy()
    mod16 = _port(pmamba.Mamba, pmamba.MambaConfig(
        **dataclasses.asdict(dataclasses.replace(base, chunk=16))), params)
    y16 = mod16(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y4, y16, rtol=1e-5, atol=1e-6)
    _close(y4, rmamba.mamba_block(params, base, jnp.asarray(x)), SCAN_TOL)
    _close(y16, rmamba.mamba_block(params, dataclasses.replace(
        base, chunk=16), jnp.asarray(x)), SCAN_TOL)


def test_mamba_gradients_flow_and_match_reference():
    """``tests/test_mamba_equiv.py``'s third case (every gradient finite,
    their sum positive), and each gradient against ``jax.grad``."""
    cfg = rmamba.MambaConfig(d_model=16, d_state=4, chunk=8)
    params, mod = _mamba_pair(cfg, 4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 16, 16))
                   * 0.5)
    (mod(torch.from_numpy(x)) ** 2).mean().backward()
    total = sum(float(p.grad.abs().sum()) for p in mod.parameters())
    assert np.isfinite(total) and total > 0
    mod.zero_grad(set_to_none=True)
    _grads_match(lambda p, xx: rmamba.mamba_block(p, cfg, xx), params, mod,
                 lambda m, xx: m(xx), x)


def test_mamba_scan_chunk_must_divide():
    cfg = pmamba.MambaConfig(d_model=8, d_state=4, chunk=4)
    mod = pmamba.Mamba(cfg, device="cpu", dtype=torch.float32)
    mod.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        mod(torch.zeros((1, 6, 8)))


# ------------------------------------------------------------------ xLSTM ---

def _xlstm_pair(kind: str, chunk: int = 4, seed: int = 0):
    cfg = rxlstm.XLSTMConfig(d_model=16, n_heads=2, chunk=chunk)
    init = rxlstm.init_mlstm if kind == "mlstm" else rxlstm.init_slstm
    params = init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for k in params:                 # exercise the biases and skip weights
        if k.startswith("b") or k == "skip_w":
            params[k] = jnp.asarray(0.3 * rng.standard_normal(
                params[k].shape), jnp.float32) + (k == "skip_w")
    cls = pxlstm.MLSTM if kind == "mlstm" else pxlstm.SLSTM
    return cfg, params, _port(cls, pxlstm.XLSTMConfig(
        **dataclasses.asdict(cfg)), params)


_REF = {"mlstm": (rxlstm.mlstm_block, rxlstm.decode_mlstm,
                  rxlstm.init_mlstm_state),
        "slstm": (rxlstm.slstm_block, rxlstm.decode_slstm,
                  rxlstm.init_slstm_state)}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_forward_and_decode_match_reference(kind):
    """Forward over (2, 12) in chunks of 4 (three chunks carry the mLSTM
    state), and the step-by-step decode with its states after each step,
    against the reference's."""
    cfg, params, mod = _xlstm_pair(kind)
    block, decode, init_state = _REF[kind]
    x = _x((2, 12, cfg.d_model), 7)
    _close(mod(torch.from_numpy(x)), block(params, cfg, jnp.asarray(x)))
    state = init_state(cfg, 2)
    pst = (pxlstm.init_mlstm_state if kind == "mlstm"
           else pxlstm.init_slstm_state)(cfg, 2, "cpu")
    step = jax.jit(lambda s_, xt: decode(params, cfg, xt, s_))
    keys = "cnm" if kind == "mlstm" else "cnmh"
    for t in range(x.shape[1]):
        want, state = step(state, jnp.asarray(x[:, t:t + 1]))
        with torch.no_grad():
            got = mod.decode(torch.from_numpy(x[:, t:t + 1]),
                             *(pst[k][0] for k in keys))
        _close(got, want)
        for k in state:
            _close(pst[k][0], state[k])


def test_mlstm_chunked_forward_matches_decode():
    """The chunkwise parallel form over (2, 12) against the port's own
    recurrent decode, at the reference's decode-vs-forward bound for the
    recurrent mixers (``tests/test_arch_smoke.py:111``)."""
    cfg, _, mod = _xlstm_pair("mlstm", chunk=4, seed=3)
    x = _x((2, 12, cfg.d_model), 8)
    y = mod(torch.from_numpy(x)).detach()
    st = pxlstm.init_mlstm_state(cfg, 2, "cpu")
    with torch.no_grad():
        seq = torch.cat([mod.decode(torch.from_numpy(x[:, t:t + 1]),
                                    st["c"][0], st["n"][0], st["m"][0])
                         for t in range(12)], dim=1)
    torch.testing.assert_close(y, seq, rtol=5e-3, atol=5e-3)


def test_mlstm_chunk_must_divide():
    _, _, mod = _xlstm_pair("mlstm", chunk=4)
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        mod(torch.zeros((1, 6, 16)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_gradients_match_reference(kind):
    cfg, params, mod = _xlstm_pair(kind, seed=5)
    block = _REF[kind][0]
    _grads_match(lambda p, x: block(p, cfg, x), params, mod,
                 lambda m, x: m(x), _x((2, 8, cfg.d_model), 9))


def test_slstm_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    _close(torch.nn.functional.gelu(x, approximate="tanh"),
           jax.nn.gelu(jnp.asarray(x.numpy())), dict(rtol=1e-6, atol=1e-6))

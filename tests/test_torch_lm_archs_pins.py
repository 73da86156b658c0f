"""Three behaviours of the reference that the MoE ffn and the recurrent
mixers bring out, each pinned where the port equals the reference and the
two orders or schedules part, then the weight round trip through
``convert`` and the initial weights of granite-moe, deepseek-v3, jamba
and xlstm (float32 smoke configs; helpers of ``test_torch_lm_archs.py``
and ``test_torch_lm_archs_serve.py``):

1. the decode order: ``forward`` walks the body period-major
   (``src/repro/models/model.py:238-245``), ``decode_step``
   position-major (``:389-396``), so with two periods teacher-forced
   decode is another network (xlstm, jamba);
2. the MoE capacity counts every token of a call (``moe.py:97``): a
   decode step (T = B) drops other tokens than a forward (T = B * S) at
   the default capacity factor, and none at E / k;
3. the serving schedule: ``admit`` steps every slot while it prefills
   one, which advances the other slots' recurrent states, and MoE
   capacity couples the slots, so a request's tokens depend on what is
   served beside it (xlstm, jamba).

Tolerances: logits rtol = atol = 1e-4 (``test_torch_lm_archs.py``'s); decode
against forward where the two should agree, 2e-3 (the reference's own
bound, ``tests/test_arch_smoke.py:93``); served tokens exactly.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_lm_archs as A
from repro.models import model as R
from repro_torch.launch import serve as pserve_cli
from repro_torch.models import model as P
from repro_torch.models.convert import (from_reference, to_reference,
                                        unstack_tree)
from test_torch_lm_archs_serve import serve_both

DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
# a divergence of the two orders or capacities: measured 1.87 (MoE
# capacity, jamba) to 5.5 (order, jamba with two periods) on logits of
# magnitude 4, far beyond float32 reordering (below 1e-5)
PARTED = 0.1


def _fwd_and_dec(arch: str, tokens_shape=(2, 8), **over):
    """Forward and teacher-forced decode logits, port and reference."""
    rc, pc, params, model = A.pair(arch, **over)
    tokens = A._tokens(rc.vocab, *tokens_shape, seed=4)
    want_fwd = A.ref_forward(rc, params, tokens)[0]
    want_dec = A.ref_decode_all(rc, params, tokens)[0]
    got_fwd = P.forward(model, pc, torch.from_numpy(tokens))[0]
    got_dec = A.port_decode_all(pc, model, tokens)[0]
    A._close(got_fwd, want_fwd)
    A._close(got_dec, want_dec)
    return got_fwd.detach().numpy(), got_dec, want_fwd, want_dec


@pytest.mark.parametrize("arch,over", [
    ("xlstm-125m", {}),
    # capacity E / k: no token dropped, only the order parts the two
    ("jamba-v0.1-52b", {"capacity_factor": 2.0})])
def test_decode_order_divergence_is_the_reference_s(arch, over):
    """Two periods: the port's forward equals the reference's forward, its
    decode the reference's decode, and decode parts from forward in both
    packages; with one period the two agree."""
    got_fwd, got_dec, want_fwd, want_dec = _fwd_and_dec(arch, n_periods=2,
                                                        **over)
    assert np.abs(want_dec - want_fwd).max() > PARTED
    assert np.abs(got_dec - got_fwd).max() > PARTED
    got_fwd, got_dec, want_fwd, want_dec = _fwd_and_dec(arch, n_periods=1,
                                                        **over)
    np.testing.assert_allclose(want_dec, want_fwd, **DECODE_TOL)
    np.testing.assert_allclose(got_dec, got_fwd, **DECODE_TOL)


def test_moe_decode_drops_other_tokens_than_forward():
    """jamba smoke, one period: at the default capacity factor 1.25 the
    decode step and the forward drop different tokens and part, in both
    packages alike; at E / k = 2 nothing drops and they agree."""
    got_fwd, got_dec, want_fwd, want_dec = _fwd_and_dec("jamba-v0.1-52b")
    assert np.abs(want_dec - want_fwd).max() > PARTED
    assert np.abs(got_dec - got_fwd).max() > PARTED
    got_fwd, got_dec, want_fwd, want_dec = _fwd_and_dec(
        "jamba-v0.1-52b", capacity_factor=2.0)
    np.testing.assert_allclose(want_dec, want_fwd, **DECODE_TOL)
    np.testing.assert_allclose(got_dec, got_fwd, **DECODE_TOL)


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_served_tokens_depend_on_the_schedule(arch):
    """4 requests on 2 slots (6 new tokens) against each request on a slot
    of its own: the port gives the reference's tokens under both
    schedules, so the same requests part between them in both packages,
    and some do (the other slot's prefill steps a recurrent state;
    capacity couples MoE slots): requests 0, 2 and 3 of xlstm's, all four
    of jamba's."""
    rc, pc, params, model = A.pair(arch)
    reqs = pserve_cli.requests_for(pc, 4, seed=2)
    kw = dict(max_new_tokens=6, max_len=64)
    got, want = serve_both(rc, pc, params, model, reqs, batch_slots=2, **kw)
    parted = {"port": set(), "reference": set()}
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], want[r.uid])
        got1, want1 = serve_both(rc, pc, params, model, [r], batch_slots=1, **kw)
        np.testing.assert_array_equal(got1[r.uid], want1[r.uid])
        if not np.array_equal(want[r.uid], want1[r.uid]):
            parted["reference"].add(r.uid)
        if not np.array_equal(got[r.uid], got1[r.uid]):
            parted["port"].add(r.uid)
    assert parted["port"] == parted["reference"]
    assert parted["port"], "no request parted between the schedules"


@pytest.mark.parametrize("head", ["dense", "loghd"])
@pytest.mark.parametrize("arch", A.ARCHS)
def test_weight_conversion_round_trips(arch, head):
    """The reference's tree in and out of the port unchanged, every leaf
    in the dtype the reference keeps it (router, Mamba's A / dt bias / D,
    the xLSTM biases and skip weights, the MLA norms float32 in a bf16
    model), and the port's own weights back through the reference's
    layout bitwise."""
    rc, pc = A._cfgs(arch, head=head, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(5), rc))
    model = from_reference(tree, pc, device="cpu")
    back = to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    theirs = unstack_tree(tree, model)
    for name, p in model.named_parameters():
        assert p.dtype == getattr(torch, str(theirs[name].dtype)), name
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    mine = P.init_params(pc, seed=1, device="cpu")
    again = from_reference(to_reference(mine), pc, device="cpu")
    for (n, a), (_, b) in zip(mine.named_parameters(),
                              again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("arch", A.ARCHS)
def test_init_params_match_reference_in_distribution(arch):
    """Same leaves, shapes and dtypes as the reference's init_params; a
    drawn leaf's std near the reference's, a constant leaf (norm
    scales, biases, Mamba's A and dt bias, skip weights) equal to it."""
    rc, pc = A._cfgs(arch)
    want = jax.tree.map(np.asarray, R.init_params(jax.random.PRNGKey(0), rc))
    got = to_reference(P.init_params(pc, seed=0, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if w.std() == 0 or w.ndim >= 2 and np.all(w == w[..., :1, :]):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
            continue
        # two samples' stds differ by about 1/sqrt(size) of either: 10%
        # plus five of those (a (1, 4, 128) conv leaf is 512 draws)
        assert abs(g.std() / w.std() - 1) < 0.1 + 5 / np.sqrt(w.size), name

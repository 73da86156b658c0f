"""The port's training slice against the JAX package on the same inputs: the
OnlineHD and Eq. 9 steps and epochs (ragged tails included), the fit
engine with the reference's refinement permutations injected, SparseHD and
hybrid keep indices, all four classifier families fitted on the `page`
surrogate at D=512, their predictions, their corruption with the
reference's per-leaf seeds, and the weight converter.

Tolerances: float32 results whose sums run in another order than XLA's are
allclose at rtol 1e-5 / atol 1e-6 (``tests/test_fit_engine.py``'s bound
for its kernel path); labels, keep indices and flipped bits are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.dispatch as jdispatch
import repro.api.fit_engine as jfit
import repro.core.bundling as jbundling
import repro.core.hybrid as jhybrid
import repro.core.sparsehd as jsparsehd
import repro.hdc.conventional as jconv
from repro.api import make_classifier as jax_make_classifier
from repro.core.codebook import build_codebook
from repro.core.quantize import QTensor as JaxQTensor
from repro.data.synth import load_dataset
from repro.hdc.encoders import EncoderConfig as JaxEncoderConfig
from repro.hdc.encoders import encode_batched as jax_encode_batched
from repro.hdc.encoders import fit_encoder as jax_fit_encoder
from repro_torch.api import (dispatch, fit_engine, from_reference,
                             make_classifier, to_reference)
from repro_torch.api.convert import model_class
from repro_torch.core import bundling, hybrid, sparsehd
from repro_torch.hdc import conventional
from repro_torch.kernels import common
from repro_torch.precision import in_full_f32

F32 = dict(rtol=1e-5, atol=1e-6)
DIM = 512
EPOCHS = 3
FAMILIES = {
    "conventional": dict(refine_epochs=EPOCHS),
    "sparsehd": dict(sparsity=0.6, retrain_epochs=EPOCHS),
    "loghd": dict(k=2, extra_bundles=2, refine_epochs=EPOCHS,
                  refine_batch=64, codebook_method="distance"),
    "hybrid": dict(sparsity=0.48, k=2, extra_bundles=5, refine_epochs=EPOCHS,
                   refine_batch=64, codebook_method="distance"),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _arrays(model) -> dict:
    """A reference model's field dict as numpy (the converter's input)."""
    out = {}
    for k, v in model.to_dict().items():
        if k == "enc":
            out[k] = {a: np.asarray(b) for a, b in v.items()}
        elif isinstance(v, JaxQTensor):
            out[k] = (np.asarray(v.codes), np.asarray(v.scale), v.bits)
        else:
            out[k] = np.asarray(v)
    return out


def _ref_perms(seed: int, epochs: int, n: int) -> np.ndarray:
    """The reference's refinement orders: ``jax.random.permutation`` of each
    key of ``split(PRNGKey(seed), epochs)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), epochs)
    return np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])


def _data(n, d, c, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    y = rng.integers(0, c, size=n).astype(np.int32)
    return h, y


# ------------------------------------------------------------ steps ------

@pytest.mark.parametrize("n,bs", [(10, 4), (12, 4), (5, 8)])
def test_pad_batches_matches_reference(n, bs):
    h, y = _data(n, 6, 3, n)
    ty = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
    for lab in (y, ty):
        got = conventional.pad_batches(_t(h), _t(lab), bs)
        want = jconv.pad_batches(jnp.asarray(h), jnp.asarray(lab), bs)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_onlinehd_step_and_delta_match_reference():
    h, y = _data(64, 128, 7, 0)
    protos = np.asarray(jconv.class_prototypes(jnp.asarray(h),
                                               jnp.asarray(y), 7))
    y = (y + (np.arange(64) % 3 == 0)) % 7          # some misclassified
    args = (jnp.asarray(protos), jnp.asarray(h), jnp.asarray(y), 0.05)
    targs = (_t(protos), _t(h), _t(y).long(), 0.05)
    np.testing.assert_allclose(conventional.onlinehd_delta(*targs).numpy(),
                               np.asarray(jconv.onlinehd_delta(*args)), **F32)
    np.testing.assert_allclose(conventional.onlinehd_step(*targs).numpy(),
                               np.asarray(jconv.onlinehd_step(*args)), **F32)


def test_onlinehd_epoch_ragged_tail_matches_reference():
    h, y = _data(37, 64, 5, 2)
    protos = np.asarray(jconv.class_prototypes(jnp.asarray(h),
                                               jnp.asarray(y), 5))
    y = (y + 1) % 5
    want = jconv.onlinehd_epoch(jnp.asarray(protos), jnp.asarray(h),
                                jnp.asarray(y), 0.05, 8)
    got = conventional.onlinehd_epoch(_t(protos), _t(h), _t(y).long(), 0.05, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_refine_step_and_epoch_match_reference():
    h, y = _data(37, 64, 4, 3)
    book = build_codebook(4, 3, 2, seed=0)
    ty = np.asarray(jbundling.symbol_targets(jnp.asarray(book), 2)[y])
    m = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        bundling.refine_step(_t(m), _t(h[:8]), _t(ty[:8]), 0.05).numpy(),
        np.asarray(jbundling.refine_step(jnp.asarray(m), jnp.asarray(h[:8]),
                                         jnp.asarray(ty[:8]), 0.05)), **F32)
    key = jax.random.PRNGKey(7)
    perm = np.asarray(jax.random.permutation(key, 37))
    want = jbundling.refine_epoch(jnp.asarray(m), key, jnp.asarray(h),
                                  jnp.asarray(ty), 0.05, 8)
    got = bundling.refine_epoch(_t(m), _t(perm).long(), _t(h), _t(ty), 0.05, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the zero-padded tail is an exact no-op: the same as a short last batch
    short = _t(m)
    for i in range(0, 37, 8):
        idx = _t(perm[i:i + 8]).long()
        short = bundling.refine_step(short, _t(h)[idx], _t(ty)[idx], 0.05)
    np.testing.assert_allclose(got.numpy(), short.numpy(), rtol=0, atol=1e-7)


def test_epoch_permutations_seeded_injected_and_checked():
    a = bundling.epoch_permutations(50, 3, seed=4)
    assert a.shape == (3, 50) and a.dtype == torch.int64
    assert torch.equal(a, bundling.epoch_permutations(50, 3, seed=4))
    assert not torch.equal(a, bundling.epoch_permutations(50, 3, seed=5))
    for row in a:
        assert torch.equal(torch.sort(row).values, torch.arange(50))
    perms = _ref_perms(0, 3, 50)
    assert torch.equal(bundling.epoch_permutations(50, 3, perms=perms),
                       _t(perms).long())
    with pytest.raises(ValueError):
        bundling.epoch_permutations(50, 2, perms=perms)


# ----------------------------------------------------------- fit engine --

@pytest.fixture(scope="module")
def page():
    """The `page` surrogate encoded at D=512 by the reference's encoder,
    with its prototypes: the shared fixture every family fits from."""
    x_tr, y_tr, x_te, y_te, spec = load_dataset("page")
    enc_cfg = JaxEncoderConfig(spec.n_features, DIM, "cos")
    enc, h_tr = jax_fit_encoder(enc_cfg, jnp.asarray(x_tr))
    h_te = jax_encode_batched(enc, jnp.asarray(x_te), "cos")
    protos = jconv.class_prototypes(h_tr, jnp.asarray(y_tr), spec.n_classes)
    return dict(x_tr=x_tr, y_tr=y_tr, y_te=y_te, spec=spec, enc=enc,
                h_tr=np.asarray(h_tr), h_te=np.asarray(h_te),
                protos=np.asarray(protos))


@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_fused_onlinehd_fit_matches_reference(page, use_kernel):
    """Kernel steps (through the bundle_update plain version here) and
    plain steps both match the reference's fused fit."""
    args = (page["protos"], page["h_tr"], page["y_tr"])
    want = jfit.fused_onlinehd_fit(*map(jnp.asarray, args), lr=3e-3,
                                   batch_size=256, epochs=2, use_kernel=False)
    got = fit_engine.fused_onlinehd_fit(*map(_t, args), lr=3e-3,
                                        batch_size=256, epochs=2,
                                        use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    h_te = page["h_te"]
    np.testing.assert_array_equal(
        conventional.predict_from_encoded(got, _t(h_te)).numpy(),
        np.asarray(jconv.predict_from_encoded(want, jnp.asarray(h_te))))


@pytest.mark.parametrize("use_kernel", [None, False, True])
def test_fused_refine_bundles_matches_reference(page, use_kernel):
    book = build_codebook(5, 4, 2, seed=0, method="distance")
    m0 = jbundling.build_bundles(jnp.asarray(page["protos"]),
                                 jnp.asarray(book), 2)
    n = len(page["y_tr"])
    want = jfit.fused_refine_bundles(m0, jnp.asarray(page["h_tr"]),
                                     jnp.asarray(page["y_tr"]),
                                     jnp.asarray(book), 2, epochs=EPOCHS,
                                     lr=3e-3, batch_size=64, seed=0,
                                     use_kernel=False)
    got = fit_engine.fused_refine_bundles(
        _t(m0), _t(page["h_tr"]), _t(page["y_tr"]), _t(book), 2,
        epochs=EPOCHS, lr=3e-3, batch_size=64,
        perms=_ref_perms(0, EPOCHS, n), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(),
                               np.ones(4), rtol=1e-5)


def test_fit_engine_on_cpu_counts_no_launch(page):
    common.reset_launches()
    fit_engine.fused_onlinehd_fit(_t(page["protos"]), _t(page["h_tr"][:300]),
                                  _t(page["y_tr"][:300]), lr=3e-3,
                                  batch_size=64, epochs=1, use_kernel=True)
    assert sum(common.launches.values()) == 0


# ------------------------------------------------------ keep indices ----

@pytest.mark.parametrize("kind", ["spread", "variance"])
@pytest.mark.parametrize("sparsity", [0.5, 0.6, 0.95])
def test_keep_indices_equal_reference(kind, sparsity):
    protos = np.random.default_rng(3).standard_normal((7, 300)).astype(
        np.float32)
    got = sparsehd.keep_indices(_t(protos), sparsity, kind)
    want = jsparsehd.keep_indices(jnp.asarray(protos), sparsity, kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_keep_indices_ties_take_the_lower_index_first():
    """Whole blocks of equal saliency: ``jax.lax.top_k`` keeps the lower
    indices of a tied block, and so must the port."""
    rng = np.random.default_rng(0)
    cols = rng.standard_normal((5, 8)).astype(np.float32)
    protos = np.repeat(cols, 25, axis=1)[:, rng.permutation(200)]
    for sparsity in (0.3, 0.55, 0.9):
        got = sparsehd.keep_indices(_t(protos), sparsity)
        want = jsparsehd.keep_indices(jnp.asarray(protos), sparsity)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_budget_sparsities_match_reference():
    for x in (0.05, 0.2, 0.4, 0.7, 1.0):
        assert sparsehd.sparsity_for_budget(x, 26, 10_000, 4) == \
            jsparsehd.sparsity_for_budget(x, 26, 10_000, 4)
        for n in (5, 10, 20):
            assert hybrid.sparsity_for_budget(x, 26, 10_000, n) == \
                jhybrid.sparsity_for_budget(x, 26, 10_000, n)


# ---------------------------------------------------- the four families --

@pytest.fixture(scope="module")
def fitted(page):
    """Each family fitted by the reference and by the port on the shared
    encoder, encodings and prototypes, refinement orders injected."""
    spec, n = page["spec"], len(page["y_tr"])
    enc_t = {k: _t(v) for k, v in page["enc"].items()}
    out = {}
    for name, kw in FAMILIES.items():
        ref = jax_make_classifier(name, spec.n_classes, spec.n_features,
                                  dim=DIM, **kw).fit(
            jnp.asarray(page["x_tr"]), jnp.asarray(page["y_tr"]),
            enc=page["enc"], encoded=jnp.asarray(page["h_tr"]),
            prototypes=jnp.asarray(page["protos"]))
        port = make_classifier(name, spec.n_classes, spec.n_features,
                               dim=DIM, device="cpu", **kw).fit(
            page["x_tr"], page["y_tr"], enc=enc_t, encoded=_t(page["h_tr"]),
            prototypes=_t(page["protos"]), perms=_ref_perms(0, EPOCHS, n))
        out[name] = (ref.model, port.model)
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_fit_matches_reference(fitted, name):
    want, got = fitted[name]
    assert type(got).method == name == type(want).method
    assert list(got.to_dict()) == list(want.to_dict())
    for leaf, w in want.to_dict().items():
        if leaf in ("enc", "sigma_inv"):
            continue
        g = getattr(got, leaf)
        if leaf in ("keep", "codebook"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    assert got.model_bits(4) == want.model_bits(4)
    assert got.stored_bytes() == want.stored_bytes()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_labels_equal_reference(fitted, page, name):
    want_model, got_model = fitted[name]
    h = page["h_te"]
    want = np.asarray(jdispatch.predict_encoded(want_model, jnp.asarray(h)))
    for use_kernels in (None, True, False):
        got = dispatch.predict_encoded(got_model, _t(h), use_kernels)
        np.testing.assert_array_equal(got.numpy(), want)
    conv = from_reference(_arrays(want_model), device="cpu")
    np.testing.assert_array_equal(
        dispatch.predict_encoded(conv, _t(h)).numpy(), want)


def _leaf_seeds(key, n_leaves: int) -> list:
    keys = jax.random.split(key, n_leaves)
    return [int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max))
            for k in keys]


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("scope", ["all", "hv"])
def test_family_corrupt_materialize_bitwise(fitted, name, scope):
    """The reference's kernel-path corruption and the port's, with the
    seeds the reference draws per leaf of ``to_dict()`` — SparseHD's int
    ``keep`` leaf takes a seed slot and is not flipped.  LogHD's float
    ``sigma_inv`` gets IEEE flips from a torch generator, another stream
    than the reference's threefry, which the l2 decode never reads."""
    jq = fitted[name][0].quantized(4)
    key = jax.random.PRNGKey(3)
    want = jdispatch.corrupt_materialize(jq, 0.1, key, scope, use_kernel=True)
    port_q = from_reference(_arrays(jq), device="cpu")
    got = port_q.corrupted_materialized(
        0.1, _leaf_seeds(key, len(port_q.to_dict()) - 1), scope)
    assert type(got) is type(port_q)
    for leaf, w in want.to_dict().items():
        if leaf in ("enc", "sigma_inv"):
            continue
        g, w = getattr(got, leaf).numpy(), np.asarray(w)
        if g.dtype == np.float32:                  # bitwise, NaNs included
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_convert_round_trips(fitted, name):
    for model in (fitted[name][0], fitted[name][0].quantized(4)):
        arrays = _arrays(model)
        conv = from_reference(arrays, device="cpu")
        assert type(conv).method == name == model_class(arrays).method
        back = to_reference(conv)
        assert back.keys() == arrays.keys()
        for k, v in arrays.items():
            if k == "enc":
                for a in v:
                    np.testing.assert_array_equal(back[k][a], v[a])
            elif isinstance(v, tuple):
                assert back[k][2] == v[2]
                np.testing.assert_array_equal(back[k][0], v[0])
                np.testing.assert_array_equal(back[k][1], v[1])
            else:
                assert back[k].dtype == v.dtype
                np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        model_class({"enc", "protos", "bundles"})


def test_hybrid_reuses_a_base_model(fitted, page):
    """``base=`` skips training LogHD: the hybrid built on the port's own
    LogHD fit equals the one that fitted its base itself."""
    spec = page["spec"]
    kw = FAMILIES["hybrid"]
    base = make_classifier("loghd", spec.n_classes, spec.n_features, dim=DIM,
                           device="cpu",
                           **{k: v for k, v in kw.items() if k != "sparsity"})
    base = base.fit(page["x_tr"], page["y_tr"],
                    enc={k: _t(v) for k, v in page["enc"].items()},
                    encoded=_t(page["h_tr"]), prototypes=_t(page["protos"]),
                    perms=_ref_perms(0, EPOCHS, len(page["y_tr"])))
    clf = make_classifier("hybrid", spec.n_classes, spec.n_features, dim=DIM,
                          device="cpu", **kw)
    got = clf.fit(page["x_tr"], page["y_tr"], encoded=_t(page["h_tr"]),
                  base=base.model).model
    want = fitted["hybrid"][1]
    for leaf in ("bundles", "profiles", "keep", "codebook"):
        assert torch.equal(getattr(got, leaf), getattr(want, leaf))


def test_fits_run_in_full_f32_whatever_the_global_flag(page):
    """Every matmul-like call of a fit and a predict runs with TF32 off,
    even when the process turned TF32 on; the flag is restored after."""
    seen = []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.matmul, torch.Tensor.matmul, torch.einsum,
                        torch.mm, torch.addmm):
                seen.append(in_full_f32())
            return func(*args, **(kwargs or {}))

    spec = page["spec"]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with Watch():
            clf = make_classifier("loghd", spec.n_classes, spec.n_features,
                                  dim=64, device="cpu", refine_epochs=1,
                                  refine_batch=256)
            clf = clf.fit(page["x_tr"][:600], page["y_tr"][:600])
            clf.predict(page["x_tr"][:50])
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert len(seen) > 10 and all(seen)

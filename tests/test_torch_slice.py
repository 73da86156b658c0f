"""The port's LogHD slice end to end against the JAX package, on the `page`
surrogate at D=512 with ``refine_epochs=0``: fit, predict, quantize, corrupt
with seeds derived from the reference's key chain, the flip sweep, the
weight converter, and the package's own rules.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.dispatch as jdispatch
from repro.api import make_classifier as jax_make_classifier
from repro.api.models import LogHDModel as JaxLogHDModel
from repro.core.evaluate import trial_keys
from repro.core.quantize import QTensor as JaxQTensor
from repro.data.synth import load_dataset
from repro_torch.api import (dispatch, from_reference, make_classifier,
                             to_reference)
from repro_torch.core.evaluate import accuracy, sweep_under_flips
from repro_torch.kernels import common

SRC = Path(__file__).resolve().parents[1] / "src"
KW = dict(dim=512, k=2, extra_bundles=2, refine_epochs=0,
          codebook_method="distance")
P_GRID = [0.0, 0.1, 0.3]


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


def _leaf_seeds(key, n_leaves: int) -> list:
    """The int32 seeds the reference's kernel path draws per stored leaf
    (``repro.api.dispatch.corrupt_materialize`` / ``corrupt_dequant``)."""
    keys = jax.random.split(key, n_leaves)
    return [int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max))
            for k in keys]


@pytest.fixture(scope="module")
def ref():
    x_tr, y_tr, x_te, y_te, spec = load_dataset("page")
    clf = jax_make_classifier("loghd", spec.n_classes, spec.n_features, **KW)
    clf = clf.fit(jnp.asarray(x_tr), jnp.asarray(y_tr))
    from repro.hdc.encoders import encode_batched
    h_tr = encode_batched(clf.model.enc, jnp.asarray(x_tr), "cos")
    h_te = encode_batched(clf.model.enc, jnp.asarray(x_te), "cos")
    return dict(x_tr=x_tr, y_tr=y_tr, y_te=y_te, spec=spec, model=clf.model,
                h_tr=np.asarray(h_tr), h_te=np.asarray(h_te))


@pytest.fixture(scope="module")
def port_fit(ref):
    """The port's fit on the reference's encoder and encodings."""
    spec = ref["spec"]
    clf = make_classifier("loghd", spec.n_classes, spec.n_features,
                          device="cpu", **KW)
    enc = {k: torch.from_numpy(np.array(v))
           for k, v in ref["model"].enc.items()}
    return clf.fit(ref["x_tr"], ref["y_tr"], enc=enc,
                   encoded=torch.from_numpy(ref["h_tr"].copy()))


def test_fit_matches_reference(ref, port_fit):
    got, want = port_fit.model, ref["model"]
    np.testing.assert_array_equal(got.codebook.numpy(),
                                  np.asarray(want.codebook))
    np.testing.assert_allclose(got.bundles.numpy(), np.asarray(want.bundles),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.profiles.numpy(),
                               np.asarray(want.profiles), rtol=1e-5,
                               atol=1e-6)
    # sigma_inv inverts a near-singular covariance, so float32 rounding in
    # its inputs moves it by up to ~1% of its largest entry; the Mahalanobis
    # decode it feeds must still give the reference's labels
    si, want_si = got.sigma_inv.numpy(), np.asarray(want.sigma_inv)
    np.testing.assert_allclose(si, want_si, rtol=0,
                               atol=2e-2 * np.abs(want_si).max())
    h = torch.from_numpy(ref["h_te"].copy())
    np.testing.assert_array_equal(
        got.replace(metric="maha").predict_encoded(h).numpy(),
        np.asarray(want.replace(metric="maha").predict_encoded(
            jnp.asarray(ref["h_te"]))))
    assert got.model_bits(4) == want.model_bits(4)
    assert got.stored_bytes() == want.stored_bytes()


def test_labels_identical_to_reference(ref, port_fit):
    want = np.asarray(jdispatch.predict_encoded(ref["model"],
                                                jnp.asarray(ref["h_te"])))
    h = torch.from_numpy(ref["h_te"].copy())
    got = dispatch.predict_encoded(port_fit.model, h)
    np.testing.assert_array_equal(got.numpy(), want)
    conv = from_reference(_arrays(ref["model"]), device="cpu")
    np.testing.assert_array_equal(dispatch.predict_encoded(conv, h).numpy(),
                                  want)
    np.testing.assert_array_equal(
        dispatch.predict_encoded(conv, h, use_kernels=True).numpy(), want)
    assert accuracy(conv, h, ref["y_te"]) == pytest.approx(
        float(np.mean(want == ref["y_te"])))


@pytest.mark.parametrize("metric", ["cos", "maha"])
def test_other_metrics_identical_to_reference(ref, metric):
    jm = ref["model"].replace(metric=metric)
    want = np.asarray(jdispatch.predict_encoded(jm, jnp.asarray(ref["h_te"])))
    conv = from_reference(_arrays(ref["model"]), device="cpu", metric=metric)
    got = dispatch.predict_encoded(conv, torch.from_numpy(ref["h_te"].copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_encoder_predict_agrees(ref):
    """The port's whole predict, encoder included, on injected weights."""
    conv = from_reference(_arrays(ref["model"]), device="cpu")
    x_te = load_dataset("page")[2]
    got = conv.predict(x_te).numpy()
    want = np.asarray(ref["model"].predict(jnp.asarray(x_te)))
    assert np.mean(got == want) >= 0.995


def test_quantized_bitwise(ref):
    """The fitted model's stored leaves quantize to the reference's codes
    (bitwise at the reference's scale; the port's own scale within 2 ulp)."""
    from repro_torch.core.quantize import codes_for_scale
    conv = from_reference(_arrays(ref["model"]), device="cpu")
    for bits in (1, 4, 8):
        got, want = conv.quantized(bits), ref["model"].quantized(bits)
        for leaf in ("bundles", "profiles"):
            g, w = getattr(got, leaf), getattr(want, leaf)
            scale = np.array(w.scale)
            np.testing.assert_array_equal(
                codes_for_scale(getattr(conv, leaf), torch.from_numpy(scale),
                                bits).numpy(), np.asarray(w.codes))
            assert abs(float(g.scale) - float(scale)) <= 2 * np.spacing(scale)
            np.testing.assert_array_equal(g.codes.numpy(),
                                          np.asarray(w.codes))


@pytest.mark.parametrize("scope", ["all", "hv"])
@pytest.mark.parametrize("p", [0.0, 0.05, 0.3])
def test_corrupt_materialize_bitwise(ref, scope, p):
    jq = ref["model"].quantized(4)
    key = jax.random.PRNGKey(11)
    want = jdispatch.corrupt_materialize(jq, p, key, scope, use_kernel=True)
    port_q = from_reference(_arrays(jq), device="cpu")
    seeds = _leaf_seeds(key, len(port_q.to_dict()) - 1)
    common.reset_launches()
    got = port_q.corrupted_materialized(p, seeds, scope)
    assert sum(common.launches.values()) == 0      # CPU: plain version
    for leaf in ("bundles", "profiles"):
        g = getattr(got, leaf).numpy()
        w = np.asarray(getattr(want, leaf))
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    np.testing.assert_array_equal(got.codebook.numpy(),
                                  np.asarray(want.codebook))


@pytest.mark.parametrize("scope", ["all", "hv"])
@pytest.mark.parametrize("bits", [1, 4])
def test_corrupt_materialize_grid_equals_single_points(ref, scope, bits):
    """The grid form gives, point by point, the bits of the one-point
    ``corrupt_materialize`` (sigma_inv's IEEE-754 flips included), with the
    protected leaves shared and no launch on the CPU."""
    port_q = from_reference(_arrays(ref["model"]), device="cpu").quantized(
        bits)
    n_leaves = len(port_q.to_dict()) - 1
    ps = [0.0, 0.05, 0.3, 1.0, 0.05]
    seeds = [_leaf_seeds(jax.random.PRNGKey(20 + g), n_leaves)
             for g in range(len(ps))]
    common.reset_launches()
    got = port_q.corrupted_materialized_grid(ps, seeds, scope)
    assert len(got) == len(ps)
    for g, (p, row) in enumerate(zip(ps, seeds)):
        want = port_q.corrupted_materialized(p, row, scope)
        for leaf in ("bundles", "profiles", "sigma_inv", "codebook"):
            a, b = getattr(got[g], leaf), getattr(want, leaf)
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (g, leaf)
    if scope == "hv":
        assert got[0].profiles is got[-1].profiles
    assert sum(common.launches.values()) == 0
    with pytest.raises(ValueError, match="seed rows"):
        port_q.corrupted_materialized_grid(ps, seeds[:2], scope)
    with pytest.raises(ValueError, match="seeds for"):
        port_q.corrupted_materialized_grid(ps, [r[:2] for r in seeds], scope)


@pytest.mark.parametrize("p_chunk", [None, 1, 2, 4])
def test_sweep_equals_reference_loop(ref, p_chunk):
    """The port's sweep with the reference's trial seeds gives exactly the
    accuracies of a loop over the reference's kernel-path corruption and
    ``LogHDModel.predict_encoded``, in one p-chunk or several (p_chunk=2
    pads the second of its two chunks)."""
    n_trials, bits = 2, 4
    key = jax.random.PRNGKey(5)
    jq = ref["model"].quantized(bits)
    h_j, y = jnp.asarray(ref["h_te"]), ref["y_te"]
    subs = trial_keys(key, n_trials)
    want = np.zeros((len(P_GRID), n_trials), np.float32)
    for i, p in enumerate(P_GRID):
        for t in range(n_trials):
            noisy = jdispatch.corrupt_materialize(jq, p, subs[t], "all",
                                                  use_kernel=True)
            labels = JaxLogHDModel.predict_encoded(noisy, h_j)
            want[i, t] = float(jnp.mean(labels == y))
    conv = from_reference(_arrays(ref["model"]), device="cpu")
    n_leaves = len(conv.to_dict()) - 1
    seeds = [_leaf_seeds(subs[t], n_leaves) for t in range(n_trials)]
    got = sweep_under_flips(conv, bits, P_GRID, torch.from_numpy(ref["h_te"].copy()),
                            y, n_trials=n_trials, seeds=seeds,
                            predict_encoded=dispatch.predict_encoded,
                            p_chunk=p_chunk)
    # equal counts of correct labels: XLA's mean can round count / N one ulp
    # away from the division torch does
    n = len(y)
    np.testing.assert_array_equal(np.rint(got * n), np.rint(want * n))
    assert got[0, 0] == got[0, 1]          # p = 0 is the clean quantized model


@pytest.mark.parametrize("n_p,chunk", [(1, 1), (3, 1), (3, 2), (3, 3),
                                       (6, 4), (7, 3)])
def test_pad_p_grid_matches_reference(n_p, chunk):
    from repro.core.evaluate import pad_p_grid as jax_pad_p_grid
    from repro_torch.core.evaluate import pad_p_grid
    grid = [0.05 * (i + 1) for i in range(n_p)]
    want = np.asarray(jax_pad_p_grid(jnp.asarray(grid, jnp.float32), chunk))
    got = pad_p_grid(grid, chunk)
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.parametrize("p_chunk,n_calls", [(None, 1), (0, 3), (-2, 3),
                                             (1, 3), (2, 2), (3, 1),
                                             (100, 1)])
def test_sweep_p_chunk_normalisation(port_fit, ref, monkeypatch, p_chunk,
                                     n_calls):
    """p_chunk has the reference's meaning, max(1, min(p_chunk, |p_grid|))
    p values a chunk: one batched corruption a chunk, each of chunk x
    n_trials points, the same accuracy matrix, no launch on the CPU."""
    from repro_torch.api.models import HDModel
    calls = []
    real = HDModel.corrupted_materialized_grid

    def counted(self, ps, seeds, scope="all"):
        calls.append(len(ps))
        return real(self, ps, seeds, scope)
    monkeypatch.setattr(HDModel, "corrupted_materialized_grid", counted)
    h = torch.from_numpy(ref["h_te"].copy())
    kw = dict(n_trials=2, predict_encoded=dispatch.predict_encoded)
    common.reset_launches()
    got = port_fit.sweep_under_flips(
        4, P_GRID, h, ref["y_te"], p_chunk=p_chunk,
        generator=torch.Generator().manual_seed(3), **kw)
    assert len(calls) == n_calls
    chunk = len(P_GRID) if p_chunk is None else max(1, min(p_chunk, 3))
    assert calls == [chunk * 2] * n_calls
    assert sum(common.launches.values()) == 0
    calls.clear()
    want = port_fit.sweep_under_flips(
        4, P_GRID, h, ref["y_te"],
        generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(got, want)


def test_sweep_from_generator_is_reproducible(port_fit, ref):
    h = torch.from_numpy(ref["h_te"].copy())
    kw = dict(n_trials=2, predict_encoded=dispatch.predict_encoded)
    a = port_fit.sweep_under_flips(1, P_GRID, h, ref["y_te"],
                                   generator=torch.Generator().manual_seed(1),
                                   **kw)
    b = port_fit.sweep_under_flips(1, P_GRID, h, ref["y_te"],
                                   generator=torch.Generator().manual_seed(1),
                                   **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 2) and a[0, 0] >= a[2].mean()
    assert port_fit.sweep_under_flips(1, [], h, ref["y_te"]).shape == (0, 3)


def test_convert_round_trips(ref):
    for model in (ref["model"], ref["model"].quantized(4)):
        arrays = _arrays(model)
        back = to_reference(from_reference(arrays, device="cpu"))
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


def test_package_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.runtime\n"
        "import repro_torch.launch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_classifier("loghd", 5, 10, **KW)
    assert make_classifier("loghd", 5, 10, device="cpu",
                           **KW).device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(class_sharding=2),
                                dict(data_sharding=2)])
def test_sharding_options_route_to_the_sharded_fit(kw):
    """class_sharding / data_sharding above 1 fit the class-sharded
    estimator (tests/test_torch_sharded.py holds it against the
    reference)."""
    from repro_torch.api import ShardedLogHDModel
    x = np.random.default_rng(0).normal(size=(8, 10)).astype(np.float32)
    y = np.arange(8) % 2
    clf = make_classifier("loghd", 2, 10, dim=64, device="cpu",
                          refine_epochs=1, **kw)
    model = clf.fit(x, y, generator=torch.Generator().manual_seed(0)).model
    assert isinstance(model, ShardedLogHDModel)
    assert model.class_sharding == kw.get("class_sharding", 1)
    assert model.n_classes == 2 and model.kernel_dispatch is False

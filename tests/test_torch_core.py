"""The port's core modules against the JAX package on the same inputs:
numpy-seeded data and codebooks bitwise, quantized codes bitwise, the
encoder with the reference's projection injected, and the fit's math
(prototypes, bundles, profiles, decode) at float32 tolerances.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bundling as jbundling
import repro.core.codebook as jcb
import repro.core.faults as jfaults
import repro.core.loghd as jloghd
import repro.core.profiles as jprofiles
import repro.hdc.conventional as jconv
import repro.hdc.encoders as jenc
from repro.core.quantize import dequantize as jax_dequantize
from repro.core.quantize import quantize as jax_quantize
from repro.data.synth import load_dataset as jax_load_dataset
from repro_torch.core import bundling, codebook, faults, loghd, profiles
from repro_torch.data.synth import load_dataset
from repro_torch.hdc import conventional, encoders

# the module, not the function that repro_torch.core exports under its
# name (as repro.core does)
quantize = importlib.import_module("repro_torch.core.quantize")

# float32 results whose sums run in another order than XLA's
F32 = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_load_dataset_page_byte_identical():
    got = load_dataset("page")
    want = jax_load_dataset("page")
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])


def _check_quantized(got, want, w, ulps=2):
    """Codes bitwise equal at the reference's scale; the port's own scale
    within `ulps` ulp of it (see ``xla_sum`` for where its sums can run in
    another order than XLA's);
    and where the port's own codes differ, only at elements that sit on a
    rounding boundary, one code away."""
    scale = np.asarray(want.scale)
    assert got.bits == want.bits and got.codes.dtype == torch.int8
    np.testing.assert_array_equal(
        quantize.codes_for_scale(_t(w), _t(scale), want.bits).numpy(),
        np.asarray(want.codes))
    ulp = np.spacing(np.abs(scale))
    assert abs(float(got.scale) - float(scale)) <= ulps * ulp
    diff = got.codes.numpy().astype(int) - np.asarray(want.codes).astype(int)
    if diff.any():
        assert np.abs(diff).max() == 1 and want.bits > 1
        frac = np.abs(w[diff != 0] / scale) % 1.0
        np.testing.assert_allclose(frac, 0.5, atol=1e-5)
    np.testing.assert_allclose(quantize.dequantize(got).numpy(),
                               np.asarray(jax_dequantize(want)),
                               rtol=1e-6, atol=float(scale) * np.abs(diff).max(initial=0))


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("shape,seed", [((5, 512), 0), ((26, 10), 1),
                                        ((3000,), 2), ((10, 10000), 35)])
def test_quantize_matches_reference(bits, shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    _check_quantized(quantize.quantize(_t(w), bits),
                     jax_quantize(jnp.asarray(w), bits), w)


def test_quantize_seed_sweep_differs_only_at_rounding_boundaries():
    """The 1,280-case sweep (40 seeds x 4 shapes x 8 widths).  Where XLA
    rewrites the reduction into windows (a dimension longer than 32) the
    port's scale is the reference's, bit for bit.  A leaf with every
    dimension at most 32 is reduced by one small fused loop that XLA's LLVM
    back end vectorizes in an order ``xla_sum`` does not reproduce: there
    the standard deviation may sit an ulp away, which the clip factor turns
    into up to 3 ulp of the scale (76 of its 320 cases differ when
    measured), and a code may then move at an exact rounding boundary."""
    small_differs = 0
    for shape in [(5, 512), (26, 10), (3000,), (10, 10000)]:
        for seed in range(40):
            w = np.random.default_rng(seed).standard_normal(shape).astype(
                np.float32)
            for bits in range(1, 9):
                got = quantize.quantize(_t(w), bits)
                want = jax_quantize(jnp.asarray(w), bits)
                if max(shape) > 32:
                    assert float(got.scale) == float(want.scale), (shape, seed,
                                                                   bits)
                    np.testing.assert_array_equal(got.codes.numpy(),
                                                  np.asarray(want.codes))
                    continue
                small_differs += float(got.scale) != float(want.scale)
                _check_quantized(got, want, w, ulps=3)
    assert small_differs <= 80


def test_quantize_rejects_bad_bits_and_skips_in_tree():
    with pytest.raises(ValueError):
        quantize.quantize(torch.ones(3), 9)
    tree = {"bundles": torch.randn(2, 4), "codebook": torch.ones(2, 2),
            "ids": torch.arange(3), "enc": {"proj": torch.randn(2, 2)}}
    out = quantize.quantize_tree(tree, 4, skip=("codebook", "proj"))
    assert isinstance(out["bundles"], quantize.QTensor)
    assert out["codebook"] is tree["codebook"] and out["ids"] is tree["ids"]
    assert out["enc"]["proj"] is tree["enc"]["proj"]


@pytest.mark.parametrize("method", ["distance", "stratified"])
@pytest.mark.parametrize("c,n,k,seed", [(26, 10, 2, 0), (26, 5, 2, 3),
                                        (12, 4, 3, 1), (40, 8, 2, 7)])
def test_numpy_codebooks_bitwise(method, c, n, k, seed):
    got = codebook.build_codebook(c, n, k, seed=seed, method=method)
    want = jcb.build_codebook(c, n, k, seed=seed, method=method)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert codebook.verify_unique(got)


@pytest.mark.parametrize("c,n,k,seed", [(26, 7, 2, 0), (5, 3, 2, 4),
                                        (12, 4, 3, 1)])
def test_greedy_codebook_equal_with_injected_xi(c, n, k, seed):
    pool = codebook.candidate_pool(k, n, max(1 << 18, 2 * c), seed)
    xi = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (c, pool.shape[0])))
    got = codebook.build_codebook(c, n, k, seed=seed, method="greedy", xi=xi)
    want = jcb.build_codebook(c, n, k, seed=seed, method="greedy")
    np.testing.assert_array_equal(got, want)


def test_greedy_codebook_from_generator_is_unique_and_seeded():
    a = codebook.build_codebook(26, 7, 2, method="greedy",
                                generator=torch.Generator().manual_seed(5))
    b = codebook.build_codebook(26, 7, 2, method="greedy",
                                generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)
    assert codebook.verify_unique(a) and a.shape == (26, 7)


def test_budget_math_matches():
    for c in [1, 2, 5, 26, 1000, (1 << 20), (1 << 20) + 1]:
        for k in (2, 3, 4):
            assert codebook.min_bundles(c, k) == jcb.min_bundles(c, k)
    assert loghd.memory_bits(26, 10_000, 10, 4) == jloghd.memory_bits(
        26, 10_000, 10, 4)
    for x in (0.3, 0.4, 0.9):
        assert (loghd.max_bundles_for_budget(x, 26, 10_000, 2)
                == jloghd.max_bundles_for_budget(x, 26, 10_000, 2))
    cfg = loghd.LogHDConfig(n_classes=26, k=2, extra_bundles=5)
    assert cfg.n_bundles == jloghd.LogHDConfig(26, k=2,
                                               extra_bundles=5).n_bundles == 10


def _jax_encoder(f, d, kind):
    cfg = jenc.EncoderConfig(f, d, kind)
    return cfg, jenc.init_encoder(cfg)


@pytest.mark.parametrize("kind", ["cos", "rp", "rp_sign"])
def test_fit_encoder_matches_with_injected_projection(kind):
    """cos/sin and the product's summation differ by library, so h is
    compared at 2e-5 absolute on unit-norm rows."""
    x = np.random.default_rng(0).standard_normal((300, 10)).astype(np.float32)
    cfg, params = _jax_encoder(10, 256, kind)
    jp, jh = jenc.fit_encoder(cfg, jnp.asarray(x))
    tcfg = encoders.EncoderConfig(10, 256, kind)
    tp, th = encoders.fit_encoder(tcfg, x, device="cpu",
                                  proj=_t(params["proj"]),
                                  bias=_t(params["bias"]))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tp["center"].numpy(), np.asarray(jp["center"]),
                               rtol=0, atol=2e-6)
    got = encoders.encode_batched(tp, x[:50], kind, batch_size=16)
    want = jenc.encode(jp, jnp.asarray(x[:50]), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_init_encoder_draws_from_generator():
    cfg = encoders.EncoderConfig(7, 64, seed=3)
    a = encoders.init_encoder(cfg, device="cpu")
    b = encoders.init_encoder(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(a["proj"], b["proj"]) and torch.equal(a["bias"],
                                                              b["bias"])
    assert a["proj"].shape == (7, 64) and float(a["bias"].min()) >= 0.0
    assert float(a["bias"].max()) < 2 * np.pi


@pytest.fixture(scope="module")
def encoded():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((400, 128)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    y = rng.integers(0, 6, size=400).astype(np.int32)
    return h, y


def test_segment_sum_drops_out_of_range_ids():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    ids = np.array([2, 0, 2, 1, 7, -1], np.int32)
    got = conventional.segment_sum(_t(x), _t(ids), 4)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                               num_segments=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_class_prototypes_bundles_profiles_match(encoded):
    h, y = encoded
    protos = conventional.class_prototypes(_t(h), _t(y), 6)
    jprotos = jconv.class_prototypes(jnp.asarray(h), jnp.asarray(y), 6)
    np.testing.assert_allclose(protos.numpy(), np.asarray(jprotos), **F32)
    book = codebook.build_codebook(6, 5, 2, method="distance")
    for bipolar in (False, True):
        m = bundling.build_bundles(protos, book, 2, bipolar=bipolar)
        jm = jbundling.build_bundles(jprotos, jnp.asarray(book), 2,
                                     bipolar=bipolar)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **F32)
    prof = profiles.estimate_profiles(m, _t(h), _t(y), 7)
    jprof = jprofiles.estimate_profiles(jm, jnp.asarray(h), jnp.asarray(y), 7)
    np.testing.assert_allclose(prof.numpy(), np.asarray(jprof), **F32)
    assert float(prof[6].abs().sum()) == 0.0          # absent class
    np.testing.assert_array_equal(bundling.symbol_targets(book, 2).numpy(),
                                  np.asarray(jbundling.symbol_targets(book, 2)))


@pytest.mark.parametrize("metric", ["l2", "cos", "maha"])
def test_decode_profiles_match(metric, encoded):
    h, y = encoded
    rng = np.random.default_rng(9)
    prof = rng.standard_normal((6, 5)).astype(np.float32)
    acts = rng.standard_normal((200, 5)).astype(np.float32)
    a = rng.standard_normal((5, 5)).astype(np.float32)
    sigma_inv = (a @ a.T + 5 * np.eye(5)).astype(np.float32)
    got = profiles.decode_profiles(_t(prof), _t(acts), metric,
                                   sigma_inv=_t(sigma_inv))
    want = jprofiles.decode_profiles(jnp.asarray(prof), jnp.asarray(acts),
                                     metric, sigma_inv=jnp.asarray(sigma_inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        profiles.profile_scores(_t(prof), _t(acts)).numpy(),
        np.asarray(jprofiles.profile_scores(jnp.asarray(prof),
                                            jnp.asarray(acts))), **F32)
    with pytest.raises(ValueError):
        profiles.decode_profiles(_t(prof), _t(acts), "maha")


def test_fault_skip_sets_match():
    for scope in ("all", "hv"):
        assert faults.fault_skip_set(scope) == jfaults.fault_skip_set(scope)
    assert faults.STRUCTURAL_LEAVES == jfaults.STRUCTURAL_LEAVES
    with pytest.raises(ValueError):
        faults.fault_skip_set("bogus")


def test_flip_bits_f32_endpoints_and_rate():
    w = torch.randn(64, 50)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(faults.flip_bits_f32(w, 0.0, g).view(torch.int32),
                       w.view(torch.int32))
    flipped = faults.flip_bits_f32(w, 1.0, g).view(torch.int32)
    assert torch.equal(flipped, ~w.view(torch.int32))
    p = 0.1
    out = faults.flip_bits_f32(w, p, g).view(torch.int32) ^ w.view(torch.int32)
    bits = sum(int(((out >> i) & 1).sum()) for i in range(32))
    n = w.numel() * 32
    assert abs(bits / n - p) < 4 * np.sqrt(p * (1 - p) / n)

"""The port's ID-level encoder against ``repro.hdc.id_level`` on the CPU.

The reference draws its identity and level vectors with threefry, so the
parity tests carry its arrays across with ``from_reference``; the port's own
``init_id_level`` is held to the reference test's construction properties
(``tests/test_id_level.py``).  The sums before the normalisation are
integers, so they are compared exactly with numpy's integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.hdc.id_level as jid
from repro_torch.hdc import id_level
from repro_torch.hdc.id_level import (IDLevelConfig, encode_id_level,
                                      fit_id_level, id_level_sums,
                                      init_id_level, quantize_features)

# the normalised rows: float32 rounding of a sum of squares and a division
ENC_ATOL = 1e-6


def _ref_params(cfg) -> dict:
    return {k: np.asarray(v) for k, v in jid.init_id_level(
        jid.IDLevelConfig(**vars(cfg))).items()}


@pytest.mark.parametrize("levels", [2, 4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_features_bitwise(levels, seed):
    cfg = IDLevelConfig(in_features=8, dim=64, levels=levels, seed=seed)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 8)) * 3).astype(np.float32)
    # exact level boundaries and the clip edges too
    x[0] = np.linspace(-cfg.clip, cfg.clip, 8, dtype=np.float32)
    x[1] = [-1e9, 1e9, -3.0, 3.0, 0.0, -0.0, 2.9999998, -2.9999998]
    want = np.asarray(jid.quantize_features(jnp.asarray(x),
                                            jid.IDLevelConfig(**vars(cfg))))
    got = quantize_features(torch.from_numpy(x), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("f,d,levels", [(12, 256, 4), (32, 1024, 16),
                                        (617, 512, 16)])
def test_encode_matches_reference(f, d, levels):
    """With the reference's params: the sums are the exact integers, the
    normalised rows within ENC_ATOL of the reference's encoding."""
    cfg = IDLevelConfig(in_features=f, dim=d, levels=levels, seed=4)
    jcfg = jid.IDLevelConfig(**vars(cfg))
    params_np = _ref_params(cfg)
    params = id_level.from_reference(params_np, device="cpu")
    assert params["ids"].dtype == torch.float32
    x = np.random.default_rng(f).standard_normal((48, f)).astype(np.float32)
    q = np.asarray(jid.quantize_features(jnp.asarray(x), jcfg))
    ids = params_np["ids"].astype(np.int64)
    table = params_np["levels"].astype(np.int64)
    exact = np.einsum("fd,bfd->bd", ids, table[q])
    sums = id_level_sums(params, x, cfg)
    np.testing.assert_array_equal(sums.numpy(), exact.astype(np.float32))
    want = np.asarray(jid.encode_id_level(
        {k: jnp.asarray(v) for k, v in params_np.items()}, jnp.asarray(x),
        jcfg))
    got = encode_id_level(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENC_ATOL)


def test_level_table_correlation_structure():
    cfg = IDLevelConfig(in_features=4, dim=4096, levels=8, seed=0)
    t = init_id_level(cfg, device="cpu")["levels"]

    def ham(a, b):
        return float((t[a] != t[b]).float().mean())
    d1, d3, d7 = ham(0, 1), ham(0, 3), ham(0, 7)
    assert d1 < d3 < d7
    assert 0.4 < d7 < 0.6
    assert set(torch.unique(t).tolist()) == {-1.0, 1.0}


def test_zero_mean_by_construction():
    cfg = IDLevelConfig(in_features=32, dim=8192, levels=8, seed=1)
    params = init_id_level(cfg, device="cpu")
    x = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    h = encode_id_level(params, x, cfg)
    assert float(h.mean().abs()) < 0.01
    # unit rows, up to the float32 rounding of sums of 8,192 squares
    np.testing.assert_allclose(torch.linalg.vector_norm(h, dim=-1).numpy(),
                               1.0, rtol=1e-5)


@pytest.mark.parametrize("levels", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 7, 20])
def test_quantizer_range(levels, seed):
    cfg = IDLevelConfig(in_features=8, dim=256, levels=levels, seed=seed)
    x = np.random.default_rng(seed).standard_normal((16, 8)) * 5
    q = quantize_features(torch.from_numpy(x), cfg)
    assert int(q.min()) >= 0 and int(q.max()) <= levels - 1


def test_encodes_similar_inputs_similarly():
    cfg = IDLevelConfig(in_features=64, dim=8192, levels=16, seed=2)
    params = init_id_level(cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    x_near = x + 0.05 * rng.standard_normal((8, 64)).astype(np.float32)
    x_far = rng.standard_normal((8, 64)).astype(np.float32)
    h, hn, hf = (encode_id_level(params, v, cfg) for v in (x, x_near, x_far))
    sim_near = float((h * hn).sum(-1).mean())
    sim_far = float((h * hf).sum(-1).mean())
    assert sim_near > 0.95
    assert sim_near > sim_far + 0.15


def test_loghd_on_id_level_encoding():
    """The paper's pipeline on the classic encoder, the port's own draws
    (the reference test's data and threshold)."""
    from repro_torch.core.bundling import build_bundles
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.profiles import (activations, decode_profiles,
                                           estimate_profiles)
    from repro_torch.hdc.conventional import class_prototypes
    rng = np.random.default_rng(0)
    c, f = 6, 32
    dirs = rng.standard_normal((c, f))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    y = np.repeat(np.arange(c), 40)
    x = dirs[y] * 2.0 + rng.standard_normal((len(y), f)) * 0.2
    cfg = IDLevelConfig(in_features=f, dim=8192, levels=16, seed=6)
    params, h = fit_id_level(cfg, x, device="cpu")
    yt = torch.as_tensor(y)
    protos = class_prototypes(h, yt, c)
    book = torch.as_tensor(build_codebook(c, 5, 2, method="distance", seed=0))
    m = build_bundles(protos, book, 2)
    p = estimate_profiles(m, h, yt, c)
    preds = decode_profiles(p, activations(m, h))
    assert float((preds == yt).float().mean()) > 0.9
    assert params["ids"].shape == (f, 8192)


def test_init_is_seeded_and_takes_a_generator():
    cfg = IDLevelConfig(in_features=5, dim=64, levels=4, seed=3)
    a, b = init_id_level(cfg, device="cpu"), init_id_level(cfg, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in ("ids", "levels"))
    c = init_id_level(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], c[k]) for k in ("ids", "levels"))
    other = init_id_level(IDLevelConfig(5, 64, 4, seed=4), device="cpu")
    assert not torch.equal(a["ids"], other["ids"])


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = IDLevelConfig(in_features=4, dim=32)
    for call in (lambda: init_id_level(cfg),
                 lambda: fit_id_level(cfg, np.zeros((2, 4), np.float32)),
                 lambda: id_level.from_reference(
                     {"ids": np.ones((4, 32)), "levels": np.ones((16, 32))})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""The port's kernel wrappers on the CPU: their plain PyTorch versions against
the JAX package's oracles (``ref.py``) and its Pallas kernels in interpret
mode, on the same numpy-seeded inputs.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each of them against these plain versions there.
"""

import collections
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bundle_sim.ops import bundle_similarity as jax_bundle_sim
from repro.kernels.bundle_sim.ref import bundle_similarity_ref as jax_bs_ref
from repro.kernels.bundle_update.ops import bundle_update as jax_bundle_update
from repro.kernels.bundle_update.ref import bundle_update_ref as jax_bu_ref
from repro.hdc.encoders import encode as jax_encode
from repro.kernels.flip_corrupt.ops import flip_corrupt as jax_flip_corrupt
from repro.kernels.flip_corrupt.ref import flip_corrupt_ref as jax_fc_ref
from repro.kernels.hdc_encode.ops import hdc_encode as jax_hdc_encode
from repro.kernels.hdc_encode.ref import hdc_encode_ref as jax_he_ref
from repro.kernels.profile_decode.ops import \
    profile_decode_scores as jax_profile_decode
from repro.kernels.profile_decode.ref import \
    profile_decode_scores_ref as jax_pd_ref
from repro_torch.kernels import _build, common
from repro_torch.kernels.bundle_sim import bundle_similarity
from repro_torch.kernels.bundle_sim import ops as bs_ops
from repro_torch.kernels.bundle_update import bundle_update, bundle_update_ref
from repro_torch.kernels.bundle_update import ops as bu_ops
from repro_torch.kernels.flip_corrupt import (flip_corrupt, flip_corrupt_grid,
                                              flip_corrupt_grid_ref,
                                              flip_corrupt_ref)
from repro_torch.kernels.flip_corrupt import ops as fc_ops
from repro_torch.kernels.flip_corrupt.ref import _mul32, flip_threshold
from repro_torch.kernels.hdc_encode import (hdc_encode, hdc_encode_plain,
                                            hdc_encode_ref)
from repro_torch.kernels.hdc_encode import ops as he_ops
from repro_torch.hdc.encoders import encode
from repro_torch.kernels import score_stage
from repro_torch.kernels.profile_decode import ops as pd_ops
from repro_torch.kernels.profile_decode import profile_decode_scores

# the JAX package's own kernel tolerances (tests/test_kernels.py)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(x: np.ndarray, dtype: str):
    """The same numpy values as a torch tensor and a jax array of `dtype`
    (bf16 rounding is round-to-nearest-even in both)."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


@pytest.mark.parametrize("b,d,n", [(8, 256, 4), (33, 617, 5), (16, 1000, 40),
                                   (1, 10000, 10), (64, 10000, 26)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_sim_plain_matches_jax(b, d, n, dtype):
    rng = np.random.default_rng(b + d + n)
    h = rng.standard_normal((b, d)).astype(np.float32)
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    ht, hj = _pair(h, dtype)
    got = bundle_similarity(ht, torch.from_numpy(m))
    assert got.shape == (b, n) and got.dtype == torch.float32
    want_ref = np.asarray(jax_bs_ref(hj, jnp.asarray(m)))
    want_pallas = np.asarray(jax_bundle_sim(hj, jnp.asarray(m),
                                            interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL[dtype])
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL[dtype])


@pytest.mark.parametrize("b,n,c", [(8, 4, 5), (64, 6, 26), (100, 10, 26),
                                   (17, 40, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_decode_plain_matches_jax(b, n, c, dtype):
    rng = np.random.default_rng(b + n + c)
    a = rng.standard_normal((b, n)).astype(np.float32)
    p = rng.standard_normal((c, n)).astype(np.float32)
    at, aj = _pair(a, dtype)
    pt, pj = _pair(p, dtype)
    got = profile_decode_scores(at, pt)
    assert got.shape == (b, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pd_ref(aj, pj)),
                               **TOL[dtype])
    pallas = np.asarray(jax_profile_decode(aj, pj, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      pallas.argmax(-1))


# the JAX package's bundle_update shapes (tests/test_kernels.py BU_SHAPES)
@pytest.mark.parametrize("n,b,d", [(5, 32, 512), (26, 100, 1000), (3, 7, 130),
                                   (128, 64, 2048), (26, 64, 10000)])
def test_bundle_update_plain_matches_jax(n, b, d):
    rng = np.random.default_rng(n + b + d)
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    c = rng.standard_normal((b, n)).astype(np.float32)
    h = rng.standard_normal((b, d)).astype(np.float32)
    got = bundle_update(torch.from_numpy(m), torch.from_numpy(c),
                        torch.from_numpy(h), 0.01)
    assert got.shape == (n, d) and got.dtype == torch.float32
    args = (jnp.asarray(m), jnp.asarray(c), jnp.asarray(h), 0.01)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bu_ref(*args)),
                               **tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_bundle_update(*args, interpret=True)),
        **tol)
    # rows come back unit-norm (the normalisation epilogue)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(),
                               np.ones(n), rtol=1e-5)


def test_bundle_update_wrapper_is_plain_ref_on_cpu():
    rng = np.random.default_rng(9)
    m, c, h = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((4, 40), (6, 4), (6, 40)))
    assert torch.equal(bundle_update(m, c, h, 0.3),
                       bundle_update_ref(m, c, h, 0.3))


def _codes(rng, shape, bits):
    lo, hi = (0, 2) if bits == 1 else (-(1 << (bits - 1)), 1 << (bits - 1))
    return rng.integers(lo, hi, size=shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(1000,), (7, 130), (3, 5, 37)])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_flip_corrupt_plain_bit_exact(shape, bits, p):
    rng = np.random.default_rng(bits * 100 + len(shape))
    codes = _codes(rng, shape, bits)
    scale = np.float32(0.0371)
    for seed in (0, 42, (1 << 31) - 1, -(1 << 31)):
        got = flip_corrupt(torch.from_numpy(codes), torch.tensor(scale),
                           bits, p, seed).numpy()
        want = np.asarray(jax_fc_ref(jnp.asarray(codes), jnp.float32(scale),
                                     p, seed, bits=bits))
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bits,p", [(1, 0.3), (4, 0.13), (8, 0.5)])
def test_flip_corrupt_plain_matches_pallas_interpret(bits, p):
    rng = np.random.default_rng(bits)
    codes = _codes(rng, (40, 300), bits)
    got = flip_corrupt(torch.from_numpy(codes), torch.tensor(0.5), bits, p,
                       1234).numpy()
    want = np.asarray(jax_flip_corrupt(jnp.asarray(codes), jnp.float32(0.5),
                                       bits, p, 1234, interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# leaf sets of the batched flip_corrupt: a LogHD-like pair with a ragged
# profile leaf (260 codes), and ragged leaves (21 codes, 3-D, 1-D)
FC_LEAF_SETS = {"pair": [(6, 130), (26, 10)],
                "ragged": [(21,), (3, 5, 37), (1001,)]}


def _grid_inputs(shapes, bits, n_points, p, seed=0):
    rng = np.random.default_rng(seed)
    leaves = [(torch.from_numpy(_codes(rng, shape, bits)),
               torch.tensor(np.float32(0.0371 * (j + 1))), bits)
              for j, shape in enumerate(shapes)]
    seeds = rng.integers(-(1 << 31), 1 << 31, size=(n_points, len(shapes)))
    seeds[0, 0] = -(1 << 31)
    seeds[-1, -1] = (1 << 31) - 1
    return leaves, [p] * n_points, seeds.tolist()


@pytest.mark.parametrize("leaf_set", sorted(FC_LEAF_SETS))
@pytest.mark.parametrize("n_points", [1, 5, 18])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("p", [0.0, 0.05, 1.0])
def test_flip_corrupt_grid_plain_equals_single_leaf_calls(leaf_set, n_points,
                                                          bits, p):
    """The batched plain version equals G x L one-point, one-leaf calls bit
    for bit, each point with its own seeds."""
    leaves, ps, seeds = _grid_inputs(FC_LEAF_SETS[leaf_set], bits, n_points,
                                     p)
    got = flip_corrupt_grid_ref(leaves, ps, seeds)
    assert len(got) == len(leaves)
    for j, (codes, scale, b) in enumerate(leaves):
        assert got[j].shape == (n_points, *codes.shape)
        assert got[j].dtype == torch.float32
        for g in range(n_points):
            want = flip_corrupt_ref(codes, scale, ps[g], seeds[g][j], bits=b)
            assert torch.equal(got[j][g].view(torch.int32),
                               want.view(torch.int32))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_flip_corrupt_grid_plain_matches_pallas_interpret(bits):
    """Each grid point of the batched plain version equals the JAX
    package's Pallas kernel (interpret mode, counter hash) at its (p,
    seed)."""
    leaves, _, seeds = _grid_inputs([(40, 300), (26, 10)], bits, 3, 0.0,
                                    seed=bits)
    ps = [0.05, 0.3, 1.0]
    got = flip_corrupt_grid(leaves, ps, seeds)
    for j, (codes, scale, b) in enumerate(leaves):
        for g, p in enumerate(ps):
            want = np.asarray(jax_flip_corrupt(
                jnp.asarray(codes.numpy()), jnp.float32(scale.item()), b, p,
                seeds[g][j], interpret=True, use_pltpu_prng=False))
            np.testing.assert_array_equal(got[j][g].numpy().view(np.int32),
                                          want.view(np.int32))


def test_flip_corrupt_grid_wrapper_is_plain_on_cpu_and_counts_nothing():
    leaves, ps, seeds = _grid_inputs(FC_LEAF_SETS["ragged"], 4, 5, 0.1)
    common.reset_launches()
    got = flip_corrupt_grid(leaves, ps, seeds)
    want = flip_corrupt_grid_ref(leaves, ps, seeds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flip_corrupt_grid([], ps, [[] for _ in ps]) == []
    empty = flip_corrupt_grid(leaves, [], [])
    assert [tuple(e.shape) for e in empty] == [(0, *c.shape)
                                               for c, _, _ in leaves]
    assert sum(common.launches.values()) == 0


def test_flip_corrupt_grid_argument_checks():
    leaves, ps, seeds = _grid_inputs([(4, 5), (7,)], 4, 3, 0.1)
    common.reset_launches()
    with pytest.raises(ValueError, match="seed rows"):
        flip_corrupt_grid(leaves, ps, seeds[:2])
    with pytest.raises(ValueError, match="seeds for 2 leaves"):
        flip_corrupt_grid(leaves, ps, [row[:1] for row in seeds])
    for bad in (1 << 31, -(1 << 31) - 1):
        with pytest.raises(ValueError, match="int32"):
            flip_corrupt_grid(leaves, ps, [[bad, 0]] * 3)
    for bits in (0, 9):
        with pytest.raises(ValueError, match="bits"):
            flip_corrupt_grid([(leaves[0][0], leaves[0][1], bits)], ps,
                              [[0]] * 3)
    with pytest.raises(TypeError, match="int8"):
        flip_corrupt_grid([(leaves[0][0].to(torch.int32), leaves[0][1], 4)],
                          ps, [[0]] * 3)
    with pytest.raises(TypeError, match="contiguous"):
        flip_corrupt_grid([(leaves[0][0].T, leaves[0][1], 4)], ps, [[0]] * 3)
    with pytest.raises(ValueError, match="one value"):
        flip_corrupt_grid([(leaves[0][0], torch.ones(2), 4)], ps, [[0]] * 3)
    with pytest.raises(ValueError, match="different devices"):
        flip_corrupt_grid([leaves[0], (torch.zeros(3, dtype=torch.int8,
                                                   device="meta"),
                                       torch.tensor(1.0, device="meta"), 4)],
                          ps, seeds)
    assert sum(common.launches.values()) == 0


@pytest.mark.parametrize("n_leaves,n_points,want", [
    (1, 1, [(0, 1, 0, 1)]),
    (2, 18, [(0, 2, 0, 18)]),
    (4, 128, [(0, 4, 0, 128)]),
    (5, 3, [(0, 4, 0, 3), (4, 5, 0, 3)]),
    (3, 130, [(0, 3, 0, 128), (0, 3, 128, 130)]),
    (9, 257, [(l0, min(l0 + 4, 9), g0, min(g0 + 128, 257))
              for l0 in (0, 4, 8) for g0 in (0, 128, 256)]),
    (2, 0, []),
])
def test_flip_corrupt_launch_plan(n_leaves, n_points, want):
    """A call takes one launch while it fits the kernel's parameter struct,
    and one per block of leaves and points beyond it; every (leaf, point)
    is covered once."""
    plan = fc_ops.launch_plan(n_leaves, n_points)
    assert plan == want
    cover = collections.Counter((j, g) for l0, l1, g0, g1 in plan
                                for j in range(l0, l1) for g in range(g0, g1))
    assert set(cover.values()) <= {1} and len(cover) == n_leaves * n_points


def test_flip_corrupt_limits_match_the_kernel_source():
    src = (_build.CSRC / "flip_corrupt.cu").read_text()
    assert f"constexpr int kMaxLeaves = {fc_ops.MAX_LEAVES};" in src
    assert f"constexpr int kMaxPoints = {fc_ops.MAX_POINTS};" in src
    assert "__grid_constant__ Params" in src
    # one kernel body, templated on bits
    assert src.count("__global__") == 1
    assert "template <int BITS>" in src


def test_mul32_wraps_exactly():
    """The int64 half-word product equals the 32-bit wrapped product, also
    for the largest words, whose full product would overflow int64."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 1 << 32, size=2000, dtype=np.uint64),
                         np.array([0, 1, (1 << 32) - 1], np.uint64)])
    x = torch.from_numpy(xs.astype(np.int64))
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D, 0x846CA68B,
              0xFFFFFFFF):
        got = _mul32(x, c).numpy()
        want = np.array([(int(v) * c) & 0xFFFFFFFF for v in xs], np.int64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 1e-8, 0.1, 0.5, 0.999999, 1.0, 1.5, -0.2])
def test_flip_threshold_matches_reference(p):
    from repro.kernels.flip_corrupt.flip_corrupt import \
        flip_threshold as jax_threshold
    assert flip_threshold(p) == int(jax_threshold(jnp.float32(p)))


# the JAX package's hdc_encode shapes and tolerance (tests/test_kernels.py
# ENC_SHAPES, rtol 2e-4 / atol 2e-5)
ENC_SHAPES = [(8, 10, 256), (64, 617, 1024), (100, 75, 2000), (32, 561, 4096),
              (64, 617, 10000)]
ENC_TOL = dict(rtol=2e-4, atol=2e-5)


def _enc_inputs(b, f, d):
    """x (B, F), proj (F, D), bias in [0, 2 pi) and a small center, as the
    JAX package's test draws them, from numpy."""
    rng = np.random.default_rng(b + f + d)
    x = rng.standard_normal((b, f)).astype(np.float32)
    w = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, d).astype(np.float32)
    center = (rng.standard_normal(d) * 0.01).astype(np.float32)
    return x, w, bias, center


def _l2n(v):
    return v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)


@pytest.mark.parametrize("b,f,d", ENC_SHAPES)
@pytest.mark.parametrize("kind", ["cos", "rp", "rp_sign"])
def test_hdc_encode_plain_matches_jax(b, f, d, kind):
    x, w, bias, center = _enc_inputs(b, f, d)
    tx, tw, tb, tc = map(torch.from_numpy, (x, w, bias, center))
    jx, jw, jb, jc = map(jnp.asarray, (x, w, bias, center))
    # the kernel's contract, unnormalised: nonlin(x W) - center
    np.testing.assert_allclose(hdc_encode_ref(tx, tw, tb, tc, kind).numpy(),
                               np.asarray(jax_he_ref(jx, jw, jb, jc, kind)),
                               **ENC_TOL)
    got = hdc_encode(tx, tw, tb, tc, kind)
    assert got.shape == (b, d) and got.dtype == torch.float32
    want = _l2n(_l2n(jax_he_ref(jx, jw, jb, jnp.zeros((d,)), kind)) - jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    pallas = jax_hdc_encode(jx, jw, jb, jc, kind=kind, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **ENC_TOL)


@pytest.mark.parametrize("kind", ["cos", "rp", "rp_sign"])
def test_encode_matches_reference_encode(kind):
    """The port's encode (through hdc_encode) against the JAX package's
    encode on the same injected proj, bias and center."""
    x, w, bias, center = _enc_inputs(37, 617, 1000)
    params = {"proj": w, "bias": bias, "center": center}
    got = encode({k: torch.from_numpy(v) for k, v in params.items()}, x,
                 kind)
    want = jax_encode({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    # leading dimensions pass through
    got3 = encode({k: torch.from_numpy(v) for k, v in params.items()},
                  x[:36].reshape(4, 9, 617), kind)
    assert got3.shape == (4, 9, 1000)


def test_hdc_encode_cpu_route_is_plain_and_counts_nothing():
    x, w, bias, center = map(torch.from_numpy, _enc_inputs(5, 11, 70))
    common.reset_launches()
    for kind in ("cos", "rp", "rp_sign"):
        assert torch.equal(hdc_encode(x, w, bias, center, kind),
                           hdc_encode_plain(x, w, bias, center, kind))
    encode({"proj": w, "bias": bias, "center": center}, x)
    assert sum(common.launches.values()) == 0
    with pytest.raises(ValueError, match="unknown encoder kind"):
        hdc_encode(x, w, bias, center, "sin")
    with pytest.raises(ValueError, match="do not fit"):
        hdc_encode(x[:, :5], w, bias, center)
    with pytest.raises(ValueError, match="do not fit"):
        hdc_encode(x, w, bias[:3], center)


def test_cpu_tensors_take_plain_version_and_count_nothing():
    common.reset_launches()
    h = torch.randn(4, 64)
    m = torch.nn.functional.normalize(torch.randn(3, 64), dim=-1)
    acts = bundle_similarity(h, m)
    profile_decode_scores(acts, torch.randn(5, 3))
    flip_corrupt(torch.zeros(10, dtype=torch.int8), torch.tensor(1.0), 4, 0.5,
                 3)
    bundle_update(m, torch.randn(4, 3), h, 0.1)
    assert sum(common.launches.values()) == 0
    assert not common.on_card(h, m)


def test_wrapper_argument_checks():
    codes = torch.zeros(10, dtype=torch.int8)
    with pytest.raises(ValueError):
        flip_corrupt(codes, torch.tensor(1.0), 9, 0.1, 0)
    with pytest.raises(ValueError):
        flip_corrupt(codes, torch.tensor(1.0), 0, 0.1, 0)
    with pytest.raises(ValueError):
        flip_corrupt(codes, torch.tensor(1.0), 4, 0.1, 1 << 31)
    with pytest.raises(ValueError):
        common.on_card(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        common.kernel_device(torch.device("meta"))


def test_plain_flip_corrupt_is_plain_ref():
    """The wrapper's CPU route is exactly the plain version."""
    codes = torch.from_numpy(_codes(np.random.default_rng(5), (6, 9), 4))
    a = flip_corrupt(codes, torch.tensor(0.25), 4, 0.2, 77)
    b = flip_corrupt_ref(codes, torch.tensor(0.25), 0.2, 77, bits=4)
    assert torch.equal(a, b)


def test_build_names_every_source_by_hash():
    names = _build.kernel_names()
    assert names == ["bundle_sim", "bundle_update", "flash_attn",
                     "flip_corrupt", "hdc_encode", "loghd_head", "moe_slots",
                     "profile_decode"]
    for name in names:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---- launch geometry of the two redesigned kernels (pure functions of the
# shapes, computed in Python and checked again by the C entries)

GEO_SHAPES = [(1, 617, 10000), (64, 617, 10000), (1559, 617, 10000),
              (4096, 617, 10000), (37, 61, 1001), (5, 10, 130),
              (70, 33, 2004), (65, 1, 81), (3, 617, 40000)]


@pytest.mark.parametrize("b,f,d", GEO_SHAPES)
def test_encode_geometry_covers_every_row_and_column_once(b, f, d):
    geo = he_ops.encode_geometry(b, f, d)
    gx, gy = geo.gemm_grid
    # the product: row blocks of BM rows and column blocks of BN columns,
    # the last of each ragged and none empty
    rows = [r for blk in range(gx) for r in range(blk * he_ops.BM,
                                                  (blk + 1) * he_ops.BM)
            if r < b]
    cols = [c for blk in range(gy) for c in range(blk * he_ops.BN,
                                                  (blk + 1) * he_ops.BN)
            if c < d]
    assert rows == list(range(b)) and cols == list(range(d))
    assert (gx - 1) * he_ops.BM < b and (gy - 1) * he_ops.BN < d
    assert geo.partial_shape == (b, gy)
    # the normalisation: each row taken by exactly one cluster, each column
    # of a row by exactly one block rank
    taken = sorted(r for c in range(geo.norm_rows)
                   for r in range(c, b, geo.norm_rows))
    assert taken == list(range(b))
    chunks = [d_ for rank in range(geo.cluster)
              for d_ in range(rank * geo.chunk,
                              min(d, (rank + 1) * geo.chunk))]
    assert chunks == list(range(d))
    assert geo.cluster in (1, 2, 4, 8)
    assert geo.cluster * geo.norm_rows <= he_ops.NORM_MAX_BLOCKS
    # what the C entry checks, and what the card allows
    assert geo.gemm_threads == he_ops.THREADS == 512
    assert geo.smem_bytes == he_ops.SMEM_BYTES <= 227 * 1024
    assert geo.stages == he_ops.STAGES and geo.norm_threads == 256


@pytest.mark.parametrize("f,d", [(617, 10000), (61, 1001), (10, 130),
                                 (33, 2004)])
def test_encode_summation_order_does_not_depend_on_b(f, d):
    """Everything that fixes an element's sum (the column tile, the
    compiled tiles and stages, a grid with no split-K dimension) and a
    row's sums of squares (the column blocks, the cluster and its chunks)
    is the same for every B; only the row dimensions grow with B."""
    bs = (1, 2, 63, 64, 65, 1559, 4096)
    geos = [he_ops.encode_geometry(b, f, d) for b in bs]
    keys = {(g.gemm_grid[1], g.partial_shape[1], g.cluster, g.chunk,
             g.gemm_threads, g.smem_bytes, g.stages) for g in geos}
    assert len(keys) == 1
    assert all(len(g.gemm_grid) == 2 for g in geos)
    assert [g.gemm_grid[0] for g in geos] == [-(-b // he_ops.BM) for b in bs]


def test_encode_geometry_raises_where_grid_cannot_launch():
    assert he_ops.MAX_ROWS + he_ops.NORM_MAX_BLOCKS <= 2**31 - 1
    he_ops.encode_geometry(he_ops.MAX_ROWS, 617, 80)
    with pytest.raises(ValueError, match="rows exceed"):
        he_ops.encode_geometry(he_ops.MAX_ROWS + 1, 617, 80)
    with pytest.raises(ValueError, match="column blocks"):
        he_ops.encode_geometry(4, 8, 65536 * he_ops.BN)


UPD_GEO = [(10, 64, 10000), (20, 64, 10000), (26, 64, 4000),
           (26, 256, 10000), (40, 37, 1000), (3, 7, 130), (100, 64, 10000),
           (33, 1, 65)]


@pytest.mark.parametrize("n,b,d", UPD_GEO)
@pytest.mark.parametrize("capacity", [1, 37, 264, 396, 10**6])
def test_update_tiles_cover_every_entry_once(n, b, d, capacity):
    geo = bu_ops.update_geometry(n, b, d)
    blocks = bu_ops.launch_blocks(geo, capacity)
    assert blocks == min(geo.tiles, capacity) >= 1
    assert geo.kj % 4 == 0 and min(n, 4) <= geo.kj <= bu_ops.MAX_KJ
    assert geo.kj >= min(n, bu_ops.MAX_KJ)
    assert geo.partial_shape == (n, geo.col_blocks)
    assert geo.threads == bu_ops.THREADS == 256
    # block k walks tiles k, k + blocks, ...; tile t is column block
    # t % col_blocks of row chunk t // col_blocks
    seen = collections.Counter()
    for k in range(blocks):
        for t in range(k, geo.tiles, blocks):
            cb, j0 = t % geo.col_blocks, t // geo.col_blocks * geo.kj
            for j in range(j0, min(n, j0 + geo.kj)):
                seen[(j, cb)] += 1
    assert seen == {(j, cb): 1 for j in range(n)
                    for cb in range(geo.col_blocks)}
    assert (geo.col_blocks - 1) * bu_ops.COLS < d
    assert d <= geo.col_blocks * bu_ops.COLS


def test_update_geometry_does_not_depend_on_b():
    assert len({bu_ops.update_geometry(10, b, 10000)
                for b in (1, 30, 64, 256, 4096)}) == 1


def test_update_raises_where_the_grid_cannot_be_launched():
    geo = bu_ops.update_geometry(10, 64, 10000)
    for capacity in (0, -2):
        with pytest.raises(RuntimeError, match="occupancy"):
            bu_ops.launch_blocks(geo, capacity)


# ---- bundle_sim's launch geometry: a thread-block cluster splits each row
# along D; only the clusters grow with B

BS_GEO = [(b, d, n) for b in (1, 64, 1559)
          for d in (10000, 4000, 5200, 617, 1000)
          for n in (3, 10, 20, 26, 40)]


@pytest.mark.parametrize("b,d,n", BS_GEO)
def test_bundle_sim_geometry_covers_every_row_column_bundle_once(b, d, n):
    geo = bs_ops.bundle_sim_geometry(b, d, n, 15)
    assert geo.grid == (geo.cluster * geo.clusters, geo.bundle_chunks)
    # rows: cluster c walks the tiles c, c + clusters, ... of ROWS rows
    rows = collections.Counter(
        r for c in range(geo.clusters)
        for tile in range(c, geo.tiles, geo.clusters)
        for r in range(tile * geo.rows, min(b, (tile + 1) * geo.rows)))
    assert rows == collections.Counter(range(b))
    assert geo.rows == bs_ops.ROWS and (geo.tiles - 1) * geo.rows < b
    # columns: rank r owns [r chunk, (r + 1) chunk); in pass p warp w takes
    # 32 w + 16 half + 4 t + e (t, e < 4) of the pass's PASS columns
    cols = collections.Counter(
        col for r in range(geo.cluster) for p in range(geo.passes)
        for w in range(bs_ops.PASS // 32) for half in range(2)
        for t in range(4) for e in range(4)
        for col in [r * geo.chunk + p * bs_ops.PASS + 32 * w + 16 * half
                    + 4 * t + e] if col < d)
    assert cols == collections.Counter(range(d))
    assert geo.chunk == geo.passes * bs_ops.PASS
    assert (geo.cluster - 1) * geo.chunk < d <= geo.cluster * geo.chunk
    assert 1 <= geo.cluster <= bs_ops.MAX_CLUSTER
    # bundles: grid-y chunk y holds [y kc, (y + 1) kc)
    bundles = collections.Counter(
        j for y in range(geo.bundle_chunks)
        for j in range(y * geo.kc, min(n, (y + 1) * geo.kc)))
    assert bundles == collections.Counter(range(n))
    assert geo.kc in bs_ops.KC_SIZES and (geo.bundle_chunks - 1) * geo.kc < n
    assert geo.threads == bs_ops.THREADS


@pytest.mark.parametrize("d,n", [(10000, 10), (10000, 26), (4000, 26),
                                 (5200, 20), (1000, 40), (617, 5),
                                 (40000, 26)])
def test_bundle_sim_summation_order_does_not_depend_on_b(d, n):
    """Everything that fixes a row's sums (the cluster and its chunks, the
    passes, the bundle chunks, the compiled kernel and its stages) is the
    same for every B; only the clusters of the grid's x grow with B."""
    bs = (1, 2, 63, 64, 65, 1559, 4096)
    cap = 15
    geos = [bs_ops.bundle_sim_geometry(b, d, n, cap) for b in bs]
    keys = {(g.cluster, g.chunk, g.passes, g.rows, g.kc, g.bundle_chunks,
             g.stages, g.smem_bytes, g.threads, g.grid[1]) for g in geos}
    assert len(keys) == 1
    assert [g.grid[0] for g in geos] == [
        geos[0].cluster * min(-(-b // bs_ops.ROWS), cap) for b in bs]


def test_bundle_sim_geometry_raises_where_it_cannot_launch():
    with pytest.raises(ValueError, match="B, D, n >= 1"):
        bs_ops.bundle_sim_geometry(0, 10000, 10)
    with pytest.raises(ValueError, match="B, D, n >= 1"):
        bs_ops.bundle_sim_geometry(4, 10000, 0)
    bs_ops.bundle_sim_geometry(bs_ops.MAX_ROWS, 256, 3)
    with pytest.raises(ValueError, match="rows exceed"):
        bs_ops.bundle_sim_geometry(bs_ops.MAX_ROWS + 1, 256, 3)
    # a chunk of M too large for a block's shared memory even at 8 bundles
    with pytest.raises(ValueError, match="shared memory"):
        bs_ops.bundle_sim_geometry(4, 50000, 3)
    with pytest.raises(ValueError, match="bundle chunks"):
        bs_ops.bundle_sim_geometry(4, 10000, 32 * 65535 + 1)
    for cap in (0, -2):
        with pytest.raises(RuntimeError, match="clusters"):
            bs_ops.bundle_sim_geometry(4, 10000, 10, cap)


@pytest.mark.parametrize("d", [256, 617, 1000, 4000, 5200, 10000, 20000,
                               40000])
def test_bundle_sim_shared_memory_fits_at_every_n(d):
    for n in range(1, 2 * bs_ops.KC_SIZES[-1] + 1):
        geo = bs_ops.bundle_sim_geometry(64, d, n, 15)
        assert 2 <= geo.stages <= bs_ops.MAX_STAGES
        assert geo.smem_bytes == bs_ops.smem_bytes(geo.kc, geo.chunk,
                                                   geo.stages)
        assert geo.smem_bytes <= bs_ops.SMEM_MAX < 227 * 1024
    # the serving and predict shapes keep at least 3 stages in flight
    if d <= 10000:
        assert bs_ops.bundle_sim_geometry(64, d, 26, 15).stages >= 3


def test_bundle_sim_geometry_matches_the_compiled_kernel():
    """The constants ops.py computes with are the ones csrc/bundle_sim.cu
    compiles."""
    src = (_build.CSRC / "bundle_sim.cu").read_text()
    assert "constexpr int kConsumers = 256;" in src
    assert "constexpr int kThreads = kConsumers + 32;" in src
    assert bs_ops.THREADS == 256 + 32
    assert "constexpr int kRows = 16;" in src and bs_ops.ROWS == 16
    assert "constexpr int kPass = kWarps * 32;" in src
    assert bs_ops.PASS == (256 // 32) * 32
    assert f"constexpr int kMaxCluster = {bs_ops.MAX_CLUSTER};" in src
    assert f"constexpr int kMaxStages = {bs_ops.MAX_STAGES};" in src
    assert "constexpr int kSmemMax = 232448 - 128;" in src
    assert bs_ops.SMEM_MAX == 232448 - 128
    assert ("#define BS_BUNDLES(X) "
            + " ".join(f"X({k})" for k in bs_ops.KC_SIZES)) in src


# ---- the score stage's launch geometry (profile_decode, and loghd_head's
# second launch): a pure function of the shapes, checked again in C

PD_GEO = [(b, n, c) for b in (1, 4, 64, 65, 1559) for n in (1, 7, 10, 20,
                                                            33, 64)
          for c in (5, 26, 70, 1001)] + [(64, 16, 65536), (3, 100, 33),
                                         (300, 200, 10)]


def _score_cover(geo, b, c):
    """How often the launch writes each (row, profile): block (x, y), warp
    w (warp column w % wc, warp row w // wc), row tiles w // wc + wr i, then
    the staged tile's rows and columns, as csrc/score_stage.cuh walks
    them."""
    seen = np.zeros((b, c), dtype=np.int64)
    rows_x, v_y = geo.grid
    for x in range(rows_x):
        r0 = x * geo.rows
        nrow = min(geo.rows, b - r0)
        for y in range(v_y):
            v0 = y * geo.vb
            cnt = min(geo.vb, c - v0)
            for w in range(score_stage.WARPS):
                vl = (w % geo.wc) * score_stage.WARP_V
                if vl >= cnt:
                    continue
                for tile in range(w // geo.wc, geo.wr * geo.t, geo.wr):
                    rl = tile * score_stage.TILE_ROWS
                    if rl >= nrow:
                        break
                    rhere = min(score_stage.TILE_ROWS, b - (r0 + rl))
                    chere = min(score_stage.WARP_V, c - (v0 + vl))
                    seen[r0 + rl:r0 + rl + rhere,
                         v0 + vl:v0 + vl + chere] += 1
    return seen


@pytest.mark.parametrize("b,n,c", PD_GEO)
def test_profile_decode_geometry_covers_every_row_and_profile_once(b, n, c):
    for bf16 in (False, True):
        geo = pd_ops.profile_decode_geometry(b, n, c, bf16, 396)
        assert geo.threads == score_stage.THREADS
        assert geo.wc * geo.wr == score_stage.WARPS
        assert geo.vb == score_stage.WARP_V * geo.wc
        assert geo.rows == score_stage.TILE_ROWS * geo.wr * geo.t
        assert geo.wr * geo.t <= score_stage.MAX_WARP_TILES
        assert (_score_cover(geo, b, c) == 1).all()
        # the k-steps cover n once: chunks x ks steps of 8, zeros past n
        assert geo.n_pad == 8 * geo.ks * geo.chunks >= n > geo.n_pad - 8 * geo.ks


def test_score_fragments_and_staging_cover_a_tile_once():
    """mma.m16n8k8's accumulator entry e of lane (g, t) is row g + 8 (e // 2),
    column 2 t + e % 2 of its n-tile: the four n-tiles of a warp stage each
    of the 16 x 32 outputs once, and its A and B fragments read each k of a
    step once per row and per profile."""
    staged = collections.Counter()
    a_read, b_read = collections.Counter(), collections.Counter()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for nt in range(4):
            for e in range(4):
                staged[(g + 8 * (e // 2), 8 * nt + 2 * t + e % 2)] += 1
            for e in range(2):
                b_read[(8 * nt + g, t + 4 * e)] += 1
        for e in range(4):
            a_read[(g + 8 * (e % 2), t + 4 * (e // 2))] += 1
    assert staged == {(r, col): 1 for r in range(16) for col in range(32)}
    assert a_read == {(r, k): 1 for r in range(16) for k in range(8)}
    assert b_read == {(v, k): 1 for v in range(32) for k in range(8)}


@pytest.mark.parametrize("n,c", [(10, 26), (20, 26), (16, 65536), (40, 70),
                                 (7, 45), (64, 151936), (100, 33)])
def test_profile_decode_summation_order_does_not_depend_on_b(n, c):
    """What fixes a row's sums (the k-steps and chunks of n) is the same for
    every B, and rows and profiles sit at the same place of their MMA tile
    (b % 16, c % 8) in every block, so a row's bits do not depend on B."""
    bs = (1, 2, 15, 16, 17, 63, 64, 65, 512, 1559, 4096)
    for bf16 in (False, True):
        geos = [pd_ops.profile_decode_geometry(b, n, c, bf16, 396)
                for b in bs]
        assert len({(g.ks, g.chunks, g.n_pad) for g in geos}) == 1
        assert all(g.rows % score_stage.TILE_ROWS == 0 for g in geos)
        assert all(g.vb % 8 == 0 for g in geos)


@pytest.mark.parametrize("c", [26, 70, 65536, 151936])
def test_profile_decode_shared_memory_fits_at_every_n(c):
    for n in range(1, 65):
        for b in (1, 64, 1559):
            for bf16 in (False, True):
                geo = pd_ops.profile_decode_geometry(b, n, c, bf16, 396)
                esize = 2 if bf16 else 4
                held = score_stage.rows_held(geo.rows, b)
                assert geo.smem_bytes == score_stage.smem_bytes(
                    geo.vb, n, esize, held, esize)
                assert geo.smem_bytes <= score_stage.SMEM_MAX < 227 * 1024


def test_profile_decode_geometry_raises_where_it_cannot_launch():
    for bad in ((0, 10, 26), (4, 0, 26), (4, 10, 0)):
        with pytest.raises(ValueError, match="B, C, n >= 1"):
            pd_ops.profile_decode_geometry(*bad)
    pd_ops.profile_decode_geometry(score_stage.MAX_ROWS, 10, 26)
    with pytest.raises(ValueError, match="rows exceed"):
        pd_ops.profile_decode_geometry(score_stage.MAX_ROWS + 1, 10, 26)
    # profiles too wide for one block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        pd_ops.profile_decode_geometry(64, 5000, 26)
    # more spans of 256 profiles than a grid's y takes
    with pytest.raises(ValueError, match="blocks of 256 profiles"):
        pd_ops.profile_decode_geometry(4, 10, 256 * score_stage.GRID_Y + 1)
    for cap in (0, -2):
        with pytest.raises(RuntimeError, match="holds"):
            pd_ops.profile_decode_geometry(4, 10, 26, False, cap)
    with pytest.raises(ValueError, match="bytes"):
        score_stage.score_geometry(4, 26, 10, 4, 8)


def test_score_geometry_matches_the_compiled_kernel():
    """The constants score_stage.py computes with are the ones
    csrc/score_stage.cuh compiles, and both kernels' sources use it."""
    src = (_build.CSRC / "score_stage.cuh").read_text()
    assert f"constexpr int kThreads = {score_stage.THREADS};" in src
    assert "constexpr int kWarps = kThreads / 32;" in src
    assert score_stage.WARPS == score_stage.THREADS // 32
    assert f"constexpr int kWarpV = {score_stage.WARP_V};" in src
    assert f"constexpr int kTileRows = {score_stage.TILE_ROWS};" in src
    assert f"constexpr int kMaxWarpTiles = {score_stage.MAX_WARP_TILES};" in src
    assert "constexpr int kStagePitch = kWarpV + 4;" in src
    assert score_stage.STAGE_PITCH == score_stage.WARP_V + 4
    assert f"constexpr int kHoldSteps = {score_stage.HOLD_STEPS};" in src
    assert f"constexpr int kChunkSteps = {score_stage.CHUNK_STEPS};" in src
    assert "constexpr int kSmemMax = 232448 - 1024;" in src
    assert score_stage.SMEM_MAX == 232448 - 1024
    assert ("#define SCORE_STEPS(X) "
            + " ".join(f"X({k})" for k in score_stage.KS_SIZES)) in src
    assert "return n <= 16 ? 2 : n <= 24 ? 3 : n <= 32 ? 4 : kChunkSteps;" in src
    assert [score_stage.steps_for(n) for n in (1, 16, 17, 24, 25, 32, 33, 64,
                                               65)] == [2, 2, 3, 3, 4, 4, 8,
                                                        8, 8]
    for name in ("profile_decode", "loghd_head"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "score_stage.cuh"]


def test_build_hash_covers_included_headers(tmp_path):
    """Editing a header a kernel includes changes that kernel's library
    name, so a stale build is never reused; other kernels keep theirs."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.library_path(n, csrc) for n in _build.kernel_names()}
    assert before == {n: _build.library_path(n) for n in _build.kernel_names()}
    header = csrc / "score_stage.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in _build.kernel_names()}
    for name in _build.kernel_names():
        changed = name in ("profile_decode", "loghd_head")
        assert (after[name] != before[name]) == changed, name


def test_pdl_switch_and_cpu_route():
    """``pdl=True`` changes nothing on the CPU (the plain version, no
    launch); ``common.pdl`` switches the chained launches off inside its
    block and restores the setting after it, also on an error."""
    a, p = torch.randn(5, 7), torch.randn(9, 7)
    common.reset_launches()
    assert torch.equal(profile_decode_scores(a, p, pdl=True),
                       profile_decode_scores(a, p))
    assert sum(common.launches.values()) == 0
    assert common.pdl_enabled()
    with common.pdl(False):
        assert not common.pdl_enabled()
    assert common.pdl_enabled()
    with pytest.raises(KeyError):
        with common.pdl(False):
            raise KeyError("x")
    assert common.pdl_enabled()

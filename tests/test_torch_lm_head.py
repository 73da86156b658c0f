"""The port's LogHD vocab head on the CPU: the plain version of the
``loghd_head`` kernel and ``api.dispatch.loghd_head_scores`` against the
JAX package's oracle (``repro.kernels.loghd_head.ref``), its Pallas kernel
in interpret mode and its dispatch, on the same numpy-seeded inputs.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
this plain version there.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.dispatch import loghd_head_scores as jax_loghd_head_scores
from repro.kernels.loghd_head.ops import loghd_head_logits as jax_loghd_head
from repro.kernels.loghd_head.ref import loghd_head_logits_ref as jax_lh_ref
from repro_torch.api.dispatch import loghd_head_scores
from repro_torch.kernels import _build, common, score_stage
from repro_torch.kernels.loghd_head import (MAX_N, loghd_head_logits,
                                            loghd_head_logits_ref)
from repro_torch.kernels.loghd_head import ops as lh_ops

# tests/test_kernels.py's LH_SHAPES (B, D, n, V), and the LM's decode step
# at qwen3-1.7b's width: 4 slots, D = 2048, n = 20 bundles, V = 151,936
LH_SHAPES = [
    (8, 256, 4, 64),
    (32, 1024, 18, 4096),
    (100, 2048, 20, 2048),
    (16, 2048, 18, 151936),
]
DECODE_SHAPE = (4, 2048, 20, 151936)
# the JAX package's own loghd_head tolerances (tests/test_kernels.py:128-129)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-1)}


def _inputs(b, d, n, v, dtype):
    """h ~ N(0, 1), m ~ N(0, 1/D), p ~ N(0, 1) as the reference's kernel
    test draws them, from numpy, as a torch triple and a jax triple of
    `dtype` (bf16 rounding is round-to-nearest-even in both)."""
    rng = np.random.default_rng(b + d + n + v)
    arrays = (rng.standard_normal((b, d)).astype(np.float32),
              (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32),
              rng.standard_normal((v, n)).astype(np.float32))
    ts = [torch.from_numpy(a) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    if dtype == "bfloat16":
        ts = [t.to(torch.bfloat16) for t in ts]
        js = [j.astype(jnp.bfloat16) for j in js]
    return ts, js


@pytest.mark.parametrize("b,d,n,v", LH_SHAPES + [DECODE_SHAPE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle_and_pallas(b, d, n, v, dtype):
    (h, m, p), (hj, mj, pj) = _inputs(b, d, n, v, dtype)
    got = loghd_head_logits(h, m, p)
    assert got.shape == (b, v) and got.dtype == torch.float32
    got = got.numpy()
    want_ref = np.asarray(jax_lh_ref(hj, mj, pj))
    want_pallas = np.asarray(jax_loghd_head(hj, mj, pj, interpret=True))
    np.testing.assert_allclose(got, want_ref, **TOL[dtype])
    np.testing.assert_allclose(got, want_pallas, **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), want_ref.argmax(-1))
        np.testing.assert_array_equal(got.argmax(-1), want_pallas.argmax(-1))


def test_bf16_profiles_read_as_stored_equal_the_f32_cast():
    """The dispatch casts the profiles to float32; the port passes them as
    stored, and widening bf16 is exact, so both give the same logits."""
    (h, m, p), _ = _inputs(16, 256, 12, 500, "bfloat16")
    np.testing.assert_array_equal(loghd_head_logits(h, m, p).numpy(),
                                  loghd_head_logits(h, m, p.float()).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_take_any_leading_shape(dtype):
    (h, m, p), (hj, mj, pj) = _inputs(4, 32, 10, 300, dtype)
    out2 = loghd_head_scores(h, m, p)
    out4 = loghd_head_scores(h.reshape(2, 2, 32), m, p)
    assert out4.shape == (2, 2, 300) and out4.dtype == torch.float32
    np.testing.assert_array_equal(out4.reshape(4, 300).numpy(), out2.numpy())
    np.testing.assert_array_equal(out2.numpy(),
                                  loghd_head_logits_ref(h, m, p).numpy())
    # the reference's dispatch (its jnp branch on the CPU) at its leading
    # shape; at bf16 that branch rounds x M^T to bf16 first, the kernel
    # contract does not, so only the f32 case is compared there
    if dtype == "float32":
        want = jax_loghd_head_scores(hj.reshape(2, 2, 32), mj, pj,
                                     use_kernel=False)
        np.testing.assert_allclose(out4.numpy(), np.asarray(want),
                                   **TOL["float32"])


def test_cpu_route_counts_no_launch():
    (h, m, p), _ = _inputs(4, 64, 6, 100, "float32")
    common.reset_launches()
    loghd_head_logits(h, m, p)
    loghd_head_scores(h[None], m, p)
    assert common.launches["loghd_head"] == 0


def test_argument_checks():
    (h, m, p), _ = _inputs(4, 64, 6, 100, "float32")
    with pytest.raises(ValueError, match="do not fit"):
        loghd_head_logits(h[:, :32].contiguous(), m, p)       # D differs
    with pytest.raises(ValueError, match="do not fit"):
        loghd_head_logits(h, m, p[:, :5].contiguous())        # n differs
    with pytest.raises(TypeError, match="dtype"):
        loghd_head_logits(h.double(), m, p)
    with pytest.raises(TypeError, match="dtype"):
        loghd_head_logits(h, m, p.half())
    with pytest.raises(ValueError, match="2-D"):
        loghd_head_logits(h[None], m, p)
    with pytest.raises(ValueError, match="contiguous"):
        loghd_head_logits(h, m, p.T.contiguous().T)
    wide = torch.zeros((MAX_N + 1, 64))
    with pytest.raises(ValueError, match="bundles"):
        loghd_head_logits(h, wide, torch.zeros((100, MAX_N + 1)))
    with pytest.raises(ValueError, match="D > 0"):
        loghd_head_logits(torch.zeros((4, 0)), torch.zeros((6, 0)), p)
    with pytest.raises(ValueError, match="different devices"):
        loghd_head_logits(h, m, p.to("meta"))
    # empty batches and vocabularies are fine
    assert loghd_head_logits(h[:0], m, p).shape == (0, 100)
    assert loghd_head_logits(h, m, p[:0]).shape == (4, 0)


# ---- loghd_head's launch geometry: the A stage, then the score stage of
# kernels/score_stage.py; a pure function of the shapes, checked again in C

LH_GEO = [(b, d, n, v) for b in (1, 4, 63, 64, 65, 512) for d in (256, 2048)
          for n in (1, 4, 18, 20, 33, 64) for v in (64, 1003, 4096)]


@pytest.mark.parametrize("b,d,n,v", LH_GEO)
def test_geometry_covers_every_row_and_column_once(b, d, n, v):
    for p_bf16 in (True, False):
        geo = lh_ops.loghd_head_geometry(b, d, n, v, p_bf16, 396)
        # the A stage: blocks of act_rows rows x act_bundles bundles
        tile = geo.act_tile
        assert tile == (1 if b < lh_ops.ACT_ROWS_MIN else lh_ops.ACT_TILE)
        acts = collections.Counter(
            (x * tile + r, y * tile + q) for x in range(geo.act_grid[0])
            for y in range(geo.act_grid[1]) for r in range(tile)
            for q in range(tile) if x * tile + r < b and y * tile + q < n)
        assert acts == {(r, j): 1 for r in range(b) for j in range(n)}
        assert geo.scratch == b * n and geo.act_threads == 256
        # the score stage: every (row, vocab entry) once
        s = geo.score
        seen = np.zeros((b, v), dtype=np.int64)
        for x in range(s.grid[0]):
            r0 = x * s.rows
            for y in range(s.grid[1]):
                v0 = y * s.vb
                for w in range(score_stage.WARPS):
                    vl = (w % s.wc) * score_stage.WARP_V
                    if vl >= min(s.vb, v - v0):
                        continue
                    for tile_i in range(w // s.wc, s.wr * s.t, s.wr):
                        rl = tile_i * score_stage.TILE_ROWS
                        if rl >= min(s.rows, b - r0):
                            break
                        seen[r0 + rl:r0 + rl + min(16, b - r0 - rl),
                             v0 + vl:v0 + vl + min(32, v - v0 - vl)] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("n", [4, 18, 20, 33, 64])
def test_geometry_summation_order_does_not_depend_on_b(n):
    """A's sums run in the one order of a single dot product in either
    A-stage block shape, and the score stage's k-steps and chunks come from
    n alone, rows and vocab entries sitting at b % 16 and v % 8 of their MMA
    tiles in every block."""
    geos = [lh_ops.loghd_head_geometry(b, 2048, n, 151936, True, 396)
            for b in (1, 2, 4, 16, 63, 64, 65, 512, 2048)]
    assert len({(g.score.ks, g.score.chunks, g.score.n_pad) for g in geos}) == 1
    assert all(g.score.rows % 16 == 0 and g.score.vb % 8 == 0 for g in geos)
    assert {g.act_threads for g in geos} == {lh_ops.ACT_THREADS}


def test_geometry_shared_memory_fits_at_every_n():
    for n in range(1, lh_ops.MAX_N + 1):
        for b in (1, 4, 64, 512):
            for p_bf16 in (True, False):
                s = lh_ops.loghd_head_geometry(b, 2048, n, 151936, p_bf16,
                                               396).score
                assert s.smem_bytes == score_stage.smem_bytes(
                    s.vb, n, 2 if p_bf16 else 4,
                    score_stage.rows_held(s.rows, b), 4)
                assert s.smem_bytes <= score_stage.SMEM_MAX < 227 * 1024


def test_geometry_raises_where_it_cannot_launch():
    for bad in ((0, 2048, 20, 100), (4, 0, 20, 100), (4, 2048, 0, 100),
                (4, 2048, 20, 0)):
        with pytest.raises(ValueError, match="B, D, n, V >= 1"):
            lh_ops.loghd_head_geometry(*bad)
    with pytest.raises(ValueError, match="bundles"):
        lh_ops.loghd_head_geometry(4, 2048, MAX_N + 1, 100)
    with pytest.raises(ValueError, match="rows exceed"):
        lh_ops.loghd_head_geometry(score_stage.MAX_ROWS + 1, 16, 4, 100)
    with pytest.raises(ValueError, match="blocks of 256 profiles"):
        lh_ops.loghd_head_geometry(4, 16, 4, 256 * score_stage.GRID_Y + 1)
    with pytest.raises(RuntimeError, match="holds"):
        lh_ops.loghd_head_geometry(4, 2048, 20, 100, True, 0)


def test_geometry_matches_the_compiled_kernel():
    """The A stage's constants in ops.py are the ones csrc/loghd_head.cu
    compiles, and its score stage is csrc/score_stage.cuh's."""
    src = (_build.CSRC / "loghd_head.cu").read_text()
    assert f"constexpr int kMaxN = {MAX_N};" in src
    assert f"constexpr int kActThreads = {lh_ops.ACT_THREADS};" in src
    assert f"constexpr int kActRowsMin = {lh_ops.ACT_ROWS_MIN};" in src
    t = lh_ops.ACT_TILE
    assert f"acts_kernel<TH, TM, {t}, {t}><<<dim3((B + {t - 1}) / {t}, " \
           f"(n + {t - 1}) / {t})" in src
    assert "acts_kernel<TH, TM, 1, 1><<<dim3(B, n)" in src
    assert '#include "score_stage.cuh"' in src
    assert [p.name for p in _build.sources("loghd_head")] == [
        "loghd_head.cu", "score_stage.cuh"]

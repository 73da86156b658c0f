"""The MoE routing's capacity slots (``repro_torch.kernels.moe_slots``).

On the CPU the wrapper is the plain one-hot cumsum, held here against a
brute-force count of each choice's earlier choices of the same expert at
the routing shapes of granite-moe (E = 32, top-8), jamba (16, top-2) and
deepseek-v3 (256, top-8): a decode step (T = 4), a ragged call and a
4,096-token one, at capacity factors 1.25 and E / k (no drops).  The
tests marked ``card`` hold the CUDA kernel to the plain version exactly on
an H100 (``python -m pytest -m card tests/test_torch_moe_slots.py`` on the
card); without one they skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.moe_slots import (MAX_EXPERTS, moe_slots,
                                           moe_slots_ref)
from repro_torch.kernels.moe_slots import ops as ms_ops
from repro_torch.models.moe import MoE, MoEConfig

ARCHS = [(32, 8), (16, 2), (256, 8)]           # granite, jamba, deepseek
TOKENS = [4, 1000, 4096]


def _choices(t: int, e: int, k: int, seed: int) -> np.ndarray:
    """(T, k) distinct experts a token, as top-k gives them."""
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((t, e)), axis=1)[:, :k]


def _brute(flat: np.ndarray, cap: int):
    seen: dict = {}
    slot = np.empty(len(flat), np.int64)
    for i, x in enumerate(flat.tolist()):
        slot[i] = seen.get(x, 0)
        seen[x] = slot[i] + 1
    keep = slot < cap
    return np.where(keep, slot, cap - 1), keep


def _cases():
    out = []
    for e, k in ARCHS:
        for t in TOKENS:
            for cf in (1.25, e / k):
                out.append((e, k, t, cf))
    return out


CASES = _cases()
CASE_IDS = [f"E{e}-k{k}-T{t}-cf{cf:g}" for e, k, t, cf in CASES]


def _cap(e: int, k: int, t: int, cf: float) -> int:
    return MoEConfig(d_model=8, d_ff=8, n_experts=e, top_k=k,
                     capacity_factor=cf).capacity(t)


@pytest.mark.parametrize("e,k,t,cf", CASES, ids=CASE_IDS)
def test_plain_slots_match_a_brute_force_count(e, k, t, cf):
    flat = _choices(t, e, k, seed=e * 7919 + t).reshape(-1)
    cap = _cap(e, k, t, cf)
    slots, keep = moe_slots(torch.from_numpy(flat), e, cap)
    want_slots, want_keep = _brute(flat, cap)
    assert slots.dtype == torch.int64 and keep.dtype == torch.bool
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == e / k:
        assert bool(keep.all())            # no drops at capacity factor E/k


def test_plain_slots_one_expert_cap_one():
    """Every choice to one expert under a capacity of one: the first is
    kept in slot 0, every later one dropped onto slot cap - 1 = 0."""
    flat = np.full(777, 5, np.int64)
    slots, keep = moe_slots(torch.from_numpy(flat), 8, 1)
    want_slots, want_keep = _brute(flat, 1)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert int(keep.sum()) == 1 and not bool(slots.any())


def test_cpu_route_counts_no_launch():
    """A CPU tensor takes the plain version: neither the wrapper nor
    ``MoE.route`` counts a launch."""
    cfg = MoEConfig(d_model=16, d_ff=8, n_experts=32, top_k=8)
    moe = MoE(cfg, device="cpu", dtype=torch.float32)
    moe.init_weights(torch.Generator().manual_seed(0))
    common.reset_launches()
    flat = torch.from_numpy(_choices(10, 32, 8, seed=1).reshape(-1))
    assert all(torch.equal(a, b) for a, b in zip(
        moe_slots(flat, 32, 3), moe_slots_ref(flat, 32, 3)))
    r = moe.route(torch.randn(10, 16, generator=torch.Generator()
                              .manual_seed(2)))
    want_slots, want_keep = _brute(r.experts.reshape(-1).numpy(), r.cap)
    np.testing.assert_array_equal(r.slots.numpy(), want_slots)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    assert common.launches["moe_slots"] == 0


def test_meta_route_gives_shapes_without_a_launch():
    """The dry run's meta tensors take the plain expression: shapes and
    dtypes, no launch."""
    common.reset_launches()
    slots, keep = moe_slots(torch.empty(4 * 8, dtype=torch.int64,
                                        device="meta"), 256, 5)
    assert slots.is_meta and keep.is_meta
    assert slots.shape == keep.shape == (32,)
    assert slots.dtype == torch.int64 and keep.dtype == torch.bool
    assert common.launches["moe_slots"] == 0


def test_blocks_cover_every_tile_and_match_the_compiled_kernel():
    """ops.py's constants are the ones csrc/moe_slots.cu compiles, and the
    blocks split the tiles into equal runs that cover them all."""
    src = (_build.CSRC / "moe_slots.cu").read_text()
    assert "constexpr int kTile = kWarps * kSteps * 32;" in src
    assert "constexpr int kThreads = 256;" in src
    assert "constexpr int kSteps = 8;" in src
    assert ms_ops.TILE == (256 // 32) * 8 * 32
    assert f"constexpr int kMaxBlocks = {ms_ops.MAX_BLOCKS};" in src
    assert f"constexpr int kMaxExperts = {MAX_EXPERTS};" in src
    assert "moe_slots" in _build.kernel_names()
    for n in (0, 1, 32, 2048, 2049, 8000, 262_144, 524_288, 524_289,
              2048 * 300 + 17, 8 * 1024 * 1024):
        blocks = ms_ops.moe_slots_blocks(n)
        tiles = -(-n // ms_ops.TILE)
        assert blocks <= ms_ops.MAX_BLOCKS
        if tiles == 0:
            assert blocks == 0
            continue
        per = -(-tiles // blocks)
        assert (blocks - 1) * per < tiles <= blocks * per
    assert ms_ops.moe_slots_blocks(262_144) == 128    # granite: one wave


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernel has no CPU mode")
    return torch.device("cuda")


def _check_on_card(dev, flat_np: np.ndarray, e: int, cap: int):
    flat = torch.from_numpy(flat_np).to(dev)
    common.reset_launches()
    slots, keep = moe_slots(flat, e, cap)
    assert common.launches["moe_slots"] == 1
    want_slots, want_keep = moe_slots_ref(flat, e, cap)
    torch.cuda.synchronize()
    assert torch.equal(slots, want_slots) and torch.equal(keep, want_keep)


@pytest.mark.card
@pytest.mark.parametrize("e,k,t,cf", CASES + [(32, 8, 32_768, 1.25)],
                         ids=CASE_IDS + ["E32-k8-T32768-cf1.25"])
def test_kernel_equals_plain_on_card(card, e, k, t, cf):
    _check_on_card(card, _choices(t, e, k, seed=e + t).reshape(-1), e,
                   _cap(e, k, t, cf))


@pytest.mark.card
def test_kernel_one_expert_and_limits_on_card(card):
    _check_on_card(card, np.full(5000, 3, np.int64), 8, 1)
    with pytest.raises(ValueError):
        moe_slots(torch.zeros(8, dtype=torch.int64, device=card),
                  MAX_EXPERTS + 1, 4)

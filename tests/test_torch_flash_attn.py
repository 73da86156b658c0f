"""The fused attention kernels' plain version (``repro_torch.kernels.
flash_attn``) and the path chooser of ``models.attention._sdpa``.

On the CPU the wrapper is the plain version in ``ref.py``: the forward with
its log-sum-exp, and the backward from the saved log-sum-exp, both reached
through the autograd Function that the card runs.  They are held in
float32 against ``_sdpa``'s einsum path (the reference's arithmetic) and
against autograd through it, at GQA width 64, MLA's widths 192 / 128, a
query offset, a sequence that is not a multiple of the kernel's tile and
full (non-causal) attention.  The tests marked ``card`` hold the CUDA
kernels to the plain version on an H100 (``python -m pytest -m card
tests/test_torch_flash_attn.py`` on the card); without one they skip.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import attention as attn

# b, s, t, h, kvh, d, dv, causal, q0
CASES = [
    (2, 96, 96, 4, 2, 64, 64, True, 0),        # GQA at width 64
    (1, 80, 80, 3, 3, 192, 128, True, 0),      # MLA's widths, few heads
    (1, 48, 176, 2, 1, 64, 64, True, 128),     # queries at q0 > 0
    (1, 200, 200, 2, 2, 64, 64, True, 0),      # S not a multiple of 128
    (2, 40, 72, 4, 2, 128, 128, False, 0),     # full attention
]
IDS = ["gqa64", "mla192-128", "q0", "ragged", "noncausal"]


def _inputs(case, seed: int = 0):
    b, s, t, h, kvh, d, dv, causal, q0 = case
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return (draw(b, s, h, d), draw(b, t, kvh, d), draw(b, t, kvh, dv),
            draw(b, s, h * dv), 1.0 / math.sqrt(d), causal, q0)


def _einsum(q, k, v, scale, causal, q0):
    return attn._sdpa_einsum(q, k, v, scale, causal=causal, q0=q0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_and_lse_match_the_einsum_path(case):
    q, k, v, _, scale, causal, q0 = _inputs(case)
    o, lse = fa.flash_attn_ref(q, k, v, scale, causal=causal, q0=q0)
    want = _einsum(q, k, v, scale, causal, q0)
    torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
    # the log-sum-exp of each (row, head) over the keys it sees
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kr = attn._repeat_kv(k, g)
    logits = torch.einsum("bshd,bthd->bhst", q, kr) * scale
    seen = fa.ref.visible(s, k.shape[1], causal, q0, q.device)
    logits = logits.masked_fill(~seen, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_from_the_lse_matches_autograd(case):
    """The Function's backward (the plain version from the saved lse)
    against autograd through the einsum path, and the plain backward
    called directly with the einsum path's output."""
    q, k, v, do, scale, causal, q0 = _inputs(case, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attn(*leaves, scale, causal=causal, q0=q0)
    o.backward(do)
    got = [t.grad for t in leaves]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_ref = _einsum(*ref, scale, causal, q0)
    o_ref.backward(do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b.grad, rtol=1e-4, atol=1e-5)
    _, lse = fa.flash_attn_ref(q, k, v, scale, causal=causal, q0=q0)
    direct = fa.flash_attn_bwd_ref(do, q, k, v, o_ref.detach(), lse, scale,
                                   causal=causal, q0=q0)
    for a, b in zip(direct, ref):
        torch.testing.assert_close(a, b.grad, rtol=1e-4, atol=1e-5)
    assert common.launches["flash_attn_bwd"] == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_in_bf16_stays_near_the_einsum_path(case):
    """bf16 inputs: the plain version (float32 inside, rounded once at the
    end) and the einsum path (bf16 logits and probabilities) agree to
    bf16's resolution."""
    q, k, v, _, scale, causal, q0 = _inputs(case, seed=2)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o = fa.flash_attn(q, k, v, scale, causal=causal, q0=q0)
    want = _einsum(q, k, v, scale, causal, q0)
    assert o.dtype == want.dtype == torch.bfloat16
    err = (o.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) < 2e-2


def test_the_path_chooser_sends_cpu_and_other_widths_to_the_einsum_path():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert not fa.takes(q, kv, kv)                   # CPU tensors
    # the compiled widths: granite's 64, qwen3 / jamba / mistral's 128,
    # MLA's 192 / 128; gemma3's 256 and the test configs' tiny widths are
    # not among them
    assert set(fa.PAIRS) == {(64, 64), (128, 128), (192, 128)}
    for pair in ((256, 256), (16, 16), (192, 192), (128, 64)):
        assert pair not in fa.PAIRS
    before = dict(attn.SDPA_PATHS)
    out = attn._sdpa(q, kv, kv, 0.125)
    assert out.shape == (1, 8, 128)
    assert attn.SDPA_PATHS["einsum"] == before.get("einsum", 0) + 1
    assert attn.SDPA_PATHS["flash"] == before.get("flash", 0)


def test_tma_layout_rule_copies_only_what_a_tensor_map_cannot_read():
    base = torch.zeros(2, 16, 4 * 64 + 8)
    view = base[..., :256].reshape(2, 16, 4, 64)     # row stride 264
    assert fa_ops._mapped(view) is view
    odd = torch.zeros(2, 16, 4 * 64 + 3)[..., :256].reshape(2, 16, 4, 64)
    assert fa_ops._mapped(odd) is not odd            # stride 259: copied
    assert fa_ops._mapped(odd).is_contiguous()
    assert fa_ops.s_pad(1) == 128 and fa_ops.s_pad(4096) == 4096
    assert fa_ops.s_pad(4097) == 4224


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_matches_plain_on_card(card, case):
    q, k, v, do, scale, causal, q0 = _inputs(case, seed=3)
    q, k, v, do = (t.to(card, torch.bfloat16) for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    common.reset_launches()
    o = fa.flash_attn(*leaves, scale, causal=causal, q0=q0)
    o.backward(do)
    torch.cuda.synchronize()
    assert common.launches["flash_attn_fwd"] == 1
    assert common.launches["flash_attn_bwd"] == 1
    o_r, lse_r = fa.flash_attn_ref(q, k, v, scale, causal=causal, q0=q0)
    want = fa.flash_attn_bwd_ref(do, q, k, v, o.detach(), lse_r, scale,
                                 causal=causal, q0=q0)

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())
    assert rel(o.detach(), o_r) < 1e-2
    for t, w in zip(leaves, want):
        assert rel(t.grad, w) < 2e-2

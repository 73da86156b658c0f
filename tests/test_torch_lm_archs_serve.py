"""Decode and serving of granite-moe, deepseek-v3, jamba and xlstm in the
port against the JAX package's, at float32 smoke size under both heads
(weights and helpers of ``test_torch_lm_archs.py``): teacher-forced
``decode_step`` logits and decode states, and greedy ``run_serving`` of
the launcher's traffic token for token.

Tolerances: logits and states rtol = atol = 1e-4 (measured within 2.9e-5);
served tokens exactly.
"""

import numpy as np
import pytest
import torch

import test_torch_lm_archs as A
from repro.runtime import serve_loop as rserve
from repro_torch.launch import serve as pserve_cli
from repro_torch.runtime import serve_loop as pserve

@pytest.mark.parametrize("head", ["dense", "loghd"])
@pytest.mark.parametrize("arch", A.ARCHS)
def test_decode_logits_and_states_match_reference(arch, head):
    """Teacher-forced ``decode_step`` over (2, 6) tokens: every step's
    logits, and every leaf of the decode state after the last step (KV,
    compressed MLA, Mamba conv / ssm and xLSTM states), in the reference's
    layout and dtypes."""
    rc, pc, params, model = A.pair(arch, head=head)
    tokens = A._tokens(rc.vocab, 2, 6, seed=3)
    got, state = A.port_decode_all(pc, model, tokens)
    want, want_state = A.ref_decode_all(rc, params, tokens)
    A._close(got, want)
    assert state.keys() == want_state.keys()
    for key in state:
        assert len(state[key]) == len(want_state[key])
        for mine, theirs in zip(state[key], want_state[key]):
            assert mine.keys() == theirs.keys()
            for leaf in mine:
                assert mine[leaf].dtype == getattr(torch, str(
                    theirs[leaf].dtype)), (key, leaf)
                A._close(mine[leaf], theirs[leaf])


def serve_both(rc, pc, params, model, reqs, **serve_kw):
    """(port's tokens, reference's tokens) for `reqs`."""
    want = rserve.run_serving(rc, params, [rserve.Request(r.uid, r.prompt)
                                           for r in reqs],
                              rserve.ServeLoopConfig(**serve_kw))
    got = pserve.run_serving(pc, model, reqs,
                             pserve.ServeLoopConfig(**serve_kw))
    assert got.keys() == want.keys()
    return got, {u: np.asarray(v) for u, v in want.items()}


@pytest.mark.parametrize("head", ["dense", "loghd"])
@pytest.mark.parametrize("arch", A.ARCHS)
def test_greedy_serving_equals_reference(arch, head):
    """The launcher's traffic (6 requests, 4 slots, 16 new tokens,
    ``max_len`` 256), greedy, token for token."""
    rc, pc, params, model = A.pair(arch, head=head)
    got, want = serve_both(rc, pc, params, model,
                       pserve_cli.requests_for(pc, 6, seed=0),
                       batch_slots=4, max_new_tokens=16, max_len=256)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
        assert len(got[uid]) == 17

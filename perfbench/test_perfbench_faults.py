"""Whole runs of each cell, cut to CPU sizes (``small_cells.py``), past the
harness's look for a card: a sound run comes out correct, and a run with
its timed path broken underneath comes out not correct, once for each
fault the cell can have."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from perfbench import harness, small_cells

CPU = torch.device("cpu")
SEED = 2**31 + 3


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, CPU)


def test_sound_classify_run_is_correct():
    out = _run(small_cells.classify_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 64 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"classify_rows_s", "setup_s"}


def _stale_refine(bundles, hh, tt, lr, *a, **k):
    return bundles


def test_a_refine_step_that_returns_its_state_is_caught():
    import repro_torch.api.fit_engine as fe
    with mock.patch.object(fe, "refine_step", _stale_refine), \
            mock.patch.object(fe, "_refine_step_kernel", _stale_refine):
        out = _run(small_cells.classify_cell())
    assert not out["correct"]
    assert out["checks"]["state_err"]["value"] > \
        out["checks"]["state_err"]["limit"]


def test_a_label_altered_where_it_is_produced_is_caught():
    import repro_torch.api.dispatch as dp
    plain = dp.predict_encoded

    def altered(model, h, use_kernels=None):
        labels = plain(model, h, use_kernels).clone()
        labels[-1] = (labels[-1] + 1) % model.profiles.shape[0]
        return labels
    with mock.patch.object(dp, "predict_encoded", altered):
        out = _run(small_cells.classify_cell())
    assert not out["correct"]
    assert out["checks"]["label_gap"]["value"] > \
        out["checks"]["label_gap"]["limit"]


def test_sound_train_run_is_correct():
    out = _run(small_cells.train_cell())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tokens_s", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged_is_caught():
    import repro_torch.runtime.train_loop as tl
    with mock.patch.object(tl, "adamw_update", lambda *a, **k: None):
        out = _run(small_cells.train_cell())
    assert not out["correct"]
    assert out["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught():
    import repro_torch.runtime.train_loop as tl
    full = tl.loss_fn

    def half(params, cfg, tokens, targets, mesh=None, **kw):
        b = tokens.shape[0] // 2
        return full(params, cfg, tokens[:b], targets[:b], mesh, **kw)
    with mock.patch.object(tl, "loss_fn", half):
        out = _run(small_cells.train_cell())
    assert not out["correct"], out["checks"]

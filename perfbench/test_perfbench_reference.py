"""The plain references against the program at small sizes on the CPU,
where the program takes its plain versions: the classifier's fit and
predict at a small D, the LM's loss, gradients and AdamW step at
granite's smoke sizes.  And the controls: the same references one
precision below, which the cells' comparisons have to fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness, small_cells
from perfbench.drivers import classify, lm_train
from perfbench.frozen import synth, tokens
from perfbench.reference import classifier as ref_clf
from perfbench.reference import lm as ref_lm
from perfbench.reference.precision import FP8, TF32, round_fp8, round_tf32

CPU = torch.device("cpu")


def test_tf32_and_fp8_rounding():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-12,
                      -3.0 - 2.0**-10], dtype=torch.float32)
    # 10 mantissa bits, ties to even
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2.0**-9, 1.0, -3.0]
    y = torch.tensor([448.0, 1.0, 0.3])
    assert round_fp8(y).tolist() == [448.0, 1.0, 0.3125]
    g = torch.ones(3, requires_grad=True)
    (round_fp8(g * 0.3) * 2).sum().backward()
    assert g.grad.tolist() == pytest.approx([0.6] * 3)


def _classify_inputs(seed=5):
    cfg = small_cells.classify_cell().config
    x_tr, y_tr, x_pool, _, _ = synth.load_pool(
        cfg["dataset"], 2, seed=seed, max_train=cfg["n_train"], batch_rows=64)
    x_tr, y_tr = torch.from_numpy(x_tr), torch.from_numpy(y_tr)
    proj, bias, perms = classify.draws(cfg, seed, CPU, x_tr.shape[0])
    return cfg, x_tr, y_tr, torch.from_numpy(x_pool[0]), proj, bias, perms


def test_classifier_reference_agrees_with_the_program():
    cfg, x_tr, y_tr, x, proj, bias, perms = _classify_inputs()
    port = classify.Port(CPU)
    port.fit(cfg, x_tr, y_tr, proj, bias, perms, 5)
    st = ref_clf.fit(x_tr, y_tr, proj, bias, perms, cfg, 5)
    got = port.state()
    assert np.array_equal(got["codebook"], st.codebook)
    for k in ("bundles", "profiles", "center"):
        torch.testing.assert_close(got[k], getattr(st, k), rtol=0, atol=2e-6)
    h = port.encode(x)
    torch.testing.assert_close(h, ref_clf.encode(st, x), rtol=0, atol=1e-6)
    assert torch.equal(port.predict_encoded(h), ref_clf.predict(st, h))


def test_classifier_control_fails_the_cells_limits():
    cell = small_cells.classify_cell()
    out = harness.run_cell(cell, 9, 0.2, False, CPU,
                           system=classify.Control(cell.config, CPU))
    assert not out["correct"], out["checks"]
    sound = harness.run_cell(cell, 9, 0.2, False, CPU)
    for k in ("state_err", "enc_err"):
        assert out["checks"][k]["value"] > 30 * sound["checks"][k]["value"]


def _lm_setup(seed=4):
    cell = small_cells.train_cell()
    cfg, tr = cell.config, cell.traffic
    port = lm_train.Port(cfg, CPU)
    port.build(lm_train.make_weights(cfg["model"], seed, CPU))
    pipe = tokens.TokenPipeline(vocab=cfg["model"]["vocab"],
                                seq_len=tr["seq_len"],
                                global_batch=tr["batch"], seed=seed,
                                device="cpu")
    p = {n: w.float() for n, w in lm_train.make_weights(cfg["model"], seed,
                                                        CPU)}
    return cfg, port, pipe, p


def test_lm_reference_loss_and_gradients_agree_with_the_program():
    from repro_torch.models.model import loss_fn
    cfg, port, pipe, p = _lm_setup()
    b = pipe.batch(0)
    loss = loss_fn(port.model, port.pc, b["tokens"], b["targets"])
    names = [n for n, _ in port.model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(port.model.parameters()))))
    want_loss, want = ref_lm.Step(cfg).grads(p, b["tokens"], b["targets"])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(want) == {n.replace("body.0.", "layers.") for n in names}
    for n, g in want.items():
        torch.testing.assert_close(grads[lm_train.port_name(n)], g,
                                   rtol=1e-4, atol=1e-6)


def test_lm_reference_adamw_agrees_with_the_program():
    cfg, port, pipe, p = _lm_setup()
    step = ref_lm.Step(cfg)
    state = step.init_opt(p)
    for s in range(3):
        b = pipe.batch(s)
        port.step(b, s)
        _, g = step.grads(p, b["tokens"], b["targets"])
        step.update(p, g, state, step.lr(s))
    for n, v in p.items():
        torch.testing.assert_close(port.param(n).detach(), v, rtol=1e-4,
                                   atol=1e-6)


def test_lm_control_reads_far_above_the_program():
    cell = small_cells.train_cell()
    sound = harness.run_cell(cell, 8, 0.2, False, CPU)
    ctl = harness.run_cell(cell, 8, 0.2, False, CPU,
                           system=lm_train.Control(cell.config, CPU))
    assert sound["correct"], sound["checks"]
    assert not ctl["correct"], ctl["checks"]
    for k in ("loss_gap", "grad_gap", "step_gap"):
        assert ctl["checks"][k]["value"] > 100 * sound["checks"][k]["value"]
    assert FP8.name == "fp8" and TF32.name == "tf32"

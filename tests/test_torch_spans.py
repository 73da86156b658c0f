"""``repro_torch.spans``: the training step's spans on the CPU.

Without a profiler a span is a no-op that never reaches
``record_function``; under a CPU ``torch.profiler`` the seven spans of a
granite-shaped training step (attention, MoE routing and experts, the
LogHD head, remat, a chunked loss) appear in the trace, nested on their
thread as the code nests them; and profiling changes no bit of the loss
or of the updated state.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from _torch_threads import one_thread  # noqa: F401 (a fixture)

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import stacked_layers
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import TrainLoopConfig, make_train_step

LAYER = ("repro_torch.attention", "repro_torch.moe.route",
         "repro_torch.moe.experts", "repro_torch.head")
TRAIN = ("repro_torch.train.forward", "repro_torch.train.backward",
         "repro_torch.train.optimizer")


def _cfg():
    # two chunks of the loss, every block checkpointed
    return dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                               head="loghd", loss_chunk=16,
                               remat_policy="full")


def _steps(n: int = 2):
    """The model, the AdamW state and the losses after `n` steps."""
    cfg = _cfg()
    model = init_params(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig()
    opt = adamw_init(dict(model.named_parameters()), opt_cfg,
                     stacked_layers(model))
    step = make_train_step(cfg, opt_cfg, TrainLoopConfig(total_steps=4))
    g = torch.Generator().manual_seed(1)
    losses = []
    for s in range(n):
        tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
        batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
        model, opt, loss = step(model, opt, batch, s)
        losses.append(loss)
    return model, opt, losses


def test_without_a_profiler_a_span_never_enters_record_function(
        monkeypatch, one_thread):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span("repro_torch.attention") as got:
        assert got is None
    assert spans.span("repro_torch.head") is spans.span("repro_torch.x")
    _, _, losses = _steps(1)
    assert torch.isfinite(losses[0])


def _nested(events: list, inner: str, *outer: str) -> bool:
    """Whether every `inner` range lies inside a range of one of `outer`
    on its own thread."""
    def ranges(*names):
        return [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") in names and e.get("ph") == "X"]
    outs = ranges(*outer)
    return all(any(t == u and a <= s and f <= b for u, a, b in outs)
               for t, s, f in ranges(inner))


def test_the_seven_spans_appear_nested_under_a_profiler(tmp_path,
                                                        one_thread):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _steps(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert set(names) == set(LAYER + TRAIN)
    # one step: each step span once; two blocks and two loss chunks, each
    # run forward and again in the backward's recomputation
    assert all(names.count(n) == 1 for n in TRAIN)
    assert all(names.count(n) == 4 for n in LAYER)
    # the layers in the forward or the backward (remat), the routing
    # outside the experts, the optimizer after both
    for name in LAYER:
        assert _nested(events, name, *TRAIN[:2])
        assert not _nested(events, name, TRAIN[0])
    assert not _nested(events, "repro_torch.moe.route",
                       "repro_torch.moe.experts")
    opt = next(e for e in events if e["name"] == TRAIN[2])
    assert all(e["ts"] + e["dur"] <= opt["ts"] for e in events
               if e.get("name") in LAYER)


@pytest.mark.parametrize("profiled", [False, True])
def test_profiling_changes_no_bit_of_the_step(profiled, one_thread):
    want_model, want_opt, want_losses = _steps()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if profiled:
        with torch.profiler.profile(activities=acts):
            model, opt, losses = _steps()
    else:
        model, opt, losses = _steps()
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    want = dict(want_model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name
    for key in ("mu", "nu"):
        for name, m in opt[key].items():
            assert torch.equal(m, want_opt[key][name]), (key, name)

"""The port's training loop on the CPU against the JAX package's: the
token pipeline in distribution, ``run_training`` with the reference's
initial weights and batches injected, the microbatched step, restart
exactness, the AdamW state in the reference's layout, the straggler
watchdog, the training CLI and the entry points without a card.  The
reference runs its own loop (jitted steps); float32, ``device="cpu"``.

Tolerances: losses and the microbatched step's loss rtol 1e-5 (measured
within 1e-6 over 8 steps: matmul order, and the AdamW differences of
``tests/test_torch_optim.py``), the microbatched step's parameters within
1e-6; restart exactness bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401 (a fixture)

from repro import configs as rconfigs
from repro.data.tokens import TokenPipeline as RPipe
from repro.models import model as R
from repro.optim import adamw as RA
from repro.runtime import train_loop as RT
from repro_torch import configs as pconfigs
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.data.tokens import TokenPipeline, step_seed
from repro_torch.launch import train as ptrain_cli
from repro_torch.models.convert import (from_reference,
                                        opt_state_from_reference,
                                        opt_state_to_reference,
                                        stacked_layers, unstack_tree)
from repro_torch.optim import adamw as PA
from repro_torch.runtime import train_loop as PT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 1e-5
# a small qwen3 for the loops (test_runtime.py's), and one whose embedding
# and ffn output are int8-eligible AdamW leaves, "wo" only by its stack of
# two layers
SMALL = dict(vocab=128, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64, n_periods=2)
INT8 = dict(vocab=512, d_model=256, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=128, n_periods=2)


def _cfgs(arch: str, **over):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **over))


def _ref_batches(cfg, global_batch: int, seq_len: int, seed: int = 0):
    pipe = RPipe(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
                 seed=seed)
    return lambda step: {k: np.array(v) for k, v in pipe.batch(step).items()}


def _ref_init(rc, pc, seed: int = 0):
    return from_reference(jax.tree.map(np.asarray, R.init_params(
        jax.random.PRNGKey(seed), rc)), pc, device="cpu")


# -------------------------------------------------------------- pipeline ---

def _stats(tokens: np.ndarray, targets: np.ndarray, vocab: int,
           n_states: int = 64) -> dict:
    band = vocab // n_states
    states = tokens // band
    steps = (states[:, 1:] - states[:, :-1]) % n_states
    base = tokens % band
    assert tokens.min() >= 0 and tokens.max() < vocab
    np.testing.assert_array_equal(targets[:, :-1], tokens[:, 1:])
    assert set(np.unique(steps)) <= {0, 1, n_states - 1}
    return {"stay": float((steps == 0).mean()),
            "up": float((steps == 1).mean()),
            "low_quarter": float((base < band / 4).mean()),
            "base_mean": float(base.mean() / band),
            "first_state_zero": float((states[:, 0] == 0).mean()
                                      + (states[:, 0] == n_states - 1).mean()
                                      + (states[:, 0] == 1).mean())}


def test_token_pipeline_matches_reference_in_distribution():
    """The port's stream against the reference's on the statistics the
    stream is built from: shifted targets, random-walk steps of -1, 0, +1
    (each 1/3), a base inside the state's band with P(base < band / 4) =
    P(u < 1/2) = 1/2 and mean E[u^2] = 1/3, the walk starting next to
    state 0.  At 64 x 512 positions a proportion's standard error is at
    most 0.002; each is held within 0.015 of the reference's and of its
    expectation."""
    vocab, b, s = 8192, 64, 512
    port = TokenPipeline(vocab, s, b, seed=5, device="cpu").batch(3)
    ref = RPipe(vocab=vocab, seq_len=s, global_batch=b, seed=5).batch(3)
    assert port["tokens"].dtype == torch.int32
    assert port["targets"].shape == (b, s)
    got = _stats(port["tokens"].numpy(), port["targets"].numpy(), vocab)
    want = _stats(np.asarray(ref["tokens"]), np.asarray(ref["targets"]),
                  vocab)
    expect = {"stay": 1 / 3, "up": 1 / 3, "low_quarter": 0.5,
              "base_mean": 1 / 3, "first_state_zero": 1.0}
    for k in expect:
        assert abs(got[k] - want[k]) <= 0.015, (k, got[k], want[k])
        assert abs(got[k] - expect[k]) <= 0.015, (k, got[k])
    # the uniform last target covers the vocabulary
    last = port["targets"][:, -1].numpy()
    assert last.max() >= vocab // 2 and last.min() < vocab // 2


def test_pipeline_deterministic_and_step_indexed():
    pipe = TokenPipeline(vocab=512, seq_len=16, global_batch=4, seed=3,
                         device="cpu")
    b1, b2 = pipe.batch(7), pipe.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], pipe.batch(8)["tokens"])
    other = TokenPipeline(512, 16, 4, seed=4, device="cpu").batch(7)
    assert not torch.equal(b1["tokens"], other["tokens"])
    assert int(b1["tokens"].max()) < 512 and int(b1["tokens"].min()) >= 0
    seeds = {step_seed(seed, step) for seed in range(4) for step in range(64)}
    assert len(seeds) == 256 and max(seeds) < 2 ** 63


# ------------------------------------------------------------------ loops ---

@pytest.mark.parametrize("head", ["dense", "loghd"])
def test_run_training_matches_reference(head, tmp_path):
    rc, pc = _cfgs("qwen3-1.7b", head=head, **SMALL)
    kw = dict(total_steps=8, ckpt_every=100, warmup_steps=2, log_every=100)
    want = RT.run_training(rc, loop=RT.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "r"), **kw), global_batch=4, seq_len=32)
    got = PT.run_training(pc, loop=PT.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "p"), **kw), params=_ref_init(rc, pc),
        batches=_ref_batches(rc, 4, 32))
    assert not got["resumed"] and got["first_step"] == 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert latest_step(str(tmp_path / "p")) == 8


def test_microbatched_step_matches_reference():
    """Two microbatches accumulated in float32: one step's loss and
    parameters against the reference's jitted train_step."""
    rc, pc = _cfgs("qwen3-1.7b", head="loghd", **SMALL)
    params = R.init_params(jax.random.PRNGKey(1), rc)
    model = from_reference(jax.tree.map(np.asarray, params), pc, device="cpu")
    batch = _ref_batches(rc, 4, 16, seed=2)(0)
    rloop = RT.TrainLoopConfig(microbatches=2, warmup_steps=0)
    ploop = PT.TrainLoopConfig(microbatches=2, warmup_steps=0)
    ropt = RA.AdamWConfig()
    step = jax.jit(RT.make_train_step(rc, ropt, rloop, None))
    rparams, _, rloss = step(params, RA.adamw_init(params, ropt),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(3, jnp.int32))
    state = PA.adamw_init(dict(model.named_parameters()), PA.AdamWConfig(),
                          stacked_layers(model))
    _, state, loss = PT.make_train_step(pc, PA.AdamWConfig(), ploop)(
        model, state, batch, 3)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=LOSS_RTOL)
    want = unstack_tree(jax.tree.map(np.asarray, rparams), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_train_restart_exact(tmp_path):
    """tests/test_checkpoint.py's restart test in the port: 8 steps
    straight equal 4, a stop and 4 resumed, bit for bit."""
    _, pc = _cfgs("qwen3-1.7b", **SMALL)
    kw = dict(total_steps=8, ckpt_every=100, warmup_steps=2, log_every=100)
    out_a = PT.run_training(pc, loop=PT.TrainLoopConfig(
        ckpt_dir=str(tmp_path / "a"), **kw), global_batch=4, seq_len=32,
        device="cpu")
    loop_b = PT.TrainLoopConfig(ckpt_dir=str(tmp_path / "b"), **kw)
    first = PT.run_training(pc, loop=loop_b, global_batch=4, seq_len=32,
                            stop_after=4, device="cpu")
    out_b = PT.run_training(pc, loop=loop_b, global_batch=4, seq_len=32,
                            device="cpu")
    assert out_b["resumed"] and out_b["first_step"] == 4
    assert first["losses"] + out_b["losses"] == out_a["losses"]
    for (n, a), (_, b) in zip(out_a["params"].named_parameters(),
                              out_b["params"].named_parameters()):
        assert torch.equal(a, b), n


def test_opt_state_converts_to_the_reference_tree():
    rc, pc = _cfgs("qwen3-1.7b", head="loghd", **INT8)
    model = _ref_init(rc, pc)
    cfg = PA.AdamWConfig(moment_dtype="int8")
    state = PA.adamw_init(dict(model.named_parameters()), cfg,
                          stacked_layers(model))
    # 32,768 elements a layer, int8 by its stack of two
    assert isinstance(state["mu"]["body.0.0.mlp.wo"], dict)
    want = RA.adamw_init(R.init_params(jax.random.PRNGKey(0), rc),
                         RA.AdamWConfig(moment_dtype="int8"))
    got = opt_state_to_reference(state, model)
    got_np = jax.tree.map(lambda t: t.numpy(), got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.asarray(b).dtype
    back = opt_state_from_reference(got, model)
    assert back["step"] == 0
    for name, leaf in state["nu"].items():
        other = back["nu"][name]
        if isinstance(leaf, dict):
            assert all(torch.equal(leaf[k], other[k]) for k in leaf)
        else:
            assert torch.equal(leaf, other)


def test_straggler_watchdog_aborts(tmp_path, one_thread):
    _, pc = _cfgs("qwen3-1.7b", vocab=128, d_model=32, n_heads=2,
                  n_kv_heads=2, head_dim=16, d_ff=64, n_periods=1)
    loop = PT.TrainLoopConfig(total_steps=40, ckpt_dir=str(tmp_path),
                              ckpt_every=100, warmup_steps=2, log_every=100,
                              straggler_factor=2.5, straggler_limit=1)
    with pytest.raises(PT.StragglerAbort):
        PT.run_training(pc, loop=loop, global_batch=2, seq_len=16,
                        inject_straggler_at=20, device="cpu")
    # the watchdog checkpointed before aborting -> restartable
    assert latest_step(str(tmp_path)) == 21


# --------------------------------------------------------- entry points ---

def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--smoke", "--steps", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck")], capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done on cpu: resumed=False" in out.stderr
    assert latest_step(str(tmp_path / "ck")) == 3
    # without --device the launcher runs on the card, and raises without one
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--smoke", "--steps", "1", "--ckpt-dir",
         str(tmp_path / "none")], capture_output=True, text=True,
        timeout=300, env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_train_cli_resumes_and_rejects_a_mesh(tmp_path):
    """The CLI resumes its checkpoint; with --mesh debug it makes a process
    group of its one rank, restores the unsharded checkpoint onto the
    ("data", "model") mesh of (1, 1) and trains 2 steps on it."""
    import torch.distributed as dist
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    first = ptrain_cli.main(argv)
    assert first["losses"] and not first["resumed"]
    again = ptrain_cli.main(argv[:3] + ["--steps", "3"] + argv[5:])
    assert again["resumed"] and again["first_step"] == 2
    assert len(again["losses"]) == 1
    meshed = ptrain_cli.main(argv[:3] + ["--steps", "5"] + argv[5:]
                             + ["--mesh", "debug"])
    assert meshed["resumed"] and meshed["first_step"] == 3
    assert len(meshed["losses"]) == 2 and np.isfinite(meshed["losses"]).all()
    assert meshed["params"].embed.table.device_mesh.mesh_dim_names == (
        "data", "model")
    assert not dist.is_initialized()     # the CLI's own group is gone
    assert latest_step(str(tmp_path)) == 5


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _cfgs("qwen3-1.7b", **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(pc.vocab, 8, 2).batch(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.run_training(pc, loop=PT.TrainLoopConfig(
            total_steps=1, ckpt_dir=str(tmp_path)))
    # a mesh runs: the debug mesh of one rank without a process group
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh("cpu")
    out = PT.run_training(pc, mesh=mesh, device="cpu",
                          global_batch=2, seq_len=8, loop=PT.TrainLoopConfig(
                              total_steps=1, ckpt_dir=str(tmp_path / "m")))
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert callable(PT.make_train_step(pc, PA.AdamWConfig(),
                                       PT.TrainLoopConfig(), mesh=mesh))

"""The sharded LM on 4 gloo ranks, a ("data", "model") mesh of (2, 2): the
loss and every gradient of qwen3's smoke config (one layer, vocab 128,
the loghd head) against the JAX package's UNSHARDED ``loss_fn`` on the
same weights and tokens; one AdamW step on sharded leaves (float32 and
int8 moments, the last axis split into whole blocks and into halves of
one) against the port's unsharded step; and the elastic restore of a
checkpoint the reference wrote unsharded, resumed on the mesh, against
the port's unsharded resume.

The ranks are spawned once (``torch.multiprocessing``, a ``file://``
store) and joined within JOIN_TIMEOUT_S, so a hang fails this file alone;
the JAX package is imported inside the test, so that the spawned ranks,
which import this module, do not load it.

Tolerances:
  * the loss: rtol 2e-3, the tolerance of the reference's own
    ``tests/test_distributed.py::test_sharded_train_step_runs_and_matches``
    (which fails under jax 0.9.0; measured here within 1e-6);
  * each gradient within 1e-4 of its leaf's largest magnitude (float32;
    the shards sum their products in other orders);
  * AdamW: the clip's global norm adds the shards' float64 sums of
    squares in another order, so the norms agree within rtol 1e-6 and the
    parameters and moments within 1e-6 of their scale;
  * the resumed loss: rtol 1e-5, as the unsharded resumes are held in
    ``tests/test_torch_train_ckpt.py``.
"""

import dataclasses
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs as pconfigs
from repro_torch.models.convert import from_reference, unstack_tree
from repro_torch.optim import adamw as PA
from repro_torch.runtime import train_loop as PT

JOIN_TIMEOUT_S = 240
WORLD = 4
SMALL = dict(vocab=128, n_periods=1, head="loghd")
B, S = 4, 32
LOSS_RTOL = 2e-3
GRAD_RTOL = 1e-4
# the optimizer's leaves: (shape, spec); "a" splits its last axis into
# whole 256-blocks, "b" into halves of one (the int8 codes are read with
# the axis whole), "c" is a small replicated float32 leaf
OPT_LEAVES = {"a": ((256, 512), ("data", "model")),
              "b": ((256, 256), (None, "model")),
              "c": ((300,), (None,))}


def _cfg():
    return dataclasses.replace(pconfigs.get_smoke_config("qwen3-1.7b"),
                               **SMALL)


def _worker(rank, world, store, out_dir, kwargs):
    import torch.distributed as dist
    torch.set_num_threads(1)     # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        out = _task(**kwargs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, **kwargs) -> list:
    out_dir = tmp_path / "ranks"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _worker, args=(WORLD, str(tmp_path / "store"), str(out_dir), kwargs),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


def _opt_inputs():
    rng = np.random.default_rng(5)
    draw = {n: (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
            for n, (shape, _) in OPT_LEAVES.items()}
    return ({n: torch.from_numpy(p) for n, (p, _) in draw.items()},
            {n: torch.from_numpy(g) for n, (_, g) in draw.items()})


def _opt_step(params, grads, moment_dtype: str):
    cfg = PA.AdamWConfig(moment_dtype=moment_dtype)
    state = PA.adamw_init(params, cfg)
    norm = PA.global_norm(list(grads.values()))
    PA.adamw_update(state, params, grads, cfg, lr=1e-2)
    return state, norm


def _task(ref_path: str, ckpt_dir: str) -> dict:
    """Every rank: the sharded loss and gradients, the sharded AdamW steps
    and the elastic resume; rank 0's full tensors come back."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import loss_fn
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    pc = _cfg()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    # loss and gradients on the mesh
    model = from_reference(ref["params"], pc, device="cpu", mesh=mesh)
    loss = loss_fn(model, pc, torch.from_numpy(ref["tokens"]),
                   torch.from_numpy(ref["targets"]), mesh)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    out["loss"] = loss.detach().numpy()
    for n, g in zip(names, grads):
        assert shd.is_dtensor(g)
        out[f"grad/{n}"] = g.full_tensor().numpy()
    out["placed"] = np.asarray([shd.is_dtensor(p) for p in
                                model.parameters()])
    # AdamW on sharded leaves
    params, grads = _opt_inputs()
    for moment_dtype in ("float32", "int8"):
        sp = {n: shd.distribute(p.clone(), mesh, shd.P(*OPT_LEAVES[n][1]))
              for n, p in params.items()}
        sg = {n: shd.distribute(g, mesh, shd.P(*OPT_LEAVES[n][1]))
              for n, g in grads.items()}
        state, norm = _opt_step(sp, sg, moment_dtype)
        out[f"{moment_dtype}/norm"] = norm.numpy()
        for n, p in sp.items():
            out[f"{moment_dtype}/p/{n}"] = p.full_tensor().numpy()
            for key in ("mu", "nu"):
                m = state[key][n]
                if isinstance(m, dict):
                    out[f"{moment_dtype}/{key}/{n}/codes"] = \
                        m["codes"].full_tensor().numpy()
                    out[f"{moment_dtype}/{key}/{n}/scale"] = \
                        m["scale"].full_tensor().numpy()
                    out[f"{moment_dtype}/{key}/{n}/local_scale"] = np.asarray(
                        m["scale"].to_local().shape)
                else:
                    out[f"{moment_dtype}/{key}/{n}"] = \
                        m.full_tensor().numpy()
    # the elastic resume of the reference's unsharded checkpoint
    resumed = PT.run_training(
        pc, mesh=mesh, loop=PT.TrainLoopConfig(
            ckpt_dir=ckpt_dir, total_steps=3, ckpt_every=100,
            warmup_steps=2, log_every=100),
        params=from_reference(ref["params"], pc, device="cpu"),
        batches=lambda step: ref["batches"][step])
    out["resumed"] = np.asarray([resumed["resumed"], resumed["first_step"]])
    out["resumed_losses"] = np.asarray(resumed["losses"])
    return out


def test_sharded_loss_grads_adamw_and_elastic_restore(tmp_path):
    import jax
    from repro import configs as rconfigs
    from repro.checkpoint.ckpt import save_checkpoint
    from repro.data.tokens import TokenPipeline as RPipe
    from repro.models import model as R
    from repro.optim import adamw as RA
    rc = dataclasses.replace(rconfigs.get_smoke_config("qwen3-1.7b"),
                             **SMALL)
    pc = _cfg()
    params = R.init_params(jax.random.PRNGKey(0), rc)
    tokens = np.random.default_rng(1).integers(0, rc.vocab, (B, S)).astype(
        np.int32)
    targets = np.roll(tokens, -1, axis=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, y: R.loss_fn(p, rc, t, y)))(params, tokens, targets)
    # the reference writes an unsharded training checkpoint at step 2 (its
    # {"params", "opt"} tree); the port resumes it without a mesh here and
    # on the mesh in the ranks
    pipe = RPipe(vocab=rc.vocab, seq_len=S, global_batch=B, seed=0)
    batches = {s: {k: np.array(v) for k, v in pipe.batch(s).items()}
               for s in range(3)}
    loop = dict(total_steps=3, ckpt_every=100, warmup_steps=2, log_every=100)
    save_checkpoint(str(tmp_path / "ref"), 2, {
        "params": params, "opt": RA.adamw_init(params, RA.AdamWConfig())})
    shutil.copytree(tmp_path / "ref", tmp_path / "mesh")
    tree = jax.tree.map(np.asarray, params)
    flat = PT.run_training(
        pc, loop=PT.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"), **loop),
        params=from_reference(tree, pc, device="cpu"),
        batches=lambda s: batches[s])
    assert flat["resumed"] and flat["first_step"] == 2
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"params": tree, "tokens": tokens, "targets": targets,
                     "batches": batches}, f)

    ranks = _spawn(tmp_path, ref_path=str(tmp_path / "ref.pkl"),
                   ckpt_dir=str(tmp_path / "mesh"))
    got = ranks[0]
    assert got["placed"].all()
    # every rank computed the same loss (one scalar, replicated)
    for r in ranks:
        np.testing.assert_array_equal(r["loss"], got["loss"])
    np.testing.assert_allclose(float(got["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    model = from_reference(tree, pc, device="cpu")
    want = unstack_tree(jax.tree.map(np.asarray, grads), model)
    for name, w in want.items():
        g = got[f"grad/{name}"]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale, name

    for moment_dtype in ("float32", "int8"):
        params_o, grads_o = _opt_inputs()
        state, norm = _opt_step(params_o, grads_o, moment_dtype)
        np.testing.assert_allclose(got[f"{moment_dtype}/norm"],
                                   norm.numpy(), rtol=1e-6)
        for n, p in params_o.items():
            np.testing.assert_allclose(got[f"{moment_dtype}/p/{n}"],
                                       p.numpy(), rtol=0, atol=1e-6)
            for key in ("mu", "nu"):
                m = state[key][n]
                if isinstance(m, dict):
                    assert moment_dtype == "int8" and n in ("a", "b")
                    codes = got[f"{moment_dtype}/{key}/{n}/codes"]
                    # at most a code at a rounding boundary moves
                    assert (np.abs(codes.astype(int) - m["codes"].numpy())
                            > 0).mean() < 1e-3
                    np.testing.assert_allclose(
                        got[f"{moment_dtype}/{key}/{n}/scale"],
                        m["scale"].numpy(), rtol=1e-6)
                    # the scale keeps the last axis whole on every rank
                    assert got[f"{moment_dtype}/{key}/{n}/local_scale"][
                        -1] == m["scale"].shape[-1]
                else:
                    w = m.numpy()
                    np.testing.assert_allclose(
                        got[f"{moment_dtype}/{key}/{n}"], w, rtol=0,
                        atol=1e-6 * float(np.abs(w).max()))

    assert tuple(got["resumed"]) == (1, 2)
    np.testing.assert_allclose(got["resumed_losses"], flat["losses"],
                               rtol=1e-5)

"""The dense head's sharded loss on 4 gloo ranks, a ("data", "model") mesh
of (2, 2): qwen3's smoke config (one layer, vocab 128) with the dense
head, its loss against the JAX package's UNSHARDED ``loss_fn`` on the
same weights and tokens (rtol 2e-3, the tolerance of the reference's own
``tests/test_distributed.py::test_sharded_train_step_runs_and_matches``)
and every gradient within 1e-4 of its leaf's largest magnitude (float32;
the shards sum their products in other orders).  The loghd head is in
``test_torch_lm_sharding_dist.py``.

The ranks are spawned once and joined within JOIN_TIMEOUT_S; the JAX
package is imported inside the test, so that the ranks, which import
this module, do not load it.
"""

import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs as pconfigs

JOIN_TIMEOUT_S = 240
WORLD = 4
SMALL = dict(vocab=128, n_periods=1, head="dense")
B, S = 4, 32


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


def _task(ref_path: str) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.convert import from_reference
    from repro_torch.models.model import loss_fn
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    pc = _cfg()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = from_reference(ref["params"], pc, device="cpu", mesh=mesh)
    loss = loss_fn(model, pc, torch.from_numpy(ref["tokens"]),
                   torch.from_numpy(ref["targets"]), mesh)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    out = {"loss": loss.detach().numpy()}
    for (name, _), g in zip(model.named_parameters(), grads):
        out[f"grad/{name}"] = shd.full(g).numpy()
    return out


def test_dense_head_sharded_loss_and_grads(tmp_path):
    import jax
    from repro import configs as rconfigs
    from repro.models import model as R
    from repro_torch.models.convert import from_reference, unstack_tree
    rc = dataclasses.replace(rconfigs.get_smoke_config("qwen3-1.7b"),
                             **SMALL)
    pc = _cfg()
    params = R.init_params(jax.random.PRNGKey(0), rc)
    tokens = np.random.default_rng(1).integers(0, rc.vocab, (B, S)).astype(
        np.int32)
    targets = np.roll(tokens, -1, axis=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, y: R.loss_fn(p, rc, t, y)))(params, tokens, targets)
    tree = jax.tree.map(np.asarray, params)
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"params": tree, "tokens": tokens, "targets": targets}, f)

    ranks = _spawn(tmp_path, ref_path=str(tmp_path / "ref.pkl"))
    got = ranks[0]
    for r in ranks:
        np.testing.assert_array_equal(r["loss"], got["loss"])
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=2e-3)
    model = from_reference(tree, pc, device="cpu")
    want = unstack_tree(jax.tree.map(np.asarray, grads), model)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        assert float(np.abs(got[f"grad/{name}"] - w).max()) <= 1e-4 * scale, \
            name

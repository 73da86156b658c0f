"""Expert parallelism and the sequence-sharded flash decode on 4 gloo
ranks, against the JAX package:

  * ``moe_block`` on a (2, 2) ("data", "model") mesh (experts over
    "model", tokens over both axes, capacity factor 8 as in
    ``tests/test_distributed.py:30-48``) against the reference's SHARDED
    ``moe_block`` on a (2, 2) jax mesh of 4 host devices (y and the
    per-shard aux, rtol and atol 2e-4), and y against the unsharded
    block;
  * ``decode_attention_seqsharded`` on a ("data",) mesh of 4 ranks, each
    holding 16 of the cache's 64 positions, against the reference's plain
    ``decode_attention`` (pos 40, rtol and atol 2e-4, as at
    ``tests/test_distributed.py:77-111``), with only the owning shard's
    cache written.

The dense head's sharded loss is in ``test_torch_lm_sharding_dense.py``.

The ranks are spawned once; the JAX package is imported inside the test
(the reference's sharded block in a subprocess with 4 forced host
devices), so that the ranks, which import this module, do not load it.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_TIMEOUT_S = 240
WORLD = 4
EP_TOL = dict(rtol=2e-4, atol=2e-4)
MOE = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, capacity_factor=8.0)
ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
CACHE, POS = 64, 40


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
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import (Attention, AttnConfig,
                                              decode_attention_seqsharded)
    from repro_torch.models.moe import MoE, MoEConfig, moe_block
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    # expert parallelism: the module's weights whole on every rank, laid
    # out by the rules inside moe_block
    moe = MoE(MoEConfig(**MOE), device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.from_numpy(ref["moe"][name]))
    y, aux = moe_block(moe, torch.from_numpy(ref["moe_x"]), mesh)
    out["moe_y"] = y.full_tensor().detach().numpy()
    out["moe_aux"] = aux.detach().numpy()
    # the sequence-sharded flash decode over ("data",) of 4 ranks
    line = make_mesh((WORLD,), ("data",), "cpu")
    attn = Attention(AttnConfig(**ATTN), device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, p in attn.named_parameters():
            p.copy_(torch.from_numpy(ref["attn"][name]))
    r, n = dist.get_rank(), CACHE // WORLD
    cache = {k: torch.from_numpy(ref["cache"][k][:, r * n:(r + 1) * n].copy())
             for k in ("k", "v")}
    before = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        got, cache = decode_attention_seqsharded(
            attn, torch.from_numpy(ref["dec_x"]), cache, POS, axis="data",
            mesh=line)
    out["dec"] = got.detach().numpy()
    out["dec_changed"] = np.asarray(
        [int((cache[k] != before[k]).any(dim=(0, 2, 3)).nonzero().numel())
         for k in ("k", "v")])
    out["dec_slot"] = cache["k"][:, POS - r * n].numpy() if (
        r * n <= POS < (r + 1) * n) else np.zeros(0)
    return out


_REF_EP = textwrap.dedent("""
    import os, pickle, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.moe import MoEConfig, init_moe, moe_block
    cfg = MoEConfig(**{moe!r})
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    params = init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32))
    y_ref, aux_ref = moe_block(params, cfg, x, None)
    y_sh, aux_sh = jax.jit(lambda p, x: moe_block(p, cfg, x, mesh))(params, x)
    with open(sys.argv[1], "wb") as f:
        pickle.dump({{"params": jax.tree.map(np.asarray, params),
                      "x": np.asarray(x), "y_ref": np.asarray(y_ref),
                      "aux_ref": float(aux_ref), "y_sh": np.asarray(y_sh),
                      "aux_sh": float(aux_sh)}}, f)
""").format(moe=MOE)


def test_expert_parallel_and_seqsharded_decode(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as rattn
    # the reference's sharded MoE block, on 4 host devices
    ep_path = tmp_path / "ep.pkl"
    run = subprocess.run([sys.executable, "-c", _REF_EP, str(ep_path)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  JAX_PLATFORMS="cpu"))
    assert run.returncode == 0, run.stderr[-3000:]
    with open(ep_path, "rb") as f:
        ep = pickle.load(f)
    # the reference's plain decode over the whole cache
    acfg = rattn.AttnConfig(**ATTN)
    aparams = rattn.init_attn(jax.random.PRNGKey(0), acfg, jnp.float32)
    shape = (2, CACHE, ATTN["n_kv_heads"], ATTN["head_dim"])
    cache = {"k": np.asarray(jax.random.normal(jax.random.PRNGKey(1), shape)),
             "v": np.asarray(jax.random.normal(jax.random.PRNGKey(2), shape))}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 1, 32)))
    want_dec, new_cache = jax.jit(lambda p, x, c: rattn.decode_attention(
        p, acfg, x, c, jnp.asarray(POS, jnp.int32)))(aparams, x, cache)
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({"moe": ep["params"], "moe_x": ep["x"],
                     "attn": jax.tree.map(np.asarray, aparams),
                     "cache": cache, "dec_x": x}, f)

    ranks = _spawn(tmp_path, ref_path=str(tmp_path / "ref.pkl"))
    got = ranks[0]
    # expert parallelism: y and the per-shard aux of the reference's
    # sharded block, y also of the unsharded one (capacity factor 8: no
    # token dropped either way)
    for r in ranks:
        np.testing.assert_allclose(r["moe_y"], ep["y_sh"], **EP_TOL)
        np.testing.assert_allclose(float(r["moe_aux"]), ep["aux_sh"],
                                   **EP_TOL)
    np.testing.assert_allclose(got["moe_y"], ep["y_ref"], **EP_TOL)
    # the flash decode: every rank's output is the plain decode's; only the
    # owner of position 40 (rank 2 of 16-position slices) wrote its slot
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["dec"], np.asarray(want_dec), **EP_TOL)
        owner = rank == POS // (CACHE // WORLD)
        assert tuple(r["dec_changed"]) == ((1, 1) if owner else (0, 0))
        if owner:
            np.testing.assert_allclose(
                r["dec_slot"], np.asarray(new_cache["k"])[:, POS], **EP_TOL)

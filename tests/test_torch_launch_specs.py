"""The dry run's cells against the JAX package's: every input leaf of every
(arch x shape) cell has the reference's local shard shape on a (2, 2, 2)
("pod", "data", "model") mesh, and one cell of a smoke config runs its
step under the fake process group with its argument bytes and
collectives counted.

The reference side runs in a subprocess with 8 forced host devices, as
``tests/test_launch_specs.py`` does; the port side in a subprocess under a
fake process group of 8 ranks (the fake group is process-global).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")

_REF = textwrap.dedent("""
    import os, json
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import jax
    from repro.configs import ARCH_NAMES, get_config
    from repro.configs.base import SHAPES
    from repro.launch.specs import cell_specs
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.run_long_context:
                continue
            _, specs, _, _ = cell_specs(cfg, shape, mesh)
            flat = jax.tree_util.tree_flatten_with_path(specs)[0]
            out[f"{arch}/{sname}"] = {
                "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path):
                [list(leaf.shape), list(leaf.shape if leaf.sharding is None
                                        else leaf.sharding.shard_shape(
                                            leaf.shape))]
                for path, leaf in flat}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", world_size=8, rank=0, store=FakeStore())
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_specs, input_shapes
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    out = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.run_long_context:
                continue
            _, inputs, _, _ = cell_specs(cfg, shape, mesh)
            out[f"{arch}/{sname}"] = {k: [list(g), list(l)] for k, (g, l)
                                      in input_shapes(inputs).items()}
    print(json.dumps(out))
""")


def _run(script: str, timeout: int = 300) -> str:
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-3000:])
    return out.stdout.strip().splitlines()[-1]


def test_cell_inputs_shard_like_the_reference():
    """32 cells (long_500k only for the sub-quadratic archs): the same
    input leaves under the same paths, each with the reference's global
    and local shard shape (parameters and moments stacked over their
    layers as the reference keeps them)."""
    ref = json.loads(_run(_REF))
    port = json.loads(_run(_PORT))
    assert len(ref) == 32
    assert port.keys() == ref.keys()
    for cell in ref:
        assert port[cell].keys() == ref[cell].keys(), (
            cell, sorted(set(port[cell]) ^ set(ref[cell]))[:10])
        for path, shapes in ref[cell].items():
            assert port[cell][path] == shapes, (cell, path,
                                                port[cell][path], shapes)


_DRY = textwrap.dedent("""
    import dataclasses, json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", world_size=8, rank=0, store=FakeStore())
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_specs, input_shapes
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    SHAPES["train_tiny"] = ShapeSpec("train_tiny", 32, 8, "train")
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), vocab=128,
                              n_periods=1)
    rec = dryrun.run_cell("qwen3-1.7b", "train_tiny", "test", cfg=cfg,
                          mesh=mesh)
    _, inputs, _, _ = cell_specs(cfg, SHAPES["train_tiny"], mesh)
    def local_bytes(t):
        t = t.to_local()
        return t.numel() * t.element_size()
    model, opt, batch, _ = inputs
    params = sum(local_bytes(p) for p in model.parameters())
    moments = sum(local_bytes(m) for key in ("mu", "nu")
                  for m in opt[key].values())
    tokens = sum(local_bytes(t) for t in batch.values())
    row = roofline.roofline_cell(rec, cfg=cfg)
    print(json.dumps({"rec": rec, "shards": [params, moments, tokens],
                      "row": row, "summary": dryrun.summary(rec)}))
""")


def test_dry_run_cell_on_a_fake_mesh():
    """One cell of qwen3's smoke config (one layer, vocab 128) at a tiny
    train shape on the (2, 2, 2) mesh: the step runs on meta tensors; the
    argument bytes are the local shards' (parameters in bf16 + two
    float32 moments, each a quarter or an eighth of the whole, + the
    tokens' and targets' batch shards) and the peak estimate exceeds them;
    collectives are counted (FSDP gathers, gradient reductions)."""
    out = json.loads(_run(_DRY))
    rec, row = out["rec"], out["row"]
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    params, moments, tokens = out["shards"]
    assert tokens == 2 * (8 // 4) * 32 * 4   # tokens + targets, int32
    assert moments > params > 0
    mem = rec["memory"]["argument_size_in_bytes"]
    assert mem == params + moments + tokens
    assert mem == rec["memory"]["per_device_total_bytes"]
    # MemTracker's peak over the step holds the inputs and more
    assert rec["memory"]["peak_estimate_bytes"] > mem
    coll = rec["collectives"]
    assert coll["counts"].get("all-gather", 0) > 0
    assert coll["counts"].get("all-reduce", 0) > 0
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    assert rec["global_cost"]["flops"] > rec["device_cost"]["flops"] > 0
    assert row["T_compute_s"] > 0 and row["mem_gib_per_dev"] > 0
    assert "GiB/dev" in out["summary"]

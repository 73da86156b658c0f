"""The port's LM layouts against the JAX package's, without process groups
of more than one rank: the sharding rules on every parameter of the ten
full configs (built on the meta device), the divisibility guard on the
production meshes' shapes, the debug mesh, the roofline's FLOP model and
the dry run's collective tally.  The gloo ranks are in
``test_torch_lm_sharding_dist.py``, ``test_torch_lm_sharding_ep.py`` and
``test_torch_lm_sharding_dense.py``, the dry run's cells in
``test_torch_launch_specs.py``.

Everything here is exact: specs, shard shapes and FLOP counts are equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist

from repro import configs as rconfigs
from repro.configs.base import SHAPES as RSHAPES
from repro.launch import mesh as rmesh
from repro.launch import roofline as rroofline
from repro.models import model as R
from repro.models import sharding as rsharding
from repro_torch import configs as pconfigs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as pdryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import roofline as proofline
from repro_torch.models import model as P
from repro_torch.models import sharding as shd
from repro_torch.models.convert import _locate

ARCHS = pconfigs.ARCH_NAMES
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "test": {"pod": 2, "data": 2, "model": 2}}


def _ref_path_specs(cfg) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        R.param_specs(cfg),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_path_specs(pc) -> dict:
    """Port parameter -> (reference path, its spec with the reference's
    stack axis put back as None)."""
    out = {}
    for name, spec in P.param_specs(pc).items():
        path, layer = _locate(name)
        key = "/".join(map(str, path))
        out.setdefault(key, set()).add(
            tuple(spec) if layer is None else (None,) + tuple(spec))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch):
    """Every port parameter's spec is the reference's spec_for_path on its
    reference leaf, with the stack axis dropped: all ten full configs,
    built on meta (nothing drawn)."""
    ref = _ref_path_specs(rconfigs.get_config(arch))
    port = _port_path_specs(pconfigs.get_config(arch))
    assert port.keys() == ref.keys()
    for key, specs in port.items():
        assert specs == {ref[key]}, (key, specs, ref[key])


class _Shape:
    """A mesh as the guard reads it: axis sizes by name."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_guarded_layouts_match_the_reference(mesh):
    """The divisibility guard (granite's vocab of 49,155, xlstm's 4 heads
    on 16) gives the reference's spec and shard shape for every parameter
    of every config on the production meshes' shapes and the tests'
    (2, 2, 2)."""
    m = _Shape(MESHES[mesh])
    pm = pmesh.Mesh(None, m.axis_names, m.shape)
    for arch in ARCHS:
        rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
        shapes = jax.eval_shape(lambda: R.init_params(jax.random.PRNGKey(0),
                                                      rc))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        ref = {}
        for path, leaf in flat:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            spec = rsharding._guard_spec(
                rsharding.spec_for_path(key, len(leaf.shape)), leaf.shape, m)
            shard = list(leaf.shape)
            for d, entry in enumerate(spec):
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in axes:
                    if a is not None:
                        shard[d] //= m.shape[a]
            ref[key] = (tuple(spec), tuple(shard))
        model = P.DecoderLM(pc, device=torch.device("meta"))
        for name, sh in shd.model_shardings(model, pm).items():
            path, layer = _locate(name)
            key = "/".join(map(str, path))
            shape = tuple(model.get_parameter(name).shape)
            got = ((tuple(sh.spec), sh.shard_shape(shape)) if layer is None
                   else ((None,) + tuple(sh.spec),
                         (ref[key][1][0],) + sh.shard_shape(shape)))
            assert got == ref[key], (arch, mesh, name, got, ref[key])


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = pmesh.Mesh(None, ("pod", "data", "model"),
                   {"pod": 2, "data": 2, "model": 2})
    assert shd.placements(shd.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.P(("data", "pod")), m)
    assert shd.NamedSharding(m, shd.P(("pod", "data"), "model")).shard_shape(
        (8, 6)) == (2, 3)
    assert shd.batch_spec(m) == shd.P(("pod", "data"), None)
    assert tuple(shd.batch_spec(m)) == tuple(rsharding.batch_spec(
        _Shape({"pod": 2, "data": 2, "model": 2})))
    assert tuple(shd.activation_spec(m)) == tuple(
        rsharding.activation_spec(_Shape({"pod": 2, "data": 2, "model": 2})))
    assert shd.dp_axes_of(m) == ("pod", "data")
    assert shd.dp_axes_of(None) == ()
    assert shd.dp_for_batch(m, 2) == ("pod",) and shd.dp_for_batch(m, 1) is None
    assert tuple(shd.CLASS_SHARDED) == tuple(rsharding.CLASS_SHARDED)
    assert tuple(shd.CLASS_REPLICATED) == tuple(rsharding.CLASS_REPLICATED)


def test_debug_mesh_is_the_reference_s(tmp_path):
    """make_debug_mesh() is the reference's ("data", "model") mesh of
    (world, 1): one rank without a process group (no collective), and a
    DeviceMesh over the group's ranks with one."""
    ref = rmesh.make_debug_mesh()
    mesh = pmesh.make_debug_mesh("cpu")
    assert mesh.axis_names == tuple(ref.axis_names) == ("data", "model")
    assert mesh.shape == dict(ref.shape) == {"data": 1, "model": 1}
    assert mesh.device_mesh is None and mesh.group("data") is None
    assert list(mesh.blocks("data")) == [0]
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", world_size=4, rank=0, store=FakeStore())
    try:
        mesh = pmesh.make_debug_mesh("cpu")
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 4, "model": 1}
        assert tuple(mesh.device_mesh.shape) == (4, 1)
        assert mesh.group("data") is not None
        assert list(mesh.blocks("data")) == [0]
        with pytest.raises(RuntimeError, match="256 ranks"):
            pmesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_flops_equal_the_reference(arch):
    rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
    for name in SHAPES:
        assert proofline.analytic_flops(pc, SHAPES[name]) == \
            rroofline.analytic_flops(rc, RSHAPES[name]), (arch, name)


HLO = """
  %ag = bf16[8,128]{1,0} all-gather(%x), replica_groups={}
  %ar.1 = f32[16,16]{1,0} all-reduce(%y), to_apply=%sum
  %cp = u8[4]{0} collective-permute(%z)
  %other = f32[2,2]{1,0} add(%a, %b)
"""


def test_collective_tally_matches_the_parser():
    """The tally of recorded (kind, shape, dtype) entries gives what the
    reference's HLO parser reads off the same collectives
    (tests/test_launch_specs.py::test_collective_parser).  The parser runs
    in a process of its own: importing the reference's dryrun forces 512
    host devices on jax."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; from repro.launch.dryrun import collective_bytes;"
         " print(json.dumps(collective_bytes(sys.stdin.read())))"],
        input=HLO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout)
    entries = [("all-gather", (8, 128), "bf16"),
               ("all-reduce", (16, 16), torch.float32),
               ("collective-permute", (4,), torch.uint8)]
    assert pdryrun.collective_bytes(entries) == want
    assert want["counts"] == {"all-gather": 1, "all-reduce": 1,
                              "collective-permute": 1}
    assert want["total_bytes"] == 8 * 128 * 2 + 16 * 16 * 4 + 4


def test_roofline_reads_the_card_table():
    """One table of peaks: the kernel bounds (chip_smoke.card_rates) and
    the roofline read the same numbers, by card name."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for card, part in (("NVIDIA H100 80GB HBM3", "SXM"),
                       ("NVIDIA H100 PCIe", "PCIe")):
        r = cs.card_rates(card)
        t = proofline.RATES[part]
        assert proofline.rates(card) is t
        assert (r["bytes"], r["float32"], r["int32"], r["tf32x3"]) == (
            t["bytes"], t["float32"], t["float32"] / 2, t["tf32"] / 3)
        assert (r["bf16"], r["nvlink"]) == (t["bf16"], t["nvlink"])
    # the kernel bounds' values of earlier PRs, unchanged
    assert cs.card_rates("NVIDIA H100 80GB HBM3")["tf32x3"] == 495e12 / 3
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
           "n_devices": 256, "memory": {"argument_size_in_bytes": 2**30,
                                        "per_device_total_bytes": 2**30},
           "global_cost": {"flops": 1.0},
           "collectives": {"bytes": {"all-reduce": 1000},
                           "total_bytes": 1000}}
    row = proofline.roofline_cell(rec)
    sxm = proofline.RATES["SXM"]
    an = proofline.analytic_flops(pconfigs.get_config("qwen3-1.7b"),
                                  SHAPES["train_4k"])
    assert row["T_compute_s"] == an["total"] / (256 * sxm["bf16"])
    assert row["T_memory_s"] == 2**30 / sxm["bytes"]
    assert row["T_collective_s"] == 1000 / sxm["nvlink"]
    assert row["T_collective_ring_s"] == 2 * 1000 * 255 / 256 / sxm["nvlink"]
    assert row["dominant"] == "compute"


def test_seq_sharded_decode_step_on_one_shard_is_the_decode():
    """decode_step(seq_sharded=True) without a mesh: every global
    attention layer takes the flash decode over one shard holding the
    whole cache (init_decode_state(seq_shards=1)), and gives the plain
    decode's logits (the online softmax's rounding: within 1e-5); a
    per-slot position is refused."""
    import dataclasses as dc
    pc = dc.replace(pconfigs.get_smoke_config("qwen3-1.7b"), vocab=128,
                    n_periods=1)
    model = P.init_params(pc, 0, "cpu")
    tokens = torch.randint(0, pc.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    plain = P.init_decode_state(pc, 2, 16, device="cpu")
    flash = P.init_decode_state(pc, 2, 16, seq_shards=1, device="cpu")
    for t in range(tokens.shape[1]):
        want, _ = P.decode_step(model, pc, plain, tokens[:, t:t + 1], t)
        got, _ = P.decode_step(model, pc, flash, tokens[:, t:t + 1], t,
                               seq_sharded=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(flash["body"][0][key],
                                   plain["body"][0][key])
    with pytest.raises(ValueError, match="scalar"):
        P.decode_step(model, pc, flash, tokens[:, :1], torch.tensor([1, 2]),
                      seq_sharded=True)

"""Multi-pod dry run: run every (architecture x input shape) cell's step once
on the production meshes, with meta tensors under a fake process group,
and record memory, cost and collective statistics (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA's SPMD partitioner
for 256 / 512 fake CPU devices.  Here rank 0 of a fake group of 256 / 512
ranks (``torch.testing``'s ``FakeStore``: collectives complete at once and
move nothing) runs the cell's step on meta-device DTensors laid out by
``models/sharding.py``: every layout, redistribution and shard-local
body runs, sharding mismatches raise, and nothing is allocated.  A cell
that fails is a hard failure.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun                    # the full matrix

The fake group is process-global: run the dry run in a process of its own,
never beside a real (NCCL, gloo) group.

One JSON per cell under --out with the reference's keys:
  memory       argument_size_in_bytes (this rank's shards of every input,
               from the local shards), per_device_total_bytes (the same),
               and peak_estimate_bytes: the peak of rank 0's tensors over
               the step by ``torch.distributed._tools.mem_tracker
               .MemTracker`` on the meta device (its inputs, activations,
               gradients and temporaries), an estimate, not a
               measurement (None where MemTracker refuses the step:
               torch 2.11's refuses a module entered twice, as a block
               recomputed in the backward is);
  global_cost  flops counted by ``torch.utils.flop_counter.FlopCounterMode``
               at the DTensor level, on global shapes (the shard-local
               bodies: the LM head, the MoE experts, the vocab-sharded
               loss, count rank 0's local work);
  device_cost  flops of rank 0's local ops (every op on a local shard);
  collectives  {"bytes", "counts", "total_bytes"} by the reference's kind
               names, per device: each collective rank 0 issues, with the
               bytes of its result (``collective_bytes``);
  params / active_params, and the wall times of building and running.
The per-device bytes are layout arithmetic for a 256- or 512-card mesh,
not measurements.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import time
import traceback

# torch's functional and c10d collectives by the reference's kind names
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "allgather_": "all-gather", "_allgather_base_": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "allreduce_": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter",
          "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all"}

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "s16": 2, "u16": 2, "pred": 1, "s64": 8,
                "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1}


def _nbytes(shape, dtype) -> int:
    if isinstance(dtype, str):
        size = _DTYPE_BYTES[dtype]
    else:
        import torch
        size = torch.empty((), dtype=dtype).element_size()
    return math.prod(shape) * size


def collective_bytes(entries) -> dict:
    """Per-device collective bytes by kind from recorded (kind, result
    shape, dtype) entries (dtype a torch dtype or an HLO name such as
    "bf16"): the counterpart of the reference's HLO-text parser, with
    the same output."""
    out = collections.Counter()
    counts = collections.Counter()
    for kind, shape, dtype in entries:
        out[kind] += _nbytes(shape, dtype)
        counts[kind] += 1
    return {"bytes": dict(out), "counts": dict(counts),
            "total_bytes": int(sum(out.values()))}


def _tally_mode():
    """A dispatch mode that sees rank 0's local ops (it lets DTensor run
    first, as ``CommDebugMode`` does): the FLOPs of each op with a formula
    in ``torch.utils.flop_counter`` and each collective's (kind, result
    shape, dtype)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import flop_registry

    def shape(x):
        return x.shape if isinstance(x, torch.Tensor) else x

    class Tally(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.entries: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](
                    *tree_map(shape, args), **tree_map(shape, kwargs),
                    out_val=tree_map(shape, out))
            kind = _KINDS.get(packet.__name__)
            if kind is not None and "c10d" in str(packet):
                res = out[0] if isinstance(out, (list, tuple)) else out
                if isinstance(res, torch.Tensor):
                    self.entries.append((kind, tuple(res.shape), res.dtype))
            return out
    return Tally()


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", world_size=world, rank=0,
                            store=FakeStore())


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str | None = None, cfg=None, mesh=None):
    """One cell's record (see the module docstring).  `cfg` overrides the
    registry's config of `arch` (a smoke config in tests), `mesh` the
    production mesh (then the caller has set the fake group up)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.run_long_context:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "full-attention arch: long_500k requires "
                          "sub-quadratic attention (DESIGN.md)"}
    if mesh is None:
        multi = mesh_kind == "multi"
        _fake_group(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.specs import arg_bytes, cell_specs

    t0 = time.time()
    step_fn, inputs, _, _ = cell_specs(cfg, shape, mesh)
    t_build = time.time() - t0
    t0 = time.time()
    with FlopCounterMode(display=False) as fc:
        step_fn(*inputs)
    t_global = time.time() - t0
    step_fn, inputs, _, _ = cell_specs(cfg, shape, mesh)
    t0 = time.time()
    with _tally_mode() as tally:
        step_fn(*inputs)
    t_device = time.time() - t0
    peak = _peak_estimate(cfg, shape, mesh)
    args = arg_bytes(inputs)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "n_devices": mesh.size,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {"argument_size_in_bytes": args,
                   "per_device_total_bytes": args,
                   "peak_estimate_bytes": peak},
        "global_cost": {"flops": float(fc.get_total_flops())},
        "device_cost": {"flops": float(tally.flops)},
        "collectives": collective_bytes(tally.entries),
        "build_s": round(t_build, 2),
        "run_s": round(t_global + t_device, 2),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _peak_estimate(cfg, shape, mesh):
    """``MemTracker``'s peak of rank 0's tensors over one more run of the
    cell's step (its inputs tracked as external), on every device; None
    where MemTracker refuses the step."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.launch.specs import cell_specs
    import torch
    step_fn, inputs, _, _ = cell_specs(cfg, shape, mesh)
    tensors = []

    def collect(t):
        if isinstance(t, torch.Tensor):
            tensors.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                collect(v)
    for arg in inputs[1:]:
        collect(arg)
    tracker = MemTracker()
    tracker.track_external(inputs[0], *tensors)
    try:
        with tracker:
            step_fn(*inputs)
    except NotImplementedError:
        return None
    return int(sum(v["Total"] for v in
                   tracker.get_tracker_snapshot("peak").values()))


def summary(r: dict) -> str:
    """One cell's line: GiB a device, FLOPs and collective bytes by kind."""
    coll = ", ".join(f"{k} {v / 2**20:.1f} MiB"
                     for k, v in sorted(r["collectives"]["bytes"].items()))
    peak = r["memory"]["peak_estimate_bytes"]
    return (f"{r['memory']['per_device_total_bytes'] / 2**30:.3f} GiB/dev "
            f"of arguments (peak estimate "
            f"{'n/a' if peak is None else f'{peak / 2**30:.3f}'}), "
            f"{r['global_cost']['flops']:.3e} FLOPs "
            f"({r['device_cost']['flops']:.3e} on rank 0), "
            f"coll {r['collectives']['total_bytes'] / 2**20:.1f} MiB/dev "
            f"[{coll}], run {r['run_s']}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_NAMES
    from repro_torch.configs.base import SHAPES

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                fn = os.path.join(args.out,
                                  f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(fn):
                    print(f"[skip] {tag} (exists)", flush=True)
                    continue
                try:
                    r = run_cell(arch, shape, mesh_kind, args.out)
                    if r["status"] == "skipped":
                        print(f"[skip] {tag}: {r['reason']}", flush=True)
                        os.makedirs(args.out, exist_ok=True)
                        with open(fn, "w") as f:
                            json.dump(r, f, indent=1)
                        continue
                    print(f"[ ok ] {tag}: {summary(r)}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()

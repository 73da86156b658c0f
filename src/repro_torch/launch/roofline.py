"""Roofline analysis from the dry-run records (port of
``repro.launch.roofline``), with the H100's published peaks.

Per (arch x shape x mesh) cell, the three roofline terms:

  T_compute    = analytic FLOPs         / (cards * bf16 dense tensor rate)
  T_memory     = per-device state bytes / HBM bandwidth
  T_collective = collective bytes       / NVLink bandwidth per direction

FLOPs: ``analytic_flops``, the per-arch model copied from the reference
(config arithmetic), is the compute term; the dry run's counted FLOPs are
reported beside it.  The reference multiplies its XLA counts by the number
of scanned layers (XLA's cost analysis counts a scan body once); the
port's step is no scan, every layer's ops run and are counted, so that
correction falls away.

Memory term: every step streams the resident state (parameters, optimizer
state, caches) once, so the per-device argument bytes of the dry run are
its floor; the step's temporaries are not measured on meta tensors.

Collective term: the per-device result bytes of every collective rank 0
issued (``dryrun.collective_bytes``).  The ring estimate moves (n-1)/n of
each op's bytes, twice for an all-reduce (reduce-scatter + all-gather),
over the card's NVLink bandwidth.  No collective across cards has been
measured on the port (one card): the term is arithmetic.

MODEL_FLOPS = 6 N D_tokens (train) / 2 N_active D_tokens (inference) gives
the useful-compute ratio.

``RATES`` is the one table of published peaks (NVIDIA H100 Tensor Core GPU
data sheet), by card; ``chip_smoke.card_rates`` reads its kernel bounds
from it too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

# Published peaks, NVIDIA H100 Tensor Core GPU data sheet (dense rates;
# the sheet's tensor-core figures with sparsity are twice these).
# bytes: HBM bytes/s; float32: flop/s outside the tensor cores; tf32 and
# bf16: dense tensor-core flop/s; nvlink: NVLink bytes/s per direction
# (the sheet's bidirectional figure halved).
RATES = {
    # H100 SXM5 80 GB (HBM3): 3.35 TB/s, FP32 67 TF, TF32 495 TF,
    # BF16 989 TF, NVLink 900 GB/s
    "SXM": {"bytes": 3.35e12, "float32": 67e12, "tf32": 495e12,
            "bf16": 989e12, "nvlink": 450e9},
    # H100 PCIe 80 GB (HBM2e): 2.0 TB/s, FP32 51 TF, TF32 378 TF,
    # BF16 756 TF, NVLink bridge 600 GB/s
    "PCIe": {"bytes": 2.0e12, "float32": 51e12, "tf32": 378e12,
             "bf16": 756e12, "nvlink": 300e9},
}


def rates(card: str) -> dict:
    """The peaks of the card named `card` (``torch.cuda.get_device_name``
    or nvidia-smi's name): the PCIe part by name, else the SXM part."""
    return RATES["PCIe" if "PCIe" in card else "SXM"]


def analytic_flops(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Forward-pass FLOPs (matmul-dominated terms), per the usual
    2*params-per-token + attention accounting; train = 3x forward."""
    s, b = shape.seq_len, shape.global_batch
    tokens = b * (1 if shape.kind == "decode" else s)
    n_active = cfg.active_param_count()
    # non-embedding active params do 2 FLOPs/param/token; embedding is a
    # gather (no matmul flops); dense head does 2*D*V per token
    n_embed = cfg.vocab * cfg.d_model
    matmul = 2.0 * (n_active - n_embed) * tokens

    # attention score/context FLOPs
    attn = 0.0
    ctx = s  # kv length
    for blk_list, reps in ((cfg.prefix_pattern,
                            cfg.n_prefix // max(len(cfg.prefix_pattern), 1)),
                           (cfg.pattern, cfg.n_periods)):
        for blk in blk_list:
            if blk.mixer in ("attn", "mla"):
                q_hd = (cfg.mla_nope_dim + cfg.mla_rope_dim
                        if blk.mixer == "mla" else cfg.head_dim)
                v_hd = cfg.mla_v_dim if blk.mixer == "mla" else cfg.head_dim
                if shape.kind == "decode":
                    per_tok = 2.0 * cfg.n_heads * (q_hd + v_hd) * ctx
                    attn += reps * per_tok * tokens
                else:
                    # causal: S*S/2 pairs
                    attn += reps * 2.0 * cfg.n_heads * (q_hd + v_hd) \
                        * b * s * s / 2
            elif blk.mixer == "attn_local":
                w = cfg.local_window
                eff = w if shape.kind == "decode" else min(2 * w, s)
                per_tok = 2.0 * cfg.n_heads * 2 * cfg.head_dim * eff
                attn += reps * per_tok * tokens * (0.5 if shape.kind != "decode" and s <= w else 1.0)
            elif blk.mixer == "mamba":
                di, ds = 2 * cfg.d_model, 16
                attn += reps * tokens * (2.0 * di * ds * 4)   # scan updates
            elif blk.mixer in ("mlstm",):
                di = 2 * cfg.d_model
                hd = di // cfg.n_kv_heads
                eff = 128 if shape.kind != "decode" else 1    # chunk size
                attn += reps * tokens * 2.0 * di * (hd + eff)
            elif blk.mixer == "slstm":
                attn += reps * tokens * 8.0 * cfg.d_model * cfg.d_model
    fwd = matmul + attn
    total = 3.0 * fwd if shape.kind == "train" else fwd
    model_flops_basis = (6.0 if shape.kind == "train" else 2.0) \
        * (cfg.active_param_count() - n_embed) * tokens
    return {"fwd": fwd, "total": total, "model_flops": model_flops_basis,
            "tokens": tokens}


def roofline_cell(record: dict, card: str = "NVIDIA H100 80GB HBM3",
                  cfg: ModelConfig | None = None) -> dict:
    """The roofline row of one dry-run record on the card named `card`
    (`cfg` overrides the registry's config of the record's arch)."""
    cfg = cfg if cfg is not None else get_config(record["arch"])
    shape = SHAPES[record["shape"]]
    peak = rates(card)
    cards = record["n_devices"]
    an = analytic_flops(cfg, shape)

    t_compute = an["total"] / (cards * peak["bf16"])
    t_memory = record["memory"]["argument_size_in_bytes"] / peak["bytes"]
    t_collective = record["collectives"]["total_bytes"] / peak["nvlink"]
    ring = 0.0
    for kind, b in record["collectives"]["bytes"].items():
        factor = 2.0 if kind == "all-reduce" else 1.0
        ring += factor * b * (cards - 1) / cards
    t_collective_ring = ring / peak["nvlink"]

    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)), key=lambda kv: kv[1])
    useful = an["model_flops"] / max(an["total"], 1.0)
    frac = t_compute / max(t_compute, t_memory, t_collective)
    return {
        **{k: record[k] for k in ("arch", "shape", "mesh", "n_devices")},
        "card": card,
        "T_compute_s": t_compute,
        "T_memory_s": t_memory,
        "T_collective_s": t_collective,
        "T_collective_ring_s": t_collective_ring,
        "dominant": dominant[0],
        "roofline_fraction": frac,
        "analytic_flops": an["total"],
        "counted_flops": record["global_cost"]["flops"],
        "model_flops": an["model_flops"],
        "useful_compute_ratio": useful,
        "mem_gib_per_dev": record["memory"]["per_device_total_bytes"] / 2**30,
    }


HEADER = (f"{'arch':<22}{'shape':<13}{'mesh':<7}{'Tcomp':>9}{'Tmem':>9}"
          f"{'Tcoll':>9}{'Tc-ring':>9} {'dom':<11}{'frac':>6}"
          f"{'useful':>8}{'GiB/dev':>9}")


def row_text(r: dict) -> str:
    return (f"{r['arch']:<22}{r['shape']:<13}{r['mesh']:<7}"
            f"{r['T_compute_s']:>9.2e}{r['T_memory_s']:>9.2e}"
            f"{r['T_collective_s']:>9.2e}{r['T_collective_ring_s']:>9.2e}"
            f" {r['dominant']:<11}"
            f"{r['roofline_fraction']:>6.2f}{r['useful_compute_ratio']:>8.2f}"
            f"{r['mem_gib_per_dev']:>9.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/dryrun")
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--card", default="NVIDIA H100 80GB HBM3",
                    help="the card whose published peaks bound the cells")
    args = ap.parse_args(argv)

    rows = []
    for fn in sorted(glob.glob(os.path.join(args.dryrun_dir, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        rows.append(roofline_cell(rec, args.card))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    print(HEADER)
    print("-" * len(HEADER))
    for r in rows:
        print(row_text(r))
    return rows


if __name__ == "__main__":
    main()

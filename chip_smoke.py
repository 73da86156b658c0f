#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of LogHD on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/repro_torch/``, holds each kernel against its plain PyTorch
version on the card, then runs five classifier paths through the public
entry points at the paper's full width, the isolet surrogate (F=617, C=26,
D=10,000, 6,238 train / 1,559 test rows), and the decoder LM:

1. LogHD without refinement (``make_classifier("loghd", ..., k=2,
   extra_bundles=5, refine_epochs=0)``) -> fit -> predict -> the 1-bit and
   4-bit bit-flip sweeps (6 p x 3 trials in one p-chunk: one batched
   ``flip_corrupt`` launch a sweep);
2. the matched-memory comparison at budget 0.4 on one shared encoder,
   encodings and prototypes (``benchmarks/common.py``): LogHD (n=10, 50
   Eq. 9 epochs), SparseHD (sparsity 0.6, 30 OnlineHD epochs), hybrid
   (n=20, sparsity 0.48, 50 epochs) and conventional (10 OnlineHD epochs),
   each fitted with every minibatch through ``bundle_update`` (the (n, B,
   D) of each step recorded), predicted, and swept at 1 bit with the
   hypervector scope;
3. the fault-model zoo on path 2's LogHD and conventional models:
   ``fault_model="iid"`` against the default 4-bit sweep, a 4-bit
   hypervector-scope sweep per registered model over its severity grid
   (``ZOO_GRIDS``, those of ``benchmarks/breakpoint_surface.py``), then
   the ID-level encoder at full width (16 levels) with a LogHD fit (path
   2's settings) on its encodings and an iid sweep;
4. serving: path 1's LogHD model and path 2's conventional model saved
   with ``save_model`` and loaded with ``load_model``, each registered in a
   ``ClassifierService`` at f32 and at int8 residency (max_batch 64, the
   bucket ladder 1, 2, ..., 64), warmed up, then a closed loop over all
   1,559 test rows as raw features per served model (every cycle encodes
   through ``hdc_encode``), an open-loop Poisson run of 512 requests at
   half the closed-loop rate, the encoded-input form once, and
   ``serve_forever`` followed by ``shutdown(drain=True)``;
5. extreme C: the class-sharded LogHD estimator (``class_sharding=8``)
   over an NCCL process group of one rank, at the reference extreme
   bench's shapes (C = 2^16 and 2^20, F = 32, D = 256) and at the full
   width (C = 2^20, F = 617, D = 10,000, n = 20 bundles): fit, predict,
   residency per shard, peak memory, labels at S = 1, 2, 8 against the
   gathered plain route, the data-parallel fits at Dp = 2 (exact and int8
   all-reduce), checkpoints by ``save_model`` and ``AsyncCheckpointer``,
   and a 1-bit sweep (its ``flip_corrupt`` launch made again on the same
   leaves and held bit for bit against plain, its accuracies against the
   per-point loop);
6. the LM: qwen3-1.7b at full width (28 layers, d_model 2,048, vocab
   151,936) with the LogHD vocab head (n = 20 bundles), weights drawn on
   the card from a seed: teacher-forced ``decode_step`` against
   ``forward`` over (2, 32) tokens in float32, then ``run_serving`` with
   ``launch/serve.py``'s traffic (6 requests, prompts of 3 + i mod 5
   tokens, 4 slots, 16 new tokens, ``max_len`` 256, greedy) in bfloat16,
   once with the loghd head and once with the dense head;
7. LM training at the same width (bf16, remat "full"): the ``loghd_head``
   gradient (kernel forward, torch backward) against autograd through the
   plain version at the training shape (1,024, 2,048, 20, 151,936) in bf16
   and float32, nonzero gradients on every parameter, 20 steps of
   ``make_train_step`` at ``launch/train.py``'s defaults (batch 8 x 128,
   AdamW with float32 moments, peak LR 3e-4, warmup 10) under each head
   (the dense head's losses falling, the loghd head's held step by step
   against the same steps through the plain head on the card), one
   chunked-CE step at (2, 1,024), ``run_training`` with int8 moments and
   its ~7 GB checkpoint under ``build/``, and a stop / resume against a
   straight run at two layers;
8. slice 12's architectures at their published widths (``LM_ARCHS``),
   each model freed before the next: granite-moe-1b-a400m (24 layers,
   attention + MoE of 32 experts, top-8) and xlstm-125m (12 layers of
   mLSTM / sLSTM) under both heads, jamba-v0.1-52b cut to one period of 8
   layers (7 Mamba, 1 attention, 4 MoE of 16 experts; 13.3 B parameters)
   and deepseek-v3-671b cut to one dense MLA layer and one MoE MLA layer
   of 256 experts (14 B parameters) under the loghd head: teacher-forced
   decode against forward in float32 (granite whole, xlstm and jamba one
   period, at capacity factor E / k), ``run_serving`` of the serving
   CLI's traffic in bf16 with launch counting, a repeat and a profiled
   decode step, and two granite training steps at the training CLI's
   defaults (every parameter's and every expert's gradient nonzero, a
   positive aux loss);
9. slice 13's sharded LM (``phase_lm_sharded``), over an NCCL group of
   one rank and ``make_debug_mesh()``, the ("data", "model") mesh of
   (1, 1): 3 steps of ``launch/train.py --mesh debug`` at its defaults
   with qwen3-1.7b's loghd head against the same steps without the mesh
   (losses within LT_PLAIN_ATOL, one ``loghd_head`` launch a step, walls
   and peak bytes both ways), the serving traffic through
   ``decode_step(..., mesh)`` (the same tokens, one launch a step),
   granite-moe's expert-parallel decode against the unsharded one, the
   sequence-sharded flash decode at qwen3's attention widths against the
   plain decode, the elastic restore of an unsharded checkpoint onto the
   mesh (qwen3 cut to 2 layers: the first resumed loss equal), and the dry
   run of ``LS_DRY_CELLS`` in processes of their own under a fake group
   of 256 / 512 ranks, each cell's bytes a device, FLOPs, collectives and
   roofline row on this card's published peaks;
10. the four examples (``phase_examples``), each ``examples/*_torch.py``
   ``main([])`` at the JAX examples' sizes and counted on its own: the
   quickstart (its accuracies against the plain route's labels, its two
   1-bit sweeps against the per-point loop), extreme classification at
   C = 4,096, D = 8,192 (both models' kernel labels equal to plain on the
   2,048 test rows), the 100M-word stream (12 shards through the dp fit on
   the example's own NCCL group of one rank, one shard's fit profiled),
   and the LM head example (60 steps a head, the loghd run repeated
   through the head's plain version: both fall, within LT_PLAIN_ATOL);
   then each kernel against plain at the shapes the examples gave it, and
   timing rows there (``bundle_sim`` over 4,096 prototypes beside
   ``F.normalize(h) @ m.T``).

It checks each kernel against its plain version (``flip_corrupt`` bit for
bit, batched over 1 and 18 points at bits 1, 2, 4 and 8 on LogHD's,
conventional's and ragged leaves, also against the one-point launches;
``bundle_sim`` also at the
serving shapes, with rows bitwise equal at B = 1, 64 and 1,559 and two
launches equal; ``profile_decode`` at ``PD_SHAPES``, the extreme C = 2^16
among them, with rows bitwise equal at B = 1, 64 and 1,559, two launches
equal, and a launch chained after ``bundle_sim`` by programmatic dependent
launch equal to an unchained one; ``loghd_head`` at B = 1, 4, 64 and 512
of qwen3-1.7b's head and at n = 64 against a vocabulary no tile divides,
and at B = 1, 4 and 64 of each slice 12 architecture's head (deepseek's
also at 2,048 rows, a training step's head call), every dtype
pair, with the float32 argmax of plain, two launches equal and
bf16 profiles equal to their float32 cast; ``moe_slots`` exactly, at
``MS_SHAPES``), each path's launch counts
(``bundle_sim``'s split into
serving-bucket and full-batch calls), that fits repeat bit for bit (the
LogHD repeat with TF32 turned on globally, watching that every matmul of
the fit runs in full float32), that kernel and plain predict and training
agree, that each sweep's p=0 row equals the clean accuracy of the
quantized model, that each sweep launches ``flip_corrupt`` once and gives
the accuracy matrix of the per-point loop and of ``p_chunk=4`` bit for bit
(their walls and the sweep's device idle share printed beside), that
``"iid"`` gives the default sweep's matrix bit for bit with one launch,
that every other zoo model launches ``flip_corrupt`` never and equals its
per-point loop, that the card's word algebra under masks drawn on the CPU
equals the CPU's (0 elements differ), that each model's rates on the
card's generator pass the chi-squared bounds of
``tests/test_fault_models.py``, that the ID-level sums equal the CPU's
bit for bit, that an encoded row has the same bits at B = 1, 64 and
1,559, that served labels equal ``predict`` of the loaded model (of
its int8 quantization for the int8 residency), that ``loghd_head`` rows
are bitwise independent of the batch, that the LM's decode matches its
forward within 2e-3, that ``loghd_head`` launches exactly once per
decode step under the loghd head, never under the dense one, with the
same tokens on a repeat, and exactly once per training step (4 times in
the chunked step: a forward and a recomputation per chunk), never under
the dense head; then it times every kernel, its plain version
and a library call with CUDA events and the profiler, and the chained
launches by their span in a CUDA graph (``graph_span_ms``): ``bundle_sim``
then ``profile_decode`` at 64 and 1,559 rows with the chain on and off,
``loghd_head``'s two stages with it on and off, and a one-element ``add_``
as this card's floor for a launch.

Output: the serving rates and latencies, the LM's tokens/s and the wall,
device time and idle share of one decode step, a JSON line with one entry per
kernel (``bundle_sim`` at B = 1, 64, 1,559 against n = 10 and 26 bundles,
``hdc_encode`` at B = 1, 64 and 1,559, ``bundle_update`` at each
family's minibatch, ``flip_corrupt`` at one point and at the sweeps'
18-point chunks, beside the chunk's one-point launches, with the sweeps'
walls under ``sweeps``, ``profile_decode`` at ``PD_SHAPES`` and ``loghd_head``
at B = 4 and 512 with bf16 and float32 profiles, at the training step's
1,024 rows and at B = 4 of each slice 12 architecture under ``shapes``,
``moe_slots`` at granite's training step, deepseek's 256 experts and a
decode step beside the one-hot cumsum;
``profile_decode``'s chained pair and the launch floor under
``chains``), the number of rows whose kernel label
differs from the plain route's beside each agreement share, the card's
name and power limit as ``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check
raises, so the exit code is not 0; without a CUDA device, or outside a
checkout, it exits with an error before printing any result.
"""

from __future__ import annotations

import collections
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Tolerances of the JAX package's own kernel tests (tests/test_kernels.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ENC_TOL = dict(rtol=2e-4, atol=2e-5)
P_GRID = [0.0, 0.05, 0.1, 0.2, 0.3, 0.4]
N_TRIALS = 3
KERNELS = {
    "bundle_sim": ("src/repro_torch/kernels/csrc/bundle_sim.cu",
                   "src/repro/kernels/bundle_sim/bundle_sim.py:61"),
    "profile_decode": ("src/repro_torch/kernels/csrc/profile_decode.cu",
                       "src/repro/kernels/profile_decode/profile_decode.py:50"),
    "flip_corrupt": ("src/repro_torch/kernels/csrc/flip_corrupt.cu",
                     "src/repro/kernels/flip_corrupt/flip_corrupt.py:116"),
    "bundle_update": ("src/repro_torch/kernels/csrc/bundle_update.cu",
                      "src/repro/kernels/bundle_update/bundle_update.py:74"),
    "hdc_encode": ("src/repro_torch/kernels/csrc/hdc_encode.cu",
                   "src/repro/kernels/hdc_encode/hdc_encode.py:70"),
    "loghd_head": ("src/repro_torch/kernels/csrc/loghd_head.cu",
                   "src/repro/kernels/loghd_head/loghd_head.py:78"),
    "moe_slots": ("src/repro_torch/kernels/csrc/moe_slots.cu",
                  "none: `jnp.cumsum`, `src/repro/models/moe.py:101`"),
    "flash_attn": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                   "none: the einsums of `src/repro/models/attention.py:107`"),
}
# the launch names each kernel's wrapper counts under
KERNEL_LAUNCHES = {"flash_attn": ("flash_attn_fwd", "flash_attn_bwd")}
# flash_attn's checked and timed shapes (B, S, H, KVH, d, dv): the three
# training cells' attention, granite at 8 x 4,096 and 32 x 1,024 (16 query
# heads on 8 KV heads of 64) and DeepSeek-V3's MLA at 4 x 4,096 (128 heads,
# 192 / 128)
FA_SHAPES = [(8, 4096, 16, 8, 64, 64), (32, 1024, 16, 8, 64, 64),
             (4, 4096, 128, 128, 192, 128)]
# every comparison is the largest over (batch row, head, FA_TILE rows of
# queries or keys) of ||a - b|| / ||b|| (``fa_tile_err``), over the whole
# o, dq, dk and dv; the plain version in float32 runs on pieces of at most
# FA_PIECE scores.  At these shapes on an H100 the kernel read at most
# 2.4e-3 (o) and 3.3e-3 (gradients) against the float32 plain version,
# and 1.1e-2 against the einsum path, whose own distance from the plain
# version is 6.1e-3 (o) and 1.1e-2 (gradients): the bf16 noise of the
# reference's arithmetic.  The tolerances stand about 2.5 times above the
# kernel's readings, so that a 3% fault on one tile fails
FA_TILE, FA_PIECE = 128, 1 << 28
FA_TOL = {"o": 6e-3, "grads": 8e-3, "einsum": 2.5e-2}
# moe_slots' checked shapes (tokens T, experts E, top-k, capacity factor):
# granite-moe's training step (8 x 4,096 tokens, top-8 of 32), deepseek-v3's
# 256 experts and a decode step of 4 tokens (these three timed), granite's
# step at E / k, jamba's 16 experts on a ragged call, deepseek-v3-ep32's
# training step (4 x 4,096 tokens, top-8 of 256, cap 640), and the last
# shape with every choice to one expert under a capacity of one
MS_SHAPES = [(32768, 32, 8, 1.25), (4096, 256, 8, 1.25), (4, 32, 8, 1.25),
             (32768, 32, 8, 4.0), (1000, 16, 2, 1.25), (16384, 256, 8, 1.25),
             (4, 256, 8, 32.0)]
# profile_decode's checked and timed shapes (B, n, C): a lone request, a
# serving bucket and the predict batch against LogHD's n = 10 bundles and
# isolet's 26 classes, hybrid's n = 20, and the extreme-classification
# C = 2^16 of examples/extreme_classification.py
PD_SHAPES = [(1, 10, 26), (64, 10, 26), (1559, 10, 26), (1559, 20, 26),
             (64, 16, 65536)]
# the LM phase: qwen3-1.7b at full width; loghd_head at one row, the serving
# step (B = 4), a 64-row batch and a 512-row prefill (B, D, n, V), and at
# n = 64 bundles against a vocabulary that no tile divides, at the JAX
# package's loghd_head tolerances (tests/test_kernels.py:128-129)
LM_ARCH = "qwen3-1.7b"
LH_SHAPES = [(1, 2048, 20, 151936), (4, 2048, 20, 151936),
             (64, 2048, 20, 151936), (512, 2048, 20, 151936)]
LH_RAGGED = (5, 2048, 64, 100003)
LH_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=5e-2, atol=5e-1)}
# the serving phase's checkpoints (under the gitignored build directory)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
MAX_BATCH = 64
N_OPEN_LOOP = 512
# Severity grids of the fault-model zoo, one per registered model, as
# benchmarks/breakpoint_surface.py sweeps them (drift's are read counts)
ZOO_GRIDS = {
    "iid": [0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3],
    "asymmetric": [0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3],
    "burst": [0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7],
    "stuck_at": [0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.6],
    "drift": [0.0, 25.0, 50.0, 100.0, 200.0, 400.0, 800.0],
}
ZOO_BITS = 4
# test rows the ID-level encoding is compared on against the CPU
ID_ROWS = 256
# chi-squared with 4 degrees of freedom: P[> 23.5] ~ 1e-4
# (tests/test_fault_models.py)
CHI2_DF4 = 23.5


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> dict:
    """Published peaks used for the bounds, from the one table
    ``repro_torch.launch.roofline.RATES`` (NVIDIA H100 data sheet), which
    the roofline reads too: memory bytes/s, float32 flop/s outside the
    tensor cores, int32 op/s (half the float32 rate: Hopper has 64 INT32
    and 128 FP32 lanes per SM), the float32 flop/s of 3xTF32 on the tensor
    cores (three dense TF32 products per float32 one), the units of
    ``hdc_encode``'s product, and the dense bf16 tensor-core and NVLink
    (per direction) rates."""
    from repro_torch.launch.roofline import rates
    r = rates(name)
    return {"bytes": r["bytes"], "float32": r["float32"],
            "int32": r["float32"] / 2, "tf32x3": r["tf32"] / 3,
            "bf16": r["bf16"], "nvlink": r["nvlink"]}


def bound_ms(rates: dict, n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / rates["bytes"] * 1e3
    t_ops = n_ops / rates[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int = 25, inner: int = 10) -> float:
    """Median over `reps` runs of the CUDA-event time per call, each run
    timing `inner` back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def warm(torch, fn, ms: float = 50.0) -> None:
    """Call fn for about `ms` of wall time, so that the card's clocks are
    up before a measurement."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < ms:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def device_ms(torch, fn, calls: int = 40, tries: int = 6):
    """Device time per call of fn: torch.profiler's device events (kernels
    and copies) over `calls` calls, after warm-up.  The profiler drops
    device events from a session: a few in a long process (late in this
    script, 4 of every session's events), at times all of them.  Every call
    of fn runs the same kernels, so each event name counts as its mean time
    over the events recorded times its launches per call (its events over
    `calls`, rounded).  A session counts when every name kept at least 3/4
    of those events and its launches per call equal another counted
    session's; the result is the median of the first two such.  None, with
    a log line, when `tries` sessions give no two."""
    warm(torch, fn)
    counted = collections.defaultdict(list)
    seen = []
    for _ in range(tries):
        top = profile_calls(torch, fn, calls)[2]
        seen.append([(round(cnt * calls), name[:40]) for _, cnt, name in top])
        launches = {name: round(cnt) for _, cnt, name in top}
        if not top or any(cnt < 0.75 * max(launches[name], 1)
                          for _, cnt, name in top):
            continue
        plan = tuple(sorted(launches.items()))
        counted[plan].append(sum(ms / cnt * launches[name]
                                 for ms, cnt, name in top))
        if len(counted[plan]) == 2:
            return statistics.median(counted[plan])
    log(f"device_ms: no two whole profiler sessions of {calls} calls; "
        f"events by name: {seen}")
    return None


def graph_span_ms(torch, fn, copies: int = 20, replays: int = 10,
                  reps: int = 5) -> float:
    """Device span per call of fn: CUDA events around `replays` replays of
    a CUDA graph captured from `copies` back-to-back calls of fn, median of
    `reps`, after warm-up.  The graph takes the host's launch cost out, and
    a call of two kernels chained by programmatic dependent launch counts
    once, from the first kernel's start to the second's end (the
    profiler's durations would count the second kernel's wait as well).
    The graph is for timing only; the port launches eagerly."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    warm(torch, graph.replay)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * copies))
    del graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return statistics.median(times)


def profile_calls(torch, fn, calls: int = 10):
    """(device ms per call, device kernels and copies per call, the device
    events as (ms per call, count per call, name), largest first) of
    `calls` calls of fn under torch.profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / calls
    count = sum(e.count for e in kern) / calls
    top = sorted(((e.self_device_time_total / 1e3 / calls, e.count / calls,
                   e.key) for e in kern), reverse=True)
    return busy, count, top


def moe_layers(model) -> int:
    """The LM's MoE ffn blocks: each routes once a forward, one
    ``moe_slots`` launch (twice a training step under remat)."""
    from repro_torch.models.moe import MoE
    return sum(isinstance(m, MoE) for m in model.modules())


def flash_launches(model, cfg, seq: int, fwd: int, bwd: int) -> dict:
    """``flash_attn``'s launches over `fwd` forward and `bwd` backward
    passes of `model` at sequence length `seq`: one a pass for each
    attention layer whose core is ``_sdpa`` (MLA, or attention without a
    window or with `seq` inside it) at a compiled width, in a bf16
    config; none otherwise."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.attention import Attention
    from repro_torch.models.mla import MLA
    layers = 0
    for m in model.modules() if cfg.dtype == "bfloat16" else ():
        if isinstance(m, Attention):
            full = m.cfg.window is None or seq <= m.cfg.window
            layers += full and (m.cfg.head_dim, m.cfg.head_dim) in fa.PAIRS
        elif isinstance(m, MLA):
            layers += (m.cfg.nope_dim + m.cfg.rope_dim,
                       m.cfg.v_dim) in fa.PAIRS
    fwd_name, bwd_name = KERNEL_LAUNCHES["flash_attn"]
    return {fwd_name: layers * fwd, bwd_name: layers * bwd}


def flash_train_launches(model, cfg, steps: int, seq: int) -> dict:
    """``flash_launches`` of `steps` training steps: a forward a step (two
    under remat: the recomputation) and a backward."""
    remat = 1 if cfg.remat_policy == "none" else 2
    return flash_launches(model, cfg, seq, steps * remat, steps)


# the LM paths that never call ``_sdpa``: decode, and serving, whose loop
# prefills a slot through decode steps
NO_FLASH = dict.fromkeys(KERNEL_LAUNCHES["flash_attn"], 0)


def lm_launches(launches: dict, flash: dict, what: str) -> dict:
    """An LM path's launches but attention's own, after checking those
    against `flash` (``flash_launches``) exactly."""
    got = {name: launches.get(name, 0) for name in flash}
    check(got == flash, f"{what}: flash_attn launches {got}, not {flash}")
    return {k: v for k, v in launches.items() if k not in flash}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    abs error at the main path's shape."""
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels.bundle_sim import (bundle_similarity,
                                                bundle_similarity_ref)
    from repro_torch.kernels.bundle_update import (bundle_update,
                                                   bundle_update_ref)
    from repro_torch.kernels.profile_decode import (profile_decode_scores,
                                                    profile_decode_scores_ref)
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    # the predict shapes of the four families: LogHD (n=10), conventional
    # (C=26), SparseHD at budget 0.4 (D'=4000), hybrid (n=20, D'=5200); the
    # serving shapes: a lone request and a full bucket of LogHD and of the
    # conventional model; then ragged shapes and n > 32
    for (b, d, n) in [(1559, 10000, 10), (1559, 10000, 26), (1559, 4000, 26),
                      (1559, 5200, 20), (1, 10000, 10), (64, 10000, 10),
                      (64, 10000, 26), (37, 1000, 3), (64, 1000, 40),
                      (37, 617, 5)]:
        for dtype in (torch.float32, torch.bfloat16):
            h = torch.randn((b, d), generator=g, device=dev).to(dtype)
            m = l2_normalize(torch.randn((n, d), generator=g, device=dev))
            got = bundle_similarity(h, m)
            want = bundle_similarity_ref(h, m)
            torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            err = max_err(got, want)
            log(f"bundle_sim     ({b}, {d}, {n}) {dtype}: max_abs_err {err:.3e}")
            check(got.shape == (b, n) and got.dtype == torch.float32,
                  "bundle_sim output shape / dtype")
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if (b, d, n) == (1559, 10000, 10) and dtype == torch.float32:
                errs["bundle_sim"] = err
    check_bundle_sim_rows(torch, dev, g)
    # PD_SHAPES (the predict and serving shapes of LogHD and hybrid, and the
    # extreme-classification C = 2^16), then ragged shapes and n > 32
    for (b, n, c) in PD_SHAPES + [(37, 7, 45), (100, 40, 70)]:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((b, n), generator=g, device=dev).to(dtype)
            p = torch.randn((c, n), generator=g, device=dev).to(dtype)
            got = profile_decode_scores(a, p)
            want = profile_decode_scores_ref(a, p)
            torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            err = max_err(got, want)
            log(f"profile_decode ({b}, {n}, {c}) {dtype}: max_abs_err {err:.3e}")
            check(got.shape == (b, c) and got.dtype == torch.float32,
                  "profile_decode output shape / dtype")
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if (b, n, c) == (1559, 10, 26) and dtype == torch.float32:
                errs["profile_decode"] = err
    check_profile_decode_rows(torch, dev, g)
    errs["flip_corrupt"] = check_flip_corrupt(torch, dev, g)
    # (n, B, D): LogHD refine, hybrid base, SparseHD retrain at budget 0.4,
    # conventional, then n > 32, everything ragged, more tiles than the
    # card holds blocks at once (blocks walk several tiles), and the
    # extreme phase's Eq. 9 steps at C = 2^16 and 2^20 (D = 256)
    tol = TOL["float32"]
    for (n, b, d) in [(10, 64, 10000), (20, 64, 10000), (26, 64, 4000),
                      (26, 256, 10000), (40, 37, 1000), (3, 7, 130),
                      (100, 64, 10000), (16, 64, 256), (20, 64, 256)]:
        m = l2_normalize(torch.randn((n, d), generator=g, device=dev))
        c = torch.randn((b, n), generator=g, device=dev)
        h = l2_normalize(torch.randn((b, d), generator=g, device=dev))
        got = bundle_update(m, c, h, 3e-4)
        again = bundle_update(m, c, h, 3e-4)
        want = bundle_update_ref(m, c, h, 3e-4)
        torch.cuda.synchronize()
        err = max_err(got, want)
        norms = torch.linalg.vector_norm(got, dim=-1)
        log(f"bundle_update  ({n}, {b}, {d}): max_abs_err {err:.3e}, "
            f"row norms within {max_err(norms, torch.ones_like(norms)):.2e} "
            f"of 1")
        check(got.shape == (n, d) and got.dtype == torch.float32,
              "bundle_update output shape / dtype")
        check(torch.equal(got, again), "bundle_update is not bitwise "
              "repeatable")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        torch.testing.assert_close(norms, torch.ones_like(norms), rtol=tol,
                                   atol=tol)
        if (n, b, d) == (10, 64, 10000):
            errs["bundle_update"] = err
    errs["hdc_encode"] = check_hdc_encode(torch, dev, g)
    return errs


def fa_flops(b: int, s: int, h: int, d: int, dv: int) -> tuple:
    """(forward, backward) flops of causal attention at q0 = 0: each of the
    s (s + 1) / 2 visible (query, key) pairs a head costs 2 (d + dv)
    forward (S = Q K^T, O = P V) and 2 (3 d + 2 dv) backward (S, dP = dO
    V^T, dV, dK, dQ)."""
    pairs = b * h * s * (s + 1) / 2
    return 2 * pairs * (d + dv), 2 * pairs * (3 * d + 2 * dv)


def fa_tile_err(a, b) -> float:
    """The largest ||a - b|| / ||b|| over (batch row, FA_TILE rows, head)
    of a and b (B, S, heads, width): each tile of rows judged on its own
    scale, so that late rows, whose values are small, count as much as the
    first."""
    import torch.nn.functional as F
    pad = -b.shape[1] % FA_TILE
    num, den = (F.pad(x, (0, 0, 0, 0, 0, pad)).unflatten(1, (-1, FA_TILE))
                .square().sum((2, 4)) for x in (a.float() - b.float(),
                                                b.float()))
    return float((num / den).sqrt().max())


def fa_compare(q, k, v, do, scale: float, got: list) -> dict:
    """flash_attn's results `got` (o (B, S, H * dv), dq, dk, dv) for q, k,
    v and the gradient ``do`` against the plain version in float32, run on
    pieces of at most FA_PIECE scores that cover every batch row and head,
    and against the einsum path at the whole shape.  Returns the
    ``fa_tile_err`` of o, dq, dk and dv against the plain version
    ("plain") and against the einsum path ("einsum"), the einsum path's
    own against the plain version ("einsum_plain": the bf16 noise of the
    reference's arithmetic) and the largest absolute difference from the
    plain version ("max_abs_err")."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models import attention as attn
    b, s, h, _ = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    g = h // kvh
    x = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o_e = attn._sdpa_einsum(*x, scale)
    o_e.backward(do)
    ein = [o_e.detach().view(b, s, h, dv)] + [t.grad for t in x]
    del x, o_e
    got = [got[0].view(b, s, h, dv)] + list(got[1:])
    do4 = do.view(b, s, h, dv)
    nk = min(kvh, max(1, FA_PIECE // (g * s * s)))
    nb = max(1, FA_PIECE // (h * s * s)) if nk == kvh else 1
    out = {"plain": [0.0] * 4, "einsum_plain": [0.0] * 4, "max_abs_err": 0.0}
    for b0 in range(0, b, nb):
        for k0 in range(0, kvh, nk):
            bs, ks = slice(b0, b0 + nb), slice(k0, k0 + nk)
            hs = slice(k0 * g, (k0 + nk) * g)
            qp, kp, vp = q[bs, :, hs], k[bs, :, ks], v[bs, :, ks]
            o_r, lse = fa.flash_attn_ref(qp, kp, vp, scale)
            want = [o_r.view(*qp.shape[:3], dv)] + list(
                fa.flash_attn_bwd_ref(do4[bs, :, hs].flatten(2), qp, kp, vp,
                                      o_r, lse, scale))
            for i, (w, heads) in enumerate(zip(want, (hs, hs, ks, ks))):
                mine, theirs = got[i][bs, :, heads], ein[i][bs, :, heads]
                out["plain"][i] = max(out["plain"][i], fa_tile_err(mine, w))
                out["einsum_plain"][i] = max(out["einsum_plain"][i],
                                             fa_tile_err(theirs, w))
                out["max_abs_err"] = max(out["max_abs_err"],
                                         max_err(mine, w))
            del o_r, lse, want
    out["einsum"] = [fa_tile_err(mine, e) for mine, e in zip(got, ein)]
    return out


def phase_flash_attn(torch, dev, rates: dict) -> tuple:
    """flash_attn against its plain version in float32 and against the
    einsum path at FA_SHAPES, over every batch row, head and row
    (``fa_compare``; one forward and one backward launch a training call),
    then the kernels' CUDA-event times beside their bound (causal bf16
    flops at the card's peak), the einsum path's and the library's
    (``scaled_dot_product_attention``, a yardstick the port never calls).
    Returns (the largest absolute difference from the plain version, the
    times, with the largest ``fa_tile_err`` as "max_rel_err")."""
    import math

    import torch.nn.functional as F
    from repro_torch.kernels import _build, common
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.models import attention as attn
    for line in _build.build_logs.get("flash_attn", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas flash_attn: {line.strip()}")
    log(f"flash_attn build: {_build.build_seconds.get('flash_attn')} s")
    g = torch.Generator(device=dev).manual_seed(31)
    worst_abs, worst_rel, rows = 0.0, 0.0, []

    for b, s, h, kvh, d, dv in FA_SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, s, kvh, d),
                                          (b, s, kvh, dv), (b, s, h * dv)))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        common.reset_launches()
        o = fa.flash_attn(*leaves, scale)
        o.backward(do)
        torch.cuda.synchronize()
        check(common.launches["flash_attn_fwd"] == 1
              and common.launches["flash_attn_bwd"] == 1,
              f"flash_attn launches {dict(common.launches)} for one call "
              f"and its backward")
        e = fa_compare(q, k, v, do, scale,
                       [o.detach()] + [t.grad for t in leaves])
        del leaves
        fmt = {key: " ".join(f"{x:.2e}" for x in e[key])
               for key in ("plain", "einsum", "einsum_plain")}
        log(f"flash_attn {(b, s, h, kvh, d, dv)}: largest ||a - b|| / ||b|| "
            f"over (batch row, head, {FA_TILE} rows) of o dq dk dv: against "
            f"plain (float32) {fmt['plain']}, against the einsum path "
            f"{fmt['einsum']}; the einsum path against plain "
            f"{fmt['einsum_plain']}; max_abs_err against plain "
            f"{e['max_abs_err']:.3e} (tolerances {FA_TOL})")
        check(e["plain"][0] <= FA_TOL["o"],
              f"flash_attn o differs by {e['plain'][0]:.2e}")
        check(max(e["plain"][1:]) <= FA_TOL["grads"],
              f"flash_attn gradients differ by {max(e['plain'][1:]):.2e}")
        check(max(e["einsum"]) <= FA_TOL["einsum"],
              f"flash_attn differs from the einsum path by "
              f"{max(e['einsum']):.2e}")
        worst_abs = max(worst_abs, e["max_abs_err"])
        worst_rel = max(worst_rel, *e["plain"])

        o, lse = fa_ops._fwd(q, k, v, scale, True, 0)
        fwd = lambda: fa_ops._fwd(q, k, v, scale, True, 0)
        bwd = lambda: fa_ops._bwd(do, q, k, v, o, lse, scale, True, 0)
        f_ops, b_ops = fa_flops(b, s, h, d, dv)

        def einsum_fb():
            x = [t.detach().requires_grad_(True) for t in (q, k, v)]
            attn._sdpa_einsum(*x, scale).backward(do)

        def library_fb():
            x = [t.detach().transpose(1, 2).requires_grad_(True)
                 for t in (q, k, v)]
            F.scaled_dot_product_attention(
                *x, is_causal=True, scale=scale, enable_gqa=kvh != h
            ).transpose(1, 2).reshape(b, s, h * dv).backward(do)
        row = {"shape": [b, s, h, kvh, d, dv],
               "fwd_ms": time_ms(torch, fwd, reps=10, inner=3),
               "bwd_ms": time_ms(torch, bwd, reps=10, inner=3),
               "fwd_bound_ms": f_ops / rates["bf16"] * 1e3,
               "bwd_bound_ms": b_ops / rates["bf16"] * 1e3,
               "plain_ms": time_ms(torch, einsum_fb, reps=3, inner=1),
               "library_ms": time_ms(torch, library_fb, reps=5, inner=2)}
        row["ms"] = row["fwd_ms"] + row["bwd_ms"]
        row["bound_ms"] = row["fwd_bound_ms"] + row["bwd_bound_ms"]
        row["fwd_tflops"] = f_ops / row["fwd_ms"] / 1e9
        row["bwd_tflops"] = b_ops / row["bwd_ms"] / 1e9
        log(f"time flash_attn {row}")
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    times = {key: rows[0][key] for key in ("ms", "plain_ms", "library_ms",
                                            "bound_ms")}
    times.update(bound_by="operations", device_ms=None, plain_device_ms=None,
                 library_device_ms=None, shapes=rows, max_rel_err=worst_rel)
    return worst_abs, times


def ms_case(torch, flat, e: int, cap: int) -> dict:
    """moe_slots' roles on one input: the kernel, its plain version (the
    one-hot cumsum route), the library yardstick ``F.one_hot(...)
    .cumsum(0)`` alone; its bytes (the ids read, slots and keep written)."""
    import torch.nn.functional as F
    from repro_torch.kernels.moe_slots import moe_slots, moe_slots_ref
    n = flat.shape[0]
    return dict(kernel=lambda: moe_slots(flat, e, cap),
                plain=lambda: moe_slots_ref(flat, e, cap),
                library=lambda: F.one_hot(flat, e).cumsum(0),
                bytes=17 * n, ops=0, op_type="int32")


def phase_moe_slots(torch, dev, rates: dict) -> tuple:
    """moe_slots against its plain version, exactly, at MS_SHAPES (top-k
    choices drawn on the card), one launch a call, two calls equal; then
    CUDA-event, profiler and graph-span times of the first three shapes
    (the plain and library versions fewer times: about 100 ms a call at
    granite's shape).  Returns (the largest slot difference, the times)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.moe_slots import moe_slots, moe_slots_ref
    from repro_torch.models.moe import MoEConfig
    g = torch.Generator(device=dev).manual_seed(11)
    err, rows = 0.0, []
    for i, (t, e, k, cf) in enumerate(MS_SHAPES):
        # scores skewed towards the higher experts, so that some overflow
        skew = torch.linspace(0.0, 0.5, e, device=dev)
        flat = (torch.rand((t, e), generator=g, device=dev) + skew).argsort(
            dim=1, descending=True)[:, :k].reshape(-1).contiguous()
        if i == len(MS_SHAPES) - 1:
            flat = torch.full_like(flat, 3)
            cap = 1
        else:
            cap = MoEConfig(d_model=8, d_ff=8, n_experts=e, top_k=k,
                            capacity_factor=cf).capacity(t)
        common.reset_launches()
        got = moe_slots(flat, e, cap)
        again = moe_slots(flat, e, cap)
        check(common.launches["moe_slots"] == 2,
              f"moe_slots launches {common.launches['moe_slots']} for 2 calls")
        want = moe_slots_ref(flat, e, cap)
        torch.cuda.synchronize()
        err = max(err, max_err(got[0], want[0]))
        log(f"moe_slots      ({t * k}, {e}) cap {cap}: slots differ "
            f"{int((got[0] != want[0]).sum())}, keep differ "
            f"{int((got[1] != want[1]).sum())}, kept "
            f"{int(got[1].sum())} of {t * k}")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"moe_slots differs from plain at {(t * k, e, cap)}")
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              "moe_slots is not repeatable")
        if i < 3:
            cs = ms_case(torch, flat, e, cap)
            b_ms, b_by = bound_ms(rates, cs["bytes"], cs["ops"],
                                  cs["op_type"])
            slow = t * k > 100_000
            row = {"shape": [t * k, e, cap], "bound_ms": b_ms,
                   "bound_by": b_by, "ms": time_ms(torch, cs["kernel"]),
                   "span_ms": graph_span_ms(torch, cs["kernel"]),
                   "device_ms": device_ms(torch, cs["kernel"])}
            for role in ("plain", "library"):
                fn = cs[role]
                row[f"{role}_ms"] = (time_ms(torch, fn, reps=3, inner=2)
                                     if slow else time_ms(torch, fn))
                row[f"{role}_device_ms"] = (
                    device_ms(torch, fn, calls=4, tries=3) if slow
                    else device_ms(torch, fn))
            log(f"time moe_slots {row}")
            rows.append(row)
    times = {key: rows[0][key] for key in (
        "ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
        "library_device_ms", "bound_ms", "bound_by")}
    times["shapes"] = rows
    return err, times


def sweep_points(n_leaves: int, ps=P_GRID, n_trials: int = N_TRIALS):
    """A sweep chunk's (p, trial) points, p-major as the sweep orders them:
    their ps, and their seed rows (one int32 seed per leaf, the trial's
    row of ``trial_seeds`` from a CPU generator seeded with 0, the seeds
    of the sweeps this script runs)."""
    import torch
    from repro_torch.core.evaluate import trial_seeds
    rows = trial_seeds(torch.Generator().manual_seed(0), n_trials, n_leaves)
    return ([p for p in ps for _ in range(n_trials)], rows * len(ps))


def fc_leaves(torch, dev, g, shapes, bits):
    """Random int8 codes of `bits` significant bits at each shape (a shape
    given as ("offset", n) is an n-code view one byte into its storage:
    4-byte loads cannot take it), each with a float32 scale."""
    leaves = []
    for j, shape in enumerate(shapes):
        b = bits[j] if isinstance(bits, (list, tuple)) else bits
        lo, hi = (0, 2) if b == 1 else (-(1 << (b - 1)), 1 << (b - 1))
        off = shape[0] == "offset"
        n = (shape[1] + 1,) if off else shape
        codes = torch.randint(lo, hi, n, generator=g, device=dev,
                              dtype=torch.int64).to(torch.int8)
        codes = codes[1:] if off else codes
        leaves.append((codes, torch.tensor(0.0123 * (j + 1), device=dev), b))
    return leaves


def fc_differing(torch, got, want) -> int:
    """Elements whose float32 bits differ between two lists of outputs."""
    return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(got, want))


def check_flip_corrupt(torch, dev, g) -> float:
    """flip_corrupt bitwise against its plain version: the one-point call
    at the sweep's two LogHD leaves; the batched call at G = 1 and 18 (the
    sweep's chunk, one point at p = 1) over bits 1, 2, 4, 8 and three leaf
    sets (LogHD's bundles and profiles, conventional's prototypes, and
    ragged leaves: 21 codes, 100,001 codes in a view off 4-byte alignment,
    4 x 333; at 18 points each set takes two groups a thread), also
    against G x L one-point launches; mixed bits in one launch; and the
    calls that take two launches (130 points, 5 leaves).  Returns the max
    abs error (0 when every check passes)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flip_corrupt import (flip_corrupt,
                                                  flip_corrupt_grid,
                                                  flip_corrupt_grid_ref,
                                                  flip_corrupt_ref)
    from repro_torch.kernels.flip_corrupt.ops import MAX_POINTS, _wave
    log(f"flip_corrupt: one wave of the card is "
        f"{_wave(torch.cuda.current_device())} one-group blocks")
    worst = 0.0
    for shape in [(10, 10000), (26, 10)]:
        for bits in (1, 4, 8):
            (codes, scale, _), = fc_leaves(torch, dev, g, [shape], bits)
            for p in (0.0, 0.1, 1.0):
                for seed in (42, (1 << 31) - 1):
                    got = flip_corrupt(codes, scale, bits, p, seed)
                    want = flip_corrupt_ref(codes, scale, p, seed, bits=bits)
                    torch.cuda.synchronize()
                    check(torch.equal(got.view(torch.int32),
                                      want.view(torch.int32)),
                          f"flip_corrupt not bit-exact at {shape} bits={bits} "
                          f"p={p} seed={seed}")
                    worst = max(worst, max_err(got, want))
    sets = {"loghd": [(10, 10000), (26, 10)], "conventional": [(26, 10000)],
            "ragged": [(21,), ("offset", 100001), (4, 333)]}
    n_cases = 0
    for name, shapes in sets.items():
        for bits in (1, 2, 4, 8):
            leaves = fc_leaves(torch, dev, g, shapes, bits)
            for n_points in (1, 18):
                ps, seeds = sweep_points(len(shapes))
                if n_points == 1:
                    ps, seeds = [0.1], seeds[:1]
                else:
                    ps[-1] = 1.0
                    seeds[0] = [-(1 << 31)] + seeds[0][1:]
                before = common.launches["flip_corrupt"]
                got = flip_corrupt_grid(leaves, ps, seeds)
                launched = common.launches["flip_corrupt"] - before
                want = flip_corrupt_grid_ref(leaves, ps, seeds)
                single = [torch.stack([
                    flip_corrupt(codes, scale, b, ps[k], seeds[k][j])
                    for k in range(n_points)])
                    for j, (codes, scale, b) in enumerate(leaves)]
                torch.cuda.synchronize()
                d_plain = fc_differing(torch, got, want)
                d_single = fc_differing(torch, got, single)
                check(launched == 1, f"flip_corrupt_grid {name} launched "
                      f"{launched} times, not once")
                check(all(o.shape == (n_points, *c.shape)
                          for o, (c, _, _) in zip(got, leaves)),
                      "flip_corrupt_grid output shapes")
                check(d_plain == 0 and d_single == 0,
                      f"flip_corrupt_grid {name} bits={bits} G={n_points}: "
                      f"{d_plain} elements differ from plain, {d_single} "
                      f"from one-point launches")
                worst = max([worst] + [max_err(a, b)
                                       for a, b in zip(got, want)])
                n_cases += 1
    # mixed bits in one launch; more points and more leaves than one launch
    # takes
    leaves = fc_leaves(torch, dev, g, sets["loghd"] + sets["ragged"],
                       [4, 1, 8, 2, 3])
    for n_leaves, n_points, launches in ((2, 18, 1), (3, MAX_POINTS + 2, 2),
                                         (5, 3, 2)):
        ps = [(k % 7) / 6 for k in range(n_points)]
        seeds = [[(7919 * k + 104729 * j) % (1 << 31) for j in range(n_leaves)]
                 for k in range(n_points)]
        sub = leaves[:n_leaves] if n_leaves != 3 else leaves[2:]
        before = common.launches["flip_corrupt"]
        got = flip_corrupt_grid(sub, ps, seeds)
        launched = common.launches["flip_corrupt"] - before
        want = flip_corrupt_grid_ref(sub, ps, seeds)
        torch.cuda.synchronize()
        diff = fc_differing(torch, got, want)
        check(diff == 0 and launched == launches,
              f"flip_corrupt_grid {n_leaves} leaves x {n_points} points: "
              f"{diff} elements differ, {launched} launches (want "
              f"{launches})")
        n_cases += 1
    log(f"flip_corrupt: one-point calls bit-exact over 2 shapes x bits "
        f"{{1,4,8}} x p {{0,0.1,1}} x 2 seeds; batched calls bit-exact "
        f"against plain and against one-point launches in {n_cases} cases "
        f"(0 elements differ)")
    return worst


def check_bundle_sim_rows(torch, dev, g) -> None:
    """bundle_sim rows have the same bits at B = 1, 64 and 1,559 (each row's
    sums run in an order fixed by D and n), and two launches give equal
    bits: at D = 10,000 for the LogHD (n = 10) and conventional (n = 26)
    bundles, in float32 and bfloat16."""
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels.bundle_sim import bundle_similarity
    for n in (10, 26):
        m = l2_normalize(torch.randn((n, 10000), generator=g, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            h = torch.randn((1559, 10000), generator=g, device=dev).to(dtype)
            full = bundle_similarity(h, m)
            again = bundle_similarity(h, m)
            b64 = bundle_similarity(h[:64].contiguous(), m)
            b1 = torch.cat([bundle_similarity(h[i:i + 1].contiguous(), m)
                            for i in range(64)])
            torch.cuda.synchronize()
            check(torch.equal(full, again),
                  f"bundle_sim (1559, 10000, {n}) {dtype}: two launches "
                  f"differ")
            check(torch.equal(full[:64], b64) and torch.equal(full[:64], b1),
                  f"bundle_sim (10000, {n}) {dtype}: a row's bits depend "
                  f"on the batch (B = 1559, 64, 1)")
    log("bundle_sim: rows 0-63 bitwise equal at B = 1, 64, 1559 and two "
        "launches equal, n = 10 and 26, float32 and bfloat16")
    from repro_torch.kernels.bundle_sim import ops as bs_ops
    for (b, d, n) in BS_TIME_SHAPES:
        kc, chunk, cluster, clusters, chunks, tiles, stages, smem = (
            bs_ops._launch_args(torch.cuda.current_device(), b, d, n, False))
        log(f"bundle_sim launch at ({b}, {d}, {n}) float32: {clusters} "
            f"clusters of {cluster} blocks x {chunks} bundle chunks of {kc}, "
            f"{tiles} row tiles, chunk {chunk} columns, {stages} stages, "
            f"{smem} bytes of shared memory a block")


def check_profile_decode_rows(torch, dev, g) -> None:
    """profile_decode rows have the same bits at B = 1, 64 and 1,559 (a
    row's sums run in an order fixed by n), two launches give equal bits,
    and a launch chained after bundle_sim (programmatic dependent launch)
    gives the bits of an unchained one: LogHD (n = 10) and hybrid (n = 20)
    profiles of isolet's 26 classes, float32 and bfloat16."""
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels import common
    from repro_torch.kernels.bundle_sim import bundle_similarity
    from repro_torch.kernels.profile_decode import profile_decode_scores
    for n in (10, 20):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((1559, n), generator=g, device=dev).to(dtype)
            p = torch.randn((26, n), generator=g, device=dev).to(dtype)
            full = profile_decode_scores(a, p)
            again = profile_decode_scores(a, p)
            b64 = profile_decode_scores(a[:64].contiguous(), p)
            b1 = torch.cat([profile_decode_scores(a[i:i + 1].contiguous(), p)
                            for i in range(64)])
            torch.cuda.synchronize()
            check(torch.equal(full, again), f"profile_decode (1559, {n}, 26) "
                  f"{dtype}: two launches differ")
            check(torch.equal(full[:64], b64) and torch.equal(full[:64], b1),
                  f"profile_decode ({n}, 26) {dtype}: a row's bits depend on "
                  f"the batch (B = 1559, 64, 1)")
        h = torch.randn((1559, 10000), generator=g, device=dev)
        m = l2_normalize(torch.randn((n, 10000), generator=g, device=dev))
        p = torch.randn((26, n), generator=g, device=dev)
        for on in (True, False):
            with common.pdl(on):
                chained = profile_decode_scores(bundle_similarity(h, m), p,
                                                pdl=True)
            acts = bundle_similarity(h, m)
            torch.cuda.synchronize()
            check(torch.equal(chained, profile_decode_scores(acts, p)),
                  f"profile_decode after bundle_sim (n = {n}, PDL {on}) "
                  f"differs from an unchained launch")
    log("profile_decode: rows 0-63 bitwise equal at B = 1, 64, 1559, two "
        "launches equal, chained after bundle_sim (PDL on and off) equal to "
        "unchained, n = 10 and 20, float32 and bfloat16")
    from repro_torch.kernels.profile_decode import ops as pd_ops
    for (b, n, c) in PD_SHAPES:
        ks, chunks, wc, t, rb, vbk, smem = pd_ops._launch_args(
            torch.cuda.current_device(), b, n, c, False)
        log(f"profile_decode launch at ({b}, {n}, {c}) float32: grid "
            f"({rb}, {vbk}), {wc} warp columns x {8 // wc} warp rows, {t} "
            f"row tiles a warp, {ks} k-steps x {chunks} chunks, {smem} bytes "
            f"of shared memory a block")


def enc_inputs(torch, dev, g, b: int, f: int, d: int):
    """x (B, F) standard normal, W (F, D) as the encoder draws it (N(0, 1)
    over sqrt(F) times bandwidth 2), bias in [0, 2 pi), a small center."""
    import math
    x = torch.randn((b, f), generator=g, device=dev)
    w = torch.randn((f, d), generator=g, device=dev) / (math.sqrt(f) * 2.0)
    bias = torch.rand((d,), generator=g, device=dev) * (2.0 * math.pi)
    center = torch.randn((d,), generator=g, device=dev) * 0.01
    return x, w, bias, center


def check_hdc_encode(torch, dev, g) -> float:
    """hdc_encode against its plain version at the serving and predict
    shapes, the extreme phase's (2,048 | 4,096 | 64, 32, 256), a D whose rows the normalisation cannot hold in registers
    (40,000 > 8 blocks x 2,048 columns), and ragged shapes (the last with
    D % 4 != 0, so W lands by cp.async, and x a view whose rows start off
    16-byte boundaries), every kind, rtol 2e-4
    / atol 2e-5 (the JAX package's own bound).  For rp_sign an element may
    differ only where |x W| is within rounding of 0 (the two sum in
    different orders, and the sign of such a z is not defined by the
    inputs); those are counted and must be rare.  Returns the max abs
    error at the 64-row cos shape."""
    from repro_torch.kernels.hdc_encode import hdc_encode, hdc_encode_plain
    from repro_torch.precision import full_f32
    err64 = None
    for (b, f, d) in [(1, 617, 10000), (64, 617, 10000), (4096, 617, 10000),
                      (2048, 32, 256), (4096, 32, 256), (64, 32, 256),
                      (3, 617, 40000), (100, 75, 2000), (37, 61, 1001)]:
        x, w, bias, center = enc_inputs(torch, dev, g, b, f, d)
        if (b, f, d) == (37, 61, 1001):   # rows that start off 16 bytes
            x = torch.randn((b + 1, f), generator=g, device=dev)[1:]
        for kind in ("cos", "rp", "rp_sign"):
            got = hdc_encode(x, w, bias, center, kind)
            with full_f32():
                want = hdc_encode_plain(x, w, bias, center, kind)
                z = x @ w
            torch.cuda.synchronize()
            check(got.shape == (b, d) and got.dtype == torch.float32,
                  "hdc_encode output shape / dtype")
            check(bool(torch.isfinite(got).all()), "hdc_encode not finite")
            close = torch.isclose(got, want, **ENC_TOL)
            note = ""
            if kind == "rp_sign":
                off = ~close
                n_off = int(off.sum())
                check(bool((z[off].abs() < 1e-5).all()),
                      "hdc_encode rp_sign differs where |xW| >= 1e-5")
                check(n_off <= max(1, got.numel() // 100_000),
                      f"hdc_encode rp_sign differs in {n_off} elements")
                close = close | off
                note = f", {n_off} signs of |xW| < 1e-5 differ"
                err = max_err(got[~off], want[~off])
            else:
                err = max_err(got, want)
            log(f"hdc_encode     ({b}, {f}, {d}) {kind}: max_abs_err "
                f"{err:.3e}{note}")
            check(bool(close.all()), f"hdc_encode ({b}, {f}, {d}) {kind} "
                  f"outside rtol 2e-4 / atol 2e-5")
            if (b, f, d, kind) == (64, 617, 10000, "cos"):
                err64 = err
    return err64


def phase_main_path(torch, dev) -> dict:
    """isolet LogHD fit -> predict -> 1-bit and 4-bit sweeps, through the
    public entry points on the card, with launch counting."""
    from repro_torch.api import dispatch, make_classifier
    from repro_torch.data.synth import load_dataset
    from repro_torch.kernels import common

    x_tr, y_tr, x_te, y_te, spec = load_dataset("isolet")
    log(f"dataset {spec.name}: F={spec.n_features} C={spec.n_classes} "
        f"train={len(x_tr)} test={len(x_te)}")
    kw = dict(dim=10_000, k=2, extra_bundles=5, refine_epochs=0,
              codebook_method="distance")
    y_dev = torch.as_tensor(y_te, device=dev)

    common.reset_launches()
    t0 = time.perf_counter()
    clf = make_classifier("loghd", spec.n_classes, spec.n_features, **kw)
    clf = clf.fit(x_tr, y_tr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    labels = clf.predict(x_te)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    acc = float((labels == y_dev).float().mean())
    model = clf.model
    h_te = clf.encode(x_te)

    sweeps, sweep_s = {}, 0.0
    for bits in (1, 4):
        before = common.launches["flip_corrupt"]
        t0 = time.perf_counter()
        accs = clf.sweep_under_flips(
            bits, P_GRID, h_te, y_te, n_trials=N_TRIALS, scope="all",
            predict_encoded=dispatch.predict_encoded,
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        sweep_s += time.perf_counter() - t0
        sweeps[bits] = (accs, common.launches["flip_corrupt"] - before)
    launches = dict(common.launches)
    log(f"main path launches: {launches}")

    # checks, after the counts were read
    check(labels.shape == (len(x_te),), "predict shape")
    check(0.0 <= acc <= 1.0 and acc > 0.5,
          f"clean accuracy {acc} is below 0.5")
    for name in ("bundle_sim", "profile_decode", "flip_corrupt"):
        check(launches.get(name, 0) > 0, f"{name} never launched on the path")
    # the fit's encoder calibration (4,096-row batches), predict, encode
    want_enc = -(-len(x_tr) // 4096) + 2
    check(launches.get("hdc_encode", 0) == want_enc,
          f"hdc_encode launched {launches.get('hdc_encode', 0)} times on "
          f"the path, not {want_enc}")
    plain = dispatch.predict_encoded(model, h_te, use_kernels=False)
    agree = float((plain == labels).float().mean())
    n_diff = int((plain != labels).sum())
    log(f"clean accuracy {acc:.4f}; kernel vs plain labels agree on "
        f"{agree:.5f} of {len(x_te)} rows ({n_diff} rows differ)")
    check(agree >= 0.999, f"kernel and plain labels agree on only {agree}")

    clf2 = make_classifier("loghd", spec.n_classes, spec.n_features, **kw)
    model2 = clf2.fit(x_tr, y_tr).model
    for leaf in ("bundles", "profiles"):
        check(torch.equal(getattr(model, leaf), getattr(model2, leaf)),
              f"second fit differs in {leaf}")
    log(f"second fit: bundles and profiles bitwise equal; sigma_inv equal: "
        f"{torch.equal(model.sigma_inv, model2.sigma_inv)}")

    for bits, (accs, n_flip) in sweeps.items():
        check(accs.shape == (len(P_GRID), N_TRIALS), "sweep shape")
        q = model.quantized(bits)
        qacc = (dispatch.predict_encoded(q, h_te) == y_dev).float().mean()
        qacc = float(qacc.cpu().numpy())
        log(f"sweep bits={bits} (rows p, columns trials; "
            f"clean quantized accuracy {qacc:.4f}):")
        for p, row in zip(P_GRID, accs):
            log(f"  p={p:<5} " + " ".join(f"{a:.4f}" for a in row))
        check(all(a == qacc for a in accs[0]),
              f"bits={bits}: p=0 row {accs[0]} != clean quantized {qacc}")
        # one p-chunk (the whole grid by default), one launch
        check(n_flip == 1,
              f"bits={bits}: flip_corrupt launched {n_flip} times, not once")
    log(f"wall: fit {fit_s:.3f} s, predict {predict_s:.3f} s "
        f"(encode + kernels), sweeps {sweep_s:.3f} s")
    walls = {bits: check_sweep_forms(torch, model, h_te, y_te, bits, "all",
                                     accs)
             for bits, (accs, _) in sweeps.items()}
    return {"launches": launches, "model": model, "h_te": h_te,
            "x_te": x_te, "acc": acc, "fit_s": fit_s,
            "predict_s": predict_s, "sweep_s": sweep_s,
            "sweep_walls": walls}


def per_point_sweep(torch, model, bits: int, h, y, scope: str,
                    grid=P_GRID, fault_model=None):
    """The sweep as a loop over its (p, trial) points, each corrupted by
    its own ``corrupted_materialized`` (on the iid route one one-point
    ``flip_corrupt`` launch per stored int leaf, the parent's sweep), with
    the sweep's seeds; the (p, trial) accuracy matrix as numpy."""
    from repro_torch.api import dispatch
    qmodel = model.quantized(bits)
    n_leaves = len(qmodel.to_dict()) - 1
    _, rows = sweep_points(n_leaves, ps=[0.0])
    y = torch.as_tensor(y, device=h.device)
    accs = torch.empty((len(grid), N_TRIALS), device=h.device)
    for i, p in enumerate(grid):
        for t in range(N_TRIALS):
            noisy = qmodel.corrupted_materialized(p, rows[t], scope,
                                                  fault_model=fault_model)
            accs[i, t] = (dispatch.predict_encoded(noisy, h) == y).float(
            ).mean()
    return accs.cpu().numpy()


def check_sweep_forms(torch, model, h, y, bits: int, scope: str,
                      accs) -> dict:
    """The sweep `accs` (one chunk) against the per-point loop and against
    ``p_chunk=4`` (two chunks, the second padded: two launches): the same
    accuracy matrix bit for bit.  Returns the walls in seconds of the
    per-point loop and the one-chunk sweep, timed in the order loop,
    sweep, sweep, loop."""
    import numpy as np
    from repro_torch.api import dispatch
    from repro_torch.kernels import common

    def sweep(**kw):
        return model.sweep_under_flips(
            bits, P_GRID, h, y, n_trials=N_TRIALS, scope=scope,
            predict_encoded=dispatch.predict_encoded,
            generator=torch.Generator().manual_seed(0), **kw)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    before = common.launches["flip_corrupt"]
    chunked = sweep(p_chunk=4)
    n_chunked = common.launches["flip_corrupt"] - before
    loop, t_loop1 = wall(lambda: per_point_sweep(torch, model, bits, h, y,
                                                 scope))
    _, t_new1 = wall(sweep)
    _, t_new2 = wall(sweep)
    _, t_loop2 = wall(lambda: per_point_sweep(torch, model, bits, h, y,
                                              scope))
    check(np.array_equal(loop, accs) and np.array_equal(chunked, accs),
          f"bits={bits} scope={scope}: the sweep differs from the per-point "
          f"loop or from p_chunk=4")
    check(n_chunked == 2, f"p_chunk=4 launched flip_corrupt {n_chunked} "
          f"times, not twice")
    busy, count, _ = profile_calls(torch, sweep, calls=2)
    idle = 1.0 - busy / 1e3 / min(t_new1, t_new2)
    log(f"sweep bits={bits} scope={scope}: equal to the per-point loop and "
        f"to p_chunk=4 (2 launches); wall, one chunk {t_new1:.4f} / "
        f"{t_new2:.4f} s, per-point loop (the parent's sweep) {t_loop1:.4f} "
        f"/ {t_loop2:.4f} s; a sweep's device work {busy:.4f} ms in "
        f"{count:.0f} kernels and copies, idle {idle:.4f} of the faster wall")
    return {"chunk_s": [t_new1, t_new2], "per_point_s": [t_loop1, t_loop2],
            "device_ms": busy, "device_events": count, "idle": idle}


class MatmulWatch:
    """A torch function mode that records, at every matmul-like call, whether
    float32 matmuls then run in full float32 (``precision.in_full_f32``)."""

    def __init__(self, torch):
        from repro_torch.precision import in_full_f32
        funcs = (torch.matmul, torch.Tensor.matmul, torch.einsum, torch.mm,
                 torch.addmm, torch.linalg.inv)
        seen = self.seen = []

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func in funcs:
                    seen.append(in_full_f32())
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def budget_families(spec, budget: float = 0.4) -> dict:
    """The matched-memory settings of ``benchmarks/common.py`` at `budget`:
    family -> (make_classifier keywords, bundle_update launches of its
    fit)."""
    from repro_torch.core.codebook import min_bundles
    c, k = spec.n_classes, 2
    n_min = min_bundles(c, k)
    n_loghd = max(n_min, int(budget * c))
    n_hybrid = max(n_min, int(2 * budget * c))
    steps64 = -(-spec.n_train // 64)
    return {
        "loghd": (dict(k=k, extra_bundles=n_loghd - n_min, refine_epochs=50,
                       refine_batch=64, codebook_method="distance"),
                  50 * steps64),
        "sparsehd": (dict(sparsity=1.0 - budget, retrain_epochs=30),
                     30 * steps64),
        "hybrid": (dict(sparsity=float(min(max(
                            1.0 - budget * c / n_hybrid, 0.0), 0.95)),
                        k=k, extra_bundles=n_hybrid - n_min,
                        refine_epochs=50, refine_batch=64,
                        codebook_method="distance"),
                   50 * steps64),
        "conventional": (dict(refine_epochs=10),
                         10 * -(-spec.n_train // 256)),
    }


def phase_matched_memory(torch, dev) -> dict:
    """The four families at budget 0.4 on one shared encoder / encodings /
    prototypes set: fit -> predict -> 1-bit sweep (scope "hv") each, with
    launch counting, then the checks."""
    from repro_torch.api import dispatch, fit_engine, make_classifier
    from repro_torch.core.bundling import build_bundles
    from repro_torch.core.profiles import estimate_profiles
    from repro_torch.data.synth import load_dataset
    from repro_torch.hdc.conventional import class_prototypes
    from repro_torch.hdc.encoders import (EncoderConfig, encode_batched,
                                          fit_encoder)
    from repro_torch.kernels import common

    x_tr, y_tr, x_te, y_te, spec = load_dataset("isolet")
    enc_cfg = EncoderConfig(spec.n_features, 10_000, "cos")
    torch.cuda.synchronize()
    common.reset_launches()
    enc, h_tr = fit_encoder(enc_cfg, x_tr, device=dev)
    h_te = encode_batched(enc, x_te, "cos")
    torch.cuda.synchronize()
    enc_launches = dict(common.launches)
    want_enc = -(-len(x_tr) // 4096) + 1
    check(enc_launches.get("hdc_encode", 0) == want_enc,
          f"shared encoder: hdc_encode launched "
          f"{enc_launches.get('hdc_encode', 0)} times, not {want_enc}")
    y_tr_dev = torch.as_tensor(y_tr, device=dev).long()
    y_dev = torch.as_tensor(y_te, device=dev)
    protos = class_prototypes(h_tr, y_tr_dev, spec.n_classes)
    shared = dict(enc=enc, encoded=h_tr, prototypes=protos)
    families = budget_families(spec)

    out = {}
    step = fit_engine.fused_bundle_update
    for name, (kw, want_steps) in families.items():
        clf = make_classifier(name, spec.n_classes, enc_cfg=enc_cfg, **kw)
        # the (n, B, D) of every minibatch step of the fit, read off the
        # fit engine's step (the kernel's launches are counted as ever)
        shapes = collections.Counter()

        def record(m, coeff, h, lr, use_kernel=None):
            shapes[(m.shape[0], h.shape[0], m.shape[1])] += 1
            return step(m, coeff, h, lr, use_kernel=use_kernel)
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        fit_engine.fused_bundle_update = record
        try:
            clf = clf.fit(x_tr, y_tr, **shared)
        finally:
            fit_engine.fused_bundle_update = step
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels = clf.predict_encoded(h_te)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        accs = clf.sweep_under_flips(
            1, P_GRID, h_te, y_te, n_trials=N_TRIALS, scope="hv",
            predict_encoded=dispatch.predict_encoded,
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = dict(common.launches)
        out[name] = dict(clf=clf, labels=labels, accs=accs, fit_s=fit_s,
                         predict_s=predict_s, sweep_s=sweep_s,
                         launches=launches,
                         want_steps=want_steps, update_shapes=shapes)
        log(f"{name:<12} fit {fit_s:.3f} s, predict {predict_s:.4f} s, "
            f"1-bit sweep {sweep_s:.3f} s; launches {launches}; minibatch "
            f"(n, B, D): {dict(shapes)}")

    # checks, after every count was read
    for name, r in out.items():
        model = r["clf"].model
        got = r["launches"].get("bundle_update", 0)
        check(got == r["want_steps"], f"{name}: bundle_update launched {got} "
              f"times, not {r['want_steps']}")
        check(sum(r["update_shapes"].values()) == got,
              f"{name}: {sum(r['update_shapes'].values())} minibatch steps "
              f"recorded, {got} launches")
        check(r["launches"].get("bundle_sim", 0) > 0,
              f"{name}: bundle_sim never launched")
        if name in ("loghd", "hybrid"):
            check(r["launches"].get("profile_decode", 0) > 0,
                  f"{name}: profile_decode never launched")
        # one p-chunk (the whole grid by default), one launch
        check(r["launches"].get("flip_corrupt", 0) == 1,
              f"{name}: flip_corrupt launched "
              f"{r['launches'].get('flip_corrupt', 0)} times, not once")
        acc = float((r["labels"] == y_dev).float().mean())
        plain = dispatch.predict_encoded(model, h_te, use_kernels=False)
        agree = float((plain == r["labels"]).float().mean())
        n_diff = int((plain != r["labels"]).sum())
        qacc = float((dispatch.predict_encoded(model.quantized(1), h_te)
                      == y_dev).float().mean())
        r.update(acc=acc, agree=agree, qacc=qacc)
        log(f"{name:<12} accuracy {acc:.4f} (1-bit quantized {qacc:.4f}); "
            f"kernel vs plain labels agree on {agree:.5f} ({n_diff} of "
            f"{len(plain)} rows differ); memory "
            f"{model.model_bits(1)} bits at 1 bit; 1-bit sweep (rows p, "
            f"columns trials, scope hv):")
        for p, row in zip(P_GRID, r["accs"]):
            log(f"  p={p:<5} " + " ".join(f"{a:.4f}" for a in row))
        check(acc > 0.5, f"{name}: clean accuracy {acc} is below 0.5")
        check(agree >= 0.999, f"{name}: kernel and plain labels agree on "
              f"only {agree}")
        check(r["accs"].shape == (len(P_GRID), N_TRIALS), "sweep shape")
        check(all(a == qacc for a in r["accs"][0]),
              f"{name}: p=0 row {r['accs'][0]} != clean quantized {qacc}")
        r["sweep_walls"] = check_sweep_forms(torch, model, h_te, y_te, 1,
                                             "hv", r["accs"])

    # the LogHD fit again, with TF32 on for the process: the fit must still
    # run every matmul in full float32 and repeat the first fit bit for bit
    loghd = out["loghd"]["clf"]
    watch = MatmulWatch(torch)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with watch.mode:
            again = make_classifier("loghd", spec.n_classes, enc_cfg=enc_cfg,
                                    **families["loghd"][0]).fit(
                x_tr, y_tr, **shared).model
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    check(len(watch.seen) > 0 and all(watch.seen),
          f"{watch.seen.count(False)} of {len(watch.seen)} matmuls of the "
          f"fit ran with TF32 allowed")
    for leaf in ("bundles", "profiles"):
        check(torch.equal(getattr(loghd.model, leaf), getattr(again, leaf)),
              f"second LogHD fit differs in {leaf}")
    log(f"second LogHD fit (TF32 on globally): bundles and profiles bitwise "
        f"equal; all {len(watch.seen)} matmuls of the fit in full float32")

    # Eq. 9 refinement through the kernel against the plain steps, on the
    # card: allclose after 2 epochs, labels after all 50
    cfg = loghd.cfg
    b0 = build_bundles(protos, loghd.model.codebook, cfg.k)
    kw = dict(lr=cfg.lr, batch_size=cfg.refine_batch, seed=cfg.seed)
    short = {uk: fit_engine.fused_refine_bundles(
        b0, h_tr, y_tr_dev, loghd.model.codebook, cfg.k, epochs=2,
        use_kernel=uk, **kw) for uk in (True, False)}
    torch.cuda.synchronize()
    err2 = max_err(short[True], short[False])
    torch.testing.assert_close(short[True], short[False], rtol=1e-5,
                               atol=1e-6)
    plain50 = fit_engine.fused_refine_bundles(
        b0, h_tr, y_tr_dev, loghd.model.codebook, cfg.k,
        epochs=cfg.refine_epochs, use_kernel=False, **kw)
    plain_model = loghd.model.replace(
        bundles=plain50,
        profiles=estimate_profiles(plain50, h_tr, y_tr_dev, spec.n_classes))
    labels50 = dispatch.predict_encoded(plain_model, h_te)
    agree50 = float((labels50 == out["loghd"]["labels"]).float().mean())
    diff50 = int((labels50 != out["loghd"]["labels"]).sum())
    err50 = max_err(loghd.model.bundles, plain50)
    log(f"LogHD refinement, kernel vs plain steps: max abs diff "
        f"{err2:.3e} after 2 epochs, {err50:.3e} after "
        f"{cfg.refine_epochs}; labels agree on {agree50:.5f} ({diff50} of "
        f"{len(labels50)} rows differ)")
    check(agree50 >= 0.999, f"refinement kernel vs plain labels agree on "
          f"only {agree50}")
    return dict(families=out, h_tr=h_tr, y_tr=y_tr_dev, h_te=h_te,
                y_te=y_te, enc_launches=enc_launches)


class RecordDraw:
    """A draw that records every mask and gate its inner draw gives."""

    def __init__(self, inner):
        self.inner, self.drawn = inner, []

    def mask(self, p, shape, nbits):
        self.drawn.append(self.inner.mask(p, shape, nbits))
        return self.drawn[-1]

    def bernoulli(self, p, shape):
        self.drawn.append(self.inner.bernoulli(p, shape))
        return self.drawn[-1]


class ReplayDraw:
    """A draw that gives back recorded draws in their order."""

    def __init__(self, drawn):
        self.drawn = list(drawn)

    def mask(self, p, shape, nbits):
        return self.drawn.pop(0)

    def bernoulli(self, p, shape):
        return self.drawn.pop(0)


def check_word_algebra(torch, dev) -> dict:
    """Each non-iid model on a (128, 512) 4-bit QTensor and a float32 leaf
    on the card, with the masks of a CPU generator injected, against the
    same call on the CPU: the elements that differ (0 required)."""
    from repro_torch.core.faults import GeneratorDraw
    from repro_torch.core.quantize import QTensor
    from repro_torch.faults import available_fault_models, make_fault_model
    g = torch.Generator().manual_seed(17)
    codes = torch.randint(-8, 8, (128, 512), generator=g).to(torch.int8)
    q_cpu = QTensor(codes, torch.tensor(0.25), ZOO_BITS)
    q_dev = QTensor(codes.to(dev), q_cpu.scale.to(dev), ZOO_BITS)
    w_cpu = torch.randn((128, 512), generator=g)
    diffs = {}
    for name in available_fault_models():
        if name == "iid":
            continue
        fm = make_fault_model(name)
        sev = ZOO_GRIDS[name][4]
        rec = RecordDraw(GeneratorDraw.seeded(5, "cpu"))
        want_q = fm.corrupt_qtensor(q_cpu, sev, rec)
        want_w = fm.corrupt_f32(w_cpu, sev, rec)
        replay = ReplayDraw(rec.drawn)
        got_q = fm.corrupt_qtensor(q_dev, sev, replay)
        got_w = fm.corrupt_f32(w_cpu.to(dev), sev, replay)
        check(got_q.codes.device.type == dev.type,
              f"{name}: the corruption left the card")
        diffs[name] = (
            int((got_q.codes.cpu() != want_q.codes).sum())
            + int((got_w.cpu().view(torch.int32)
                   != want_w.view(torch.int32)).sum()))
        changed = int((want_q.codes != codes).sum())
        log(f"word algebra {name:<10} at severity {sev}: {changed} of "
            f"{codes.numel()} codes changed; card vs CPU under the same "
            f"draws: {diffs[name]} elements differ")
        check(diffs[name] == 0, f"{name}: the card's word algebra differs "
              f"from the CPU's in {diffs[name]} elements")
    return diffs


def check_card_rates(torch, dev) -> dict:
    """Each model's marginal rates on the card's own generator against the
    closed forms, with the chi-squared bounds of
    tests/test_fault_models.py."""
    from repro_torch.core.quantize import quantize
    from repro_torch.faults import (AsymmetricFlip, BurstFlip, DriftFlip,
                                    IIDFlip, StuckAt)
    g = torch.Generator(device=dev).manual_seed(9)

    def codes(shape):
        return quantize(torch.randn(shape, generator=g, device=dev), 4)

    def words(q):
        return q.codes.to(torch.int64) & 0xF

    def plane(x, b):
        return (x >> b) & 1

    def chi2(k, n, p):
        return (k - n * p) ** 2 / (n * p * (1 - p) + 1e-12)

    stats = {}
    q = codes((128, 512))
    u0 = words(q)
    n = u0.numel()
    # iid
    x = u0 ^ words(IIDFlip().corrupt_qtensor(q, 0.25, 6))
    stats["iid_chi2"] = sum(chi2(int(plane(x, b).sum()), n, 0.25)
                            for b in range(4))
    # asymmetric: 0->1 and 1->0 separately
    fm = AsymmetricFlip(p01_scale=0.25, p10_scale=1.0)
    u1 = words(fm.corrupt_qtensor(q, 0.2, 3))
    c01 = c10 = 0.0
    for b in range(4):
        s, r = plane(u0, b), plane(u1, b)
        c01 += chi2(int(((s == 0) & (r == 1)).sum()), int((s == 0).sum()),
                    0.05)
        c10 += chi2(int(((s == 1) & (r == 0)).sum()), int((s == 1).sum()),
                    0.2)
    stats.update(asym01_chi2=c01, asym10_chi2=c10)
    # burst: marginal per plane, hit rows, within-row damage, overdispersion
    fm, sev, row = BurstFlip(row_size=128, burst_rate=0.5), 0.3, 128
    qb = codes((256, 512))
    xb = (words(qb) ^ words(fm.corrupt_qtensor(qb, sev, 8))).reshape(-1)
    stats["burst_plane_dev"] = max(
        abs(int(plane(xb, b).sum()) / xb.numel() - sev * 0.5)
        for b in range(4))
    per_row = sum(plane(xb, b) for b in range(4)).reshape(-1, row).sum(1)
    hit = per_row > 0
    nrows = per_row.numel()
    stats["burst_hit_z"] = abs(float(hit.float().mean()) - sev) / (
        (sev * (1 - sev) / nrows) ** 0.5)
    stats["burst_row_damage"] = float(per_row[hit].float().mean()) / (
        0.5 * row * 4)
    iid_var = row * 4 * 0.15 * 0.85
    stats["burst_overdispersion"] = float(per_row.float().var()) / iid_var
    # stuck-at: rate, persistence and idempotence under one seed
    fm, sev = StuckAt(stuck0_frac=0.5), 0.2
    fq = fm.corrupt_qtensor(q, sev, 13)
    u1 = words(fq)
    p0, p1 = sev * 0.5, sev * 0.5 * (1 - sev * 0.5)
    c = 0.0
    for b in range(4):
        s = plane(u0, b)
        n1, n0 = int(s.sum()), int((1 - s).sum())
        expect, var = n1 * p0 + n0 * p1, (n1 * p0 * (1 - p0)
                                          + n0 * p1 * (1 - p1))
        c += (int(plane(u0 ^ u1, b).sum()) - expect) ** 2 / (var + 1e-12)
    stats["stuck_chi2"] = c
    stats["stuck_persistent"] = torch.equal(
        fm.corrupt_qtensor(q, sev, 13).codes, fq.codes)
    stats["stuck_idempotent"] = torch.equal(
        fm.corrupt_qtensor(fq, sev, 13).codes, fq.codes)
    # drift: identity at 0 reads, the rate at 200 reads against p_eff
    fm = DriftFlip(per_read_p=0.002)
    stats["drift_identity"] = torch.equal(
        fm.corrupt_qtensor(q, 0.0, 21).codes, q.codes)
    p = fm.p_eff(200.0)
    x = u0 ^ words(fm.corrupt_qtensor(q, 200.0, 21))
    stats["drift_chi2"] = sum(chi2(int(plane(x, b).sum()), n, p)
                              for b in range(4))
    stats["drift_p_eff_200"] = p
    log("fault rates on the card's generator: " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stats.items()))
    for k in ("iid_chi2", "asym01_chi2", "asym10_chi2", "stuck_chi2",
              "drift_chi2"):
        check(stats[k] < CHI2_DF4, f"{k} = {stats[k]} >= {CHI2_DF4}")
    check(stats["burst_plane_dev"] < 0.03, "burst: a plane's rate is off "
          f"the marginal by {stats['burst_plane_dev']}")
    check(stats["burst_hit_z"] < 4, f"burst: hit rows {stats['burst_hit_z']}"
          f" sigma off the severity")
    check(stats["burst_row_damage"] > 0.8, "burst: hit rows carry "
          f"{stats['burst_row_damage']} of burst_rate's damage")
    check(stats["burst_overdispersion"] > 10, "burst: per-row damage "
          f"variance only {stats['burst_overdispersion']} x the iid one")
    for k in ("stuck_persistent", "stuck_idempotent", "drift_identity"):
        check(stats[k], f"{k} is false")
    return stats


def phase_fault_zoo(torch, dev, mm: dict) -> dict:
    """The fault-model zoo on the matched-memory phase's LogHD and
    conventional models, then the ID-level encoder: "iid" against the
    default sweep (one flip_corrupt launch each), a 4-bit "hv" sweep per
    registered model and family over its severity grid, the ID-level
    encoding of the isolet surrogate, a LogHD fit on it and its iid sweep;
    launch counting over all of it; then the checks (each sweep against its
    per-point loop, the word algebra under injected draws, the rates on the
    card's generator, the encodings against the CPU)."""
    import numpy as np
    from repro_torch.api import dispatch, make_classifier
    from repro_torch.data.synth import load_dataset
    from repro_torch.faults import available_fault_models
    from repro_torch.hdc.encoders import EncoderConfig
    from repro_torch.hdc.id_level import (IDLevelConfig, encode_id_level,
                                          id_level_sums, init_id_level)
    from repro_torch.kernels import common

    models = {name: mm["families"][name]["clf"].model
              for name in ("loghd", "conventional")}
    h_te, y_te = mm["h_te"], mm["y_te"]
    y_dev = torch.as_tensor(y_te, device=dev)
    x_tr, y_tr, x_te, _, spec = load_dataset("isolet")
    loghd_kw = budget_families(spec)["loghd"][0]

    def sweep(model, h, bits, grid, scope, fault_model):
        torch.cuda.synchronize()
        before = common.launches["flip_corrupt"]
        t0 = time.perf_counter()
        accs = model.sweep_under_flips(
            bits, grid, h, y_te, n_trials=N_TRIALS, scope=scope,
            predict_encoded=dispatch.predict_encoded,
            generator=torch.Generator().manual_seed(0),
            fault_model=fault_model)
        torch.cuda.synchronize()
        return dict(accs=accs, wall_s=time.perf_counter() - t0,
                    flips=common.launches["flip_corrupt"] - before)

    torch.cuda.synchronize()
    common.reset_launches()
    t_phase = time.perf_counter()
    iid_check = {fm: sweep(models["loghd"], h_te, ZOO_BITS, P_GRID, "all",
                           fm) for fm in (None, "iid")}
    zoo = {(fname, fam): sweep(model, h_te, ZOO_BITS, ZOO_GRIDS[fname],
                               "hv", fname)
           for fname in available_fault_models()
           for fam, model in models.items()}
    cfg = IDLevelConfig(spec.n_features, 10_000, levels=16)
    t0 = time.perf_counter()
    params = init_id_level(cfg, device=dev)
    hid_tr = encode_id_level(params, x_tr, cfg)
    hid_te = encode_id_level(params, x_te, cfg)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf = make_classifier("loghd", spec.n_classes,
                          enc_cfg=EncoderConfig(spec.n_features, 10_000),
                          **loghd_kw).fit(x_tr, y_tr, enc=params,
                                          encoded=hid_tr)
    id_labels = clf.predict_encoded(hid_te)
    torch.cuda.synchronize()
    id_fit_s = time.perf_counter() - t0
    id_sweep = sweep(clf.model, hid_te, ZOO_BITS, P_GRID, "all", "iid")
    phase_s = time.perf_counter() - t_phase
    launches = dict(common.launches)
    log(f"fault zoo path: {phase_s:.3f} s; launches {launches}")

    # checks, after the counts were read
    want_flips = 2 + len(models) + 1
    check(launches.get("flip_corrupt", 0) == want_flips,
          f"fault zoo: flip_corrupt launched "
          f"{launches.get('flip_corrupt', 0)} times, not {want_flips}")
    for name in ("bundle_sim", "profile_decode", "bundle_update"):
        check(launches.get(name, 0) > 0, f"fault zoo: {name} never launched")
    a, b = iid_check[None], iid_check["iid"]
    check(np.array_equal(a["accs"], b["accs"]),
          f"fault_model='iid' differs from the default sweep: "
          f"{a['accs'].tolist()} against {b['accs'].tolist()}")
    check(a["flips"] == 1 and b["flips"] == 1,
          f"flip_corrupt launches: default {a['flips']}, iid {b['flips']}, "
          f"not 1 each")
    log(f"iid against the default sweep (LogHD, {ZOO_BITS}-bit, scope all, "
        f"{len(P_GRID)} p x {N_TRIALS} trials): bitwise equal, 1 launch each;"
        f" walls {a['wall_s']:.4f} / {b['wall_s']:.4f} s")

    clean = {fam: float((dispatch.predict_encoded(
        m.quantized(ZOO_BITS), h_te) == y_dev).float().mean())
        for fam, m in models.items()}
    per_model = {}
    for (fname, fam), r in zoo.items():
        model, grid = models[fam], ZOO_GRIDS[fname]
        accs = r["accs"]
        check(accs.shape == (len(grid), N_TRIALS),
              f"{fname} {fam}: sweep shape {accs.shape}")
        check(all(v == clean[fam] for v in accs[0]),
              f"{fname} {fam}: severity-0 row {accs[0]} != clean quantized "
              f"{clean[fam]}")
        want = 1 if fname == "iid" else 0
        check(r["flips"] == want, f"{fname} {fam}: flip_corrupt launched "
              f"{r['flips']} times, not {want}")
        loop = per_point_sweep(torch, model, ZOO_BITS, h_te, y_te, "hv",
                               grid=grid, fault_model=fname)
        check(np.array_equal(loop, accs), f"{fname} {fam}: the sweep "
              f"differs from its per-point loop")
        again = sweep(model, h_te, ZOO_BITS, grid, "hv", fname)
        busy, count, _ = profile_calls(
            torch, lambda: sweep(model, h_te, ZOO_BITS, grid, "hv", fname),
            calls=1)
        wall = min(r["wall_s"], again["wall_s"])
        r.update(again_s=again["wall_s"], device_ms=busy, events=count,
                 idle=1.0 - busy / 1e3 / wall)
        per_model.setdefault(fname, {})[fam] = r
    for fname, fams in per_model.items():
        log(f"{fname} ({ZOO_BITS}-bit, scope hv, mean of {N_TRIALS} trials;"
            f" equal to its per-point loop): severity | loghd | "
            f"conventional")
        for i, s in enumerate(ZOO_GRIDS[fname]):
            log(f"  {s:<7} {fams['loghd']['accs'][i].mean():.4f}  "
                f"{fams['conventional']['accs'][i].mean():.4f}")
        for fam, r in fams.items():
            log(f"  {fam}: wall {r['wall_s']:.4f} / {r['again_s']:.4f} s, "
                f"device {r['device_ms']:.3f} ms in {r['events']:.0f} "
                f"kernels and copies, idle {r['idle']:.4f}")

    diffs = check_word_algebra(torch, dev)
    rates = check_card_rates(torch, dev)

    # the ID-level encoding against the CPU on the first ID_ROWS test rows
    cpu_params = {k: v.cpu() for k, v in params.items()}
    rows = x_te[:ID_ROWS]
    sums_dev = id_level_sums(params, rows, cfg).cpu()
    sums_cpu = id_level_sums(cpu_params, rows, cfg)
    n_sum_diff = int((sums_dev != sums_cpu).sum())
    enc_err = max_err(hid_te[:ID_ROWS].cpu(),
                      encode_id_level(cpu_params, rows, cfg))
    id_acc = float((id_labels == y_dev).float().mean())
    log(f"ID-level encoder (F={spec.n_features}, D={cfg.dim}, levels "
        f"{cfg.levels}): {len(x_tr) + len(x_te)} rows encoded in "
        f"{encode_s:.4f} s (params drawn on the card included); sums vs the "
        f"CPU over {ID_ROWS} rows: {n_sum_diff} differ; normalised rows max "
        f"abs diff {enc_err:.3e}; LogHD fit {id_fit_s:.3f} s, accuracy "
        f"{id_acc:.4f}; iid sweep ({ZOO_BITS}-bit, scope all, mean of "
        f"trials): " + ", ".join(
            f"p={p} {v:.4f}" for p, v in zip(P_GRID,
                                              id_sweep["accs"].mean(1))))
    check(n_sum_diff == 0, f"ID-level sums differ from the CPU's in "
          f"{n_sum_diff} elements")
    check(enc_err <= 1e-6, f"ID-level rows differ from the CPU's by "
          f"{enc_err}")
    check(id_acc > 0.5, f"ID-level LogHD accuracy {id_acc} is below 0.5")
    check(id_sweep["flips"] == 1, f"ID-level sweep launched flip_corrupt "
          f"{id_sweep['flips']} times, not once")
    return {"launches": launches, "phase_s": phase_s, "curves": {
                f"{fname}_{fam}": r["accs"].mean(1).tolist()
                for fname, fams in per_model.items()
                for fam, r in fams.items()},
            "word_diffs": diffs, "rates": rates, "encode_s": encode_s,
            "id_acc": id_acc}


# the reference extreme bench's shapes (benchmarks/extreme_bench.py):
# (C, training rows), F, D, predict batch; then the full width
EXTREME_CASES = ((1 << 16, 2048), (1 << 20, 4096))
EXTREME_F, EXTREME_D, EXTREME_B, EXTREME_S = 32, 256, 64, 8
FULL_C, FULL_F, FULL_D, FULL_N = 1 << 20, 617, 10_000, 4096
FULL_QUERIES = 512              # rows of the label check at S = 1, 2, 8
PEAK_LIMIT = 4e9                # bytes allocated at most over fit + predict
RESIDENT_RATIO = 1.2


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_fit(torch, dev, c: int, f: int, d: int, x, y):
    """A class-sharded LogHD fit through the front door, timed."""
    from repro_torch.api import make_classifier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = make_classifier("loghd", c, f, dim=d, refine_epochs=1,
                          class_sharding=EXTREME_S, device=dev).fit(x, y)
    torch.cuda.synchronize()
    return clf, time.perf_counter() - t0


def phase_extreme(torch, dev, smi: str) -> dict:
    """The class-sharded estimator at extreme C, over an NCCL group of one
    rank (the collectives run on the card): the reference bench's shapes
    (C = 2^16 and 2^20 at D = 256, S = 8: fit, predict, residency), the
    full width (C = 2^20, F = 617, D = 10,000, n = 20: fit stage walls,
    peak memory, labels at S = 1, 2, 8 against the gathered plain route),
    the data-parallel fits at Dp = 2 in the one rank, checkpoints written
    synchronously and by AsyncCheckpointer, and a 1-bit sweep of the
    C = 2^16 model; launch counting over the fits, predicts and the
    sweep.  The group is destroyed at the end, whatever happened."""
    import datetime
    import os

    import torch.distributed as dist
    from repro_torch.api import sharded

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        return extreme_run(torch, dev, smi, t_phase)
    finally:
        dist.destroy_process_group()
        sharded.clear_sharded_cache()


def extreme_run(torch, dev, smi: str, t_phase: float) -> dict:
    import numpy as np
    import torch.distributed as dist
    from repro_torch.api import dispatch, shard_loghd_model
    from repro_torch.kernels import common
    from repro_torch.launch import mesh as dmesh

    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"process group: {dist.get_backend()} of "
          f"{dist.get_world_size()} ranks")
    bench = {}
    rng = np.random.default_rng(0)
    data = {}
    for c, n in EXTREME_CASES:
        data[c] = (rng.normal(size=(n, EXTREME_F)).astype(np.float32),
                   rng.integers(0, c, size=n),
                   torch.as_tensor(rng.normal(size=(EXTREME_B, EXTREME_D))
                                   .astype(np.float32), device=dev))
    rng = np.random.default_rng(1)
    x_full = rng.normal(size=(FULL_N, FULL_F)).astype(np.float32)
    y_full = rng.integers(0, FULL_C, size=FULL_N)
    xq_full = rng.normal(size=(FULL_QUERIES, FULL_F)).astype(np.float32)

    # ---- the main path: fits, predicts and a sweep, launches counted ----
    torch.cuda.synchronize()
    common.reset_launches()
    dmesh.collectives.clear()
    for c, n in EXTREME_CASES:
        x, y, xq = data[c]
        clf, fit_s = sharded_fit(torch, dev, c, EXTREME_F, EXTREME_D, x, y)
        labels = clf.predict_encoded(xq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            labels = clf.predict_encoded(xq)
        torch.cuda.synchronize()
        predict_s = (time.perf_counter() - t0) / 5
        bench[c] = dict(clf=clf, fit_s=fit_s, predict_s=predict_s,
                        labels=labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    full, full_fit_s = sharded_fit(torch, dev, FULL_C, FULL_F, FULL_D,
                                   x_full, y_full)
    t0 = time.perf_counter()
    hq = full.encode(xq_full[:EXTREME_B])
    full_labels = full.predict_encoded(hq)
    torch.cuda.synchronize()
    full_predict_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_bytes
    small = bench[EXTREME_CASES[0][0]]
    xq_small = data[EXTREME_CASES[0][0]][2]
    # the sweep scores agreement with the clean 1-bit model's labels
    sweep_y = dispatch.predict_encoded(small["clf"].model.quantized(1),
                                       xq_small).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = small["clf"].sweep_under_flips(
        1, P_GRID, xq_small, sweep_y, n_trials=N_TRIALS,
        predict_encoded=dispatch.predict_encoded,
        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = dict(common.launches)
    coll = dict(dmesh.collectives)
    log(f"extreme path launches: {launches}; collectives {coll}")

    # ---- checks and measurements, after the counts were read ----
    check(launches.get("hdc_encode", 0) > 0, "extreme: hdc_encode never "
          "launched")
    check(launches.get("bundle_update", 0) > 0, "extreme: bundle_update "
          "never launched")
    check(launches.get("flip_corrupt", 0) == 1, f"extreme: flip_corrupt "
          f"launched {launches.get('flip_corrupt', 0)} times, not once")
    for name in ("bundle_sim", "profile_decode"):
        check(launches.get(name, 0) == 0, f"extreme: {name} launched "
              f"{launches.get(name)} times; the sharded class decodes in "
              f"torch")
    check(coll.get("all_gather", 0) > 0, "extreme: no all_gather was made")
    for c, r in bench.items():
        m = r["clf"].model
        info = m.resident_bytes_per_device()
        conv = c * EXTREME_D * 4
        g = m.gathered()
        plain = dispatch.predict_encoded(g, data[c][2], use_kernels=False)
        n_diff = int((plain != r["labels"]).sum())
        log(f"extreme C=2^{c.bit_length() - 1} ({smi}): n={m.n_bundles}, "
            f"S={m.class_sharding}, fit {r['fit_s']:.4f} s, predict "
            f"{r['predict_s'] * 1e3:.3f} ms a batch of {EXTREME_B} "
            f"({EXTREME_B / r['predict_s']:.1f} queries/s); a shard's "
            f"rows {info['max_bytes_per_device']} B (this rank's "
            f"{info['bytes_this_rank']} B over its {EXTREME_S} blocks: on "
            f"one rank the layout fixes it), ideal "
            f"{info['ideal_bytes_per_device']:.0f}, ratio "
            f"{info['ratio_to_ideal']:.4f}; stored {m.stored_bytes()} B = "
            f"{m.stored_bytes() / conv:.6f} of a float32 C x D model; "
            f"{n_diff} of {EXTREME_B} labels differ from the gathered "
            f"plain route")
        check(info["ratio_to_ideal"] <= RESIDENT_RATIO, f"C={c}: resident "
              f"ratio {info['ratio_to_ideal']} above {RESIDENT_RATIO}")
        check(n_diff == 0, f"C={c}: {n_diff} labels differ from gathered")
    check(sweep.shape == (len(P_GRID), N_TRIALS), "extreme sweep shape")
    check(all(a == 1.0 for a in sweep[0]), f"extreme sweep p=0 row "
          f"{sweep[0]}: the clean 1-bit model disagrees with itself")
    flips = check_extreme_flips(torch, small["clf"].model, xq_small, sweep_y,
                                sweep)
    log(f"extreme sweep (C=2^{EXTREME_CASES[0][0].bit_length() - 1}, "
        f"1-bit, {len(P_GRID)} p x {N_TRIALS} trials, agreement with the clean 1-bit labels): " + ", ".join(
            f"p={p} {v:.4f}" for p, v in zip(P_GRID, sweep.mean(1)))
        + f"; wall {sweep_s:.4f} s, flip_corrupt launches "
        f"{launches.get('flip_corrupt', 0)}; the launch again on its leaves "
        f"{flips['shapes']}: {flips['n_diff']} elements differ from "
        f"flip_corrupt_grid_ref, {flips['flipped']} codes flipped at "
        f"p={P_GRID[-1]}; equal to the per-point loop ({smi})")

    # the full width: stage walls of the same fit, peak memory, labels
    m = full.model
    check(m.n_classes == FULL_C and m.class_sharding == EXTREME_S,
          "full-width layout")
    stages = full_stage_walls(torch, dev, full, x_full, y_full)
    log(f"extreme full width (C=2^{FULL_C.bit_length() - 1}, F={FULL_F}, "
        f"D={FULL_D}, "
        f"N={FULL_N}, S={EXTREME_S}, n={m.n_bundles}; {smi}): fit "
        f"{full_fit_s:.3f} s; stages " + ", ".join(
            f"{k} {v:.4f} s" for k, v in stages.items())
        + f"; predict {full_predict_s * 1e3:.2f} ms for {EXTREME_B} raw "
        f"rows; peak allocated over fit and predict {peak / 1e9:.3f} GB "
        f"above the {base_bytes / 1e9:.3f} GB held before "
        f"(a float32 C x D array: {FULL_C * FULL_D * 4 / 1e9:.1f} GB)")
    check(peak < PEAK_LIMIT, f"full width: peak {peak} B above "
          f"{PEAK_LIMIT:.0f}")
    hq_all = full.encode(xq_full)
    g = m.gathered()
    plain = dispatch.predict_encoded(g, hq_all, use_kernels=False)
    check(torch.equal(full_labels, plain[:EXTREME_B]),
          "full width: main-path labels differ from the gathered route")
    diffs = {}
    for s_ in (1, 2, EXTREME_S):
        relaid = m if s_ == EXTREME_S else shard_loghd_model(g, s_)
        got = dispatch.predict_encoded(relaid, hq_all)
        diffs[s_] = int((got != plain).sum())
    del plain
    log(f"full width labels against the gathered plain route over "
        f"{FULL_QUERIES} rows: rows differing at S=1, 2, 8: "
        f"{[diffs[s_] for s_ in (1, 2, EXTREME_S)]}")
    for s_, n_diff in diffs.items():
        check(n_diff == 0, f"full width S={s_}: {n_diff} rows differ")

    dp = extreme_dp(torch, dev, full, x_full, y_full, smi)
    ck = extreme_checkpoints(torch, dev, m, hq_all, smi)
    phase_s = time.perf_counter() - t_phase
    log(f"extreme phase, checks included: {phase_s:.2f} s ({smi})")
    return {"launches": launches, "collectives": coll, "peak_bytes": peak,
            "stages": stages, "diffs": diffs, "dp": dp, "ckpt": ck,
            "phase_s": phase_s, "sweep_s": sweep_s}


def check_extreme_flips(torch, model, h, y, accs) -> dict:
    """The extreme sweep's one ``flip_corrupt`` launch made again on the
    same leaves (the 1-bit model's bundles and padded profile codes, as the
    sweep's ``corrupted_materialized_grid`` collects them), points and
    seeds, held bit for bit against ``flip_corrupt_grid_ref``; flips must
    occur at p > 0; and the sweep's accuracy matrix `accs` against the
    per-point loop (one-point launches).  Launches here are not the main
    path's."""
    import numpy as np
    from repro_torch.core.faults import fault_skip_set
    from repro_torch.core.quantize import QTensor
    from repro_torch.kernels.flip_corrupt import (flip_corrupt_grid,
                                                  flip_corrupt_grid_ref)
    q = model.quantized(1)
    d = {k: v for k, v in q.to_dict().items() if k != "enc"}
    skip = fault_skip_set("all")
    picked = [i for i, (k, v) in enumerate(d.items())
              if k not in skip and isinstance(v, QTensor)]
    vals = list(d.values())
    leaves = [(vals[i].codes, vals[i].scale, vals[i].bits) for i in picked]
    ps, rows = sweep_points(len(d))
    seeds = [[row[i] for i in picked] for row in rows]
    got = flip_corrupt_grid(leaves, ps, seeds)
    want = flip_corrupt_grid_ref(leaves, ps, seeds)
    torch.cuda.synchronize()
    n_diff = fc_differing(torch, got, want)
    # the last point is at the largest p, the first at p = 0
    flipped = sum(int((o[-1] != o[0]).sum()) for o in got)
    check(n_diff == 0, f"extreme sweep: flip_corrupt differs from its plain "
          f"version in {n_diff} elements")
    check(flipped > 0, "extreme sweep: no code flipped at the largest p")
    loop = per_point_sweep(torch, model, 1, h, y, "all")
    check(np.array_equal(loop, accs), "extreme sweep differs from the "
          "per-point loop")
    return {"n_diff": n_diff, "flipped": flipped,
            "shapes": [tuple(c.shape) for c, _, _ in leaves]}


def full_stage_walls(torch, dev, clf, x, y) -> dict:
    """The fit's stages, each run again through the functions the fit runs
    and timed: the codebook on the host, the encoding (on the fitted
    encoder's projection), the streaming superposition, one Eq. 9 epoch
    and the profile estimation; the result must be the fit's, bit for
    bit."""
    from repro_torch.api import fit_engine, sharded
    from repro_torch.core import codebook as cb
    from repro_torch.hdc.encoders import fit_encoder
    cfg = clf.cfg
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    book = torch.as_tensor(cb.build_codebook(
        cfg.n_classes, cfg.n_bundles, cfg.k, alpha=cfg.alpha, seed=cfg.seed,
        method=cfg.codebook_method), device=dev)
    torch.cuda.synchronize()
    out["codebook"] = time.perf_counter() - t0
    check(torch.equal(book[:8], clf.model.codebook[:8]), "stage codebook")
    enc = clf.model.enc
    t0 = time.perf_counter()
    _, h = fit_encoder(clf.enc_cfg, x, device=dev, proj=enc["proj"],
                       bias=enc["bias"])
    torch.cuda.synchronize()
    out["encode"] = time.perf_counter() - t0
    yt = torch.as_tensor(y, device=dev)
    t0 = time.perf_counter()
    bundles = sharded.streaming_build_bundles(h, yt, book, cfg.k)
    torch.cuda.synchronize()
    out["streaming build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundles = fit_engine.fused_refine_bundles(
        bundles, h, yt, book, cfg.k, epochs=cfg.refine_epochs, lr=cfg.lr,
        batch_size=cfg.refine_batch, seed=cfg.seed)
    torch.cuda.synchronize()
    out["refine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profiles = sharded.sharded_estimate_profiles(bundles, h, yt,
                                                 cfg.n_classes, EXTREME_S)
    torch.cuda.synchronize()
    out["profiles"] = time.perf_counter() - t0
    check(torch.equal(bundles, clf.model.bundles)
          and torch.equal(profiles, clf.model.profiles),
          "the staged fit differs from the front door's")
    return out


def extreme_dp(torch, dev, full, x, y, smi: str) -> dict:
    """The data-parallel fits at Dp = 2 in the one rank of the group: the
    exact OnlineHD fit against the serial fit on the interleaved batches,
    int8 against exact, the Eq. 9 refinement on the full-width encodings
    (lower target error, repeats bit for bit)."""
    import numpy as np
    from repro_torch.api import fit_engine, sharded
    from repro_torch.core.bundling import symbol_targets
    from repro_torch.hdc.conventional import class_prototypes, l2_normalize
    from repro_torch.launch import mesh as dmesh
    g = torch.Generator(device=dev).manual_seed(3)
    # random rows and labels at D = 256 leave OnlineHD examples to
    # misclassify (at D = 10,000 each row wins its own class's mean and
    # every delta is zero)
    n, d, c, bs, dp = 2048, 256, 26, 64, 2
    h = l2_normalize(torch.randn((n, d), device=dev, generator=g))
    yy = torch.randint(0, c, (n,), device=dev, generator=g)
    protos = class_prototypes(h, yy, c)
    mesh = sharded.class_mesh(1, dp)
    before = dmesh.collectives["all_reduce"]
    t0 = time.perf_counter()
    exact = fit_engine.fused_onlinehd_fit_dp(
        protos, h, yy, lr=3e-3, batch_size=bs, epochs=2, mesh=mesh,
        compress=None)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    reduces = dmesh.collectives["all_reduce"] - before
    int8 = fit_engine.fused_onlinehd_fit_dp(
        protos, h, yy, lr=3e-3, batch_size=bs, epochs=2, mesh=mesh,
        compress="int8")
    local_bs, n_local = bs // dp, n // dp
    order = torch.as_tensor(np.concatenate([
        np.concatenate([np.arange(local_bs) + b * local_bs + s * n_local
                        for s in range(dp)])
        for b in range(n_local // local_bs)]), device=dev)
    serial = fit_engine.fused_onlinehd_fit(
        protos, h[order], yy[order], lr=3e-3, batch_size=bs, epochs=2,
        use_kernel=False)
    err_serial = max_err(exact, serial)
    err_int8 = max_err(int8, exact)
    moved = max_err(exact, protos)
    check(moved > 0 and err_int8 > 0, f"dp fits: the exact fit moved the "
          f"prototypes by {moved}, int8 differs by {err_int8}; both must "
          f"be above 0 for the checks below to test anything")
    check(bool(torch.allclose(exact, serial, rtol=1e-5, atol=1e-6)),
          f"dp exact fit against the serial fit: max abs err {err_serial}")
    check(bool(torch.allclose(int8, exact, rtol=1e-3, atol=1e-3)),
          f"dp int8 fit against the exact one: max abs err {err_int8}")
    check(reduces == 2 * (n_local // local_bs), f"dp fit: {reduces} "
          f"all-reduces, not one a step")

    m = full.model
    hf = full.encode(x)
    yt = torch.as_tensor(y, device=dev)
    book = m.full_rows().codebook[:m.n_classes]
    ty = symbol_targets(book, full.cfg.k).to(dev)[yt]

    def target_err(b):
        return float(torch.mean((hf @ b.T - ty) ** 2))
    # from random bundles, as the reference's test starts: the fitted ones
    # sit near the floor that unit rows allow for random targets
    m0 = l2_normalize(torch.randn(m.bundles.shape, device=dev, generator=g))
    kw = dict(epochs=2, lr=1e-2, batch_size=64, mesh=sharded.class_mesh(
        EXTREME_S, dp))
    t0 = time.perf_counter()
    refined = fit_engine.fused_refine_bundles_dp(m0, hf, yt, book,
                                                 full.cfg.k, **kw)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    again = fit_engine.fused_refine_bundles_dp(m0, hf, yt, book, full.cfg.k,
                                               **kw)
    e0, e1 = target_err(m0), target_err(refined)
    check(e1 < e0, f"dp refinement raised the target error {e0} -> {e1}")
    check(torch.equal(refined, again), "dp refinement does not repeat")
    log(f"dp fits at Dp=2 in one NCCL rank ({smi}): OnlineHD ({n} x {d}, "
        f"C={c}, 2 epochs; prototypes moved {moved:.3e}) exact vs serial "
        f"max abs err {err_serial:.3e}, int8 vs exact {err_int8:.3e}, "
        f"{reduces} all-reduces, {exact_s:.4f} s; "
        f"Eq. 9 at the full width from random bundles (2 epochs, S=8 x Dp=2 "
        f"mesh) target error "
        f"{e0:.6f} -> {e1:.6f} in {refine_s:.4f} s, repeat bitwise equal")
    return {"err_serial": err_serial, "err_int8": err_int8,
            "target_err": (e0, e1), "exact_s": exact_s,
            "refine_s": refine_s}


def extreme_checkpoints(torch, dev, m, hq, smi: str) -> dict:
    """The full-width model written by save_model and by AsyncCheckpointer:
    byte-equal files, equal labels after loading."""
    import filecmp
    import os

    from repro_torch.api import load_model, save_model
    from repro_torch.api.checkpointing import model_tree
    from repro_torch.checkpoint.ckpt import AsyncCheckpointer
    root = ROOT / "build" / "chip_smoke_extreme"
    if root.exists():
        shutil.rmtree(root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_model(str(root / "sync"), 0, m)
    sync_s = time.perf_counter() - t0
    ac = AsyncCheckpointer(str(root / "async"))
    t0 = time.perf_counter()
    ac.save(0, model_tree(m))
    return_s = time.perf_counter() - t0
    ac.wait()
    async_s = time.perf_counter() - t0
    da, db = root / "sync" / "step_000000000", root / "async" / \
        "step_000000000"
    names = sorted(os.listdir(da))
    check(names == sorted(os.listdir(db)), "checkpoint file lists differ")
    for f in names:
        check(filecmp.cmp(da / f, db / f, shallow=False),
              f"checkpoint file {f} differs between the writers")
    want = m.predict_encoded(hq)
    for sub in ("sync", "async"):
        back = load_model(str(root / sub), device=dev)
        check(torch.equal(back.predict_encoded(hq), want),
              f"labels of the {sub} checkpoint differ")
    size = sum((da / f).stat().st_size for f in names)
    log(f"checkpoints of the full-width model ({size / 1e6:.1f} MB, "
        f"{len(names)} files; {smi}): save_model {sync_s:.3f} s; "
        f"AsyncCheckpointer save() returned in {return_s:.3f} s, written in "
        f"{async_s:.3f} s; files byte-equal, loaded labels equal")
    return {"sync_s": sync_s, "async_return_s": return_s,
            "async_s": async_s, "bytes": size}


def served_labels(svc, name: str, rows, encoded: bool = False):
    """Submit every row to `name`, drain, and return the labels as a
    tensor, with the wall seconds and the cycles it took."""
    c0 = svc.queue.cycles
    t0 = time.perf_counter()
    futs = [svc.submit(name, r, encoded=encoded) for r in rows]
    svc.run_until_drained()
    got = [f.result(timeout=120.0) for f in futs]
    return got, time.perf_counter() - t0, svc.queue.cycles - c0


def phase_serving(torch, dev, main: dict, mm: dict) -> dict:
    """Checkpoint -> load -> ClassifierService at f32 and int8 residency
    -> warmup -> closed loop, open loop, the encoded form and
    serve_forever, with launch counting, then the checks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import dispatch, load_model, save_model
    from repro_torch.data.synth import load_dataset
    from repro_torch.hdc.encoders import encode
    from repro_torch.kernels import common
    from repro_torch.serving import (ClassifierService, closed_loop,
                                     open_loop_poisson)

    _, _, x_te, _, _ = load_dataset("isolet")
    trained = {"loghd": main["model"],
               "conventional": mm["families"]["conventional"]["clf"].model}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    loaded = {}
    for name, model in trained.items():
        save_model(str(CKPT_DIR / name), 0, model)
        loaded[name] = load_model(str(CKPT_DIR / name))
    # the references, computed before any count is reset
    want, rt_equal = {}, {}
    for name, model in loaded.items():
        want[f"{name}_f32"] = model.predict(x_te)
        want[f"{name}_int8"] = model.quantized(8).materialized().predict(x_te)
        rt_equal[name] = torch.equal(trained[name].predict(x_te),
                                     want[f"{name}_f32"])
    enc = loaded["loghd"].enc
    full = encode(enc, x_te)
    b64 = encode(enc, x_te[:64])
    b1 = torch.cat([encode(enc, x_te[i:i + 1]) for i in range(64)])
    h_te = full.cpu().numpy()
    want_enc = dispatch.predict_encoded(loaded["loghd"], full)
    torch.cuda.synchronize()

    svc = ClassifierService(max_batch=MAX_BATCH)
    for name, model in loaded.items():
        svc.register(f"{name}_f32", model)
        svc.register(f"{name}_int8", model, quantize_bits=8)
    served = svc.served_models()
    t0 = time.perf_counter()
    pairs = svc.warmup()
    warmup_s = time.perf_counter() - t0
    misses0 = svc.stats()["bucket_cache"]["misses"]
    log(f"serving: {len(served)} models {served}, warmup of {pairs} "
        f"(model, bucket) pairs {warmup_s:.3f} s, buckets "
        f"{svc.bucket_cache.buckets}")

    torch.cuda.synchronize()
    common.reset_launches()
    cycles0 = svc.queue.cycles
    labels, closed, opened = {}, {}, {}
    for name in served:
        got, wall, cyc = served_labels(svc, name, x_te)
        labels[name] = (got, wall, cyc)
        closed[name] = closed_loop(svc, name, x_te)
    padding = {}                # pad rows, admitted rows, cycles per run
    for name in served:
        before = (svc.padded_rows, svc.queue.admitted, svc.queue.cycles)
        opened[name] = open_loop_poisson(
            svc, name, x_te, rate_rps=closed[name].rps / 2,
            n_requests=N_OPEN_LOOP, seed=0)
        padding[name] = (svc.padded_rows - before[0],
                         svc.queue.admitted - before[1],
                         svc.queue.cycles - before[2])
    got_enc, _, enc_cycles = served_labels(svc, "loghd_f32", h_te,
                                           encoded=True)
    svc.serve_forever()
    futs = [svc.submit("loghd_f32", r) for r in x_te[:256]]
    got_bg = [f.result(timeout=120.0) for f in futs]
    svc.shutdown(drain=True, timeout=120.0)
    torch.cuda.synchronize()
    launches = dict(common.launches)
    cycles = svc.queue.cycles - cycles0
    stats = svc.stats()
    log(f"serve path launches: {launches}; {cycles} cycles, {enc_cycles} of "
        f"them encoded-input")

    # the device's share of one closed loop (profiled apart, not counted)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        closed_loop(svc, "loghd_f32", x_te)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3

    # checks, after the counts were read
    check(not svc.serving(), "serve_forever thread still running")
    check(all(torch.equal(full[:64], x) for x in (b64, b1)),
          "an encoded row's bits depend on the batch (B = 1559, 64, 1)")
    for name in trained:
        check(rt_equal[name], f"{name}: labels differ after the checkpoint "
              f"round trip")
        ratio = svc.model_bytes(f"{name}_int8") / svc.model_bytes(
            f"{name}_f32")
        log(f"{name}: int8 residency holds {svc.model_bytes(name + '_int8')}"
            f" bytes, {ratio:.4f} of f32's {svc.model_bytes(name + '_f32')}")
        check(ratio <= 0.3, f"{name}: int8 bytes are {ratio:.3f} of f32")
    for name in served:
        got, wall, cyc = labels[name]
        ref = want[name].cpu().tolist()
        n_eq = sum(a == b for a, b in zip(got, ref))
        log(f"{name}: served labels equal predict on {n_eq} of {len(ref)} "
            f"rows ({cyc} cycles, {len(ref) / wall:.1f} requests/s)")
        check(n_eq == len(ref), f"{name}: served labels differ from predict "
              f"on {len(ref) - n_eq} rows")
    check(got_enc == want_enc.cpu().tolist(),
          "encoded-input labels differ from predict_encoded")
    check(got_bg == want["loghd_f32"][:256].cpu().tolist(),
          "serve_forever labels differ from predict")
    check(stats["bucket_cache"]["misses"] == misses0,
          f"bucket misses grew after warmup: {misses0} -> "
          f"{stats['bucket_cache']['misses']}")
    check(stats["errors"] == 0 and stats["queued"] == 0,
          f"service errors {stats['errors']}, queued {stats['queued']}")
    raw_cycles = cycles - enc_cycles
    check(launches.get("hdc_encode", 0) == raw_cycles,
          f"hdc_encode launched {launches.get('hdc_encode', 0)} times, not "
          f"once per raw-feature cycle ({raw_cycles})")
    for kname in ("bundle_sim", "profile_decode"):
        check(launches.get(kname, 0) > 0, f"{kname} never launched serving")
    for name in served:
        c, o = closed[name], opened[name]
        log(f"serve {name:<17} closed loop: {c.rps:.1f} requests/s, p50 "
            f"{c.p50_ms:.3f} ms, p99 {c.p99_ms:.3f} ms, {c.n_requests} "
            f"requests; open loop at {closed[name].rps / 2:.1f}/s: "
            f"{o.rps:.1f} requests/s, p50 {o.p50_ms:.3f} ms, p99 "
            f"{o.p99_ms:.3f} ms, {o.n_requests} requests, "
            f"{o.n_rejected} rejected")
        pad, adm, cyc = padding[name]
        log(f"serve {name:<17} open loop padding: {pad} pad rows over "
            f"{adm} admitted rows ({pad / max(adm, 1):.4f}) in {cyc} "
            f"cycles, {adm / max(cyc, 1):.2f} rows a cycle")
    log(f"serve: {cycles} cycles ({raw_cycles} raw-feature), "
        f"{stats['admitted']} requests admitted, {stats['padded_rows']} "
        f"rows padded before encode, bucket cache "
        f"{stats['bucket_cache']}")
    log(f"serve loghd_f32 closed loop under the profiler: wall "
        f"{prof_wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms, so the "
        f"device idles {1 - busy_ms / (prof_wall * 1e3):.1%}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return dict(launches=launches, closed=closed,
                opened=opened, cycles=cycles, raw_cycles=raw_cycles)


def lm_config(dtype: str = None):
    """qwen3-1.7b at full width with the loghd head, as the JAX package
    builds it (``tests/test_arch_smoke.py:118``), in `dtype` (None: the
    config's bfloat16)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), head="loghd")
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def phase_lm_kernel(torch, dev, shapes=LH_SHAPES, ragged=LH_RAGGED) -> float:
    """loghd_head against its plain version at one row, the decode step, a
    64-row batch and a 512-row prefill: h and M in float32 and bfloat16, P
    in float32 and bfloat16, at the JAX package's tolerances, with the same
    float32 argmax; a bf16 P read as stored gives the bits of its float32
    cast; two launches give equal bits; the rows of each batch are bitwise
    the first rows of the largest one; then n = 64 bundles against a
    vocabulary that no tile divides (`ragged`, None: skipped).  Returns
    the max abs error at the decode shape in bfloat16 (the serving path's
    dtypes)."""
    from repro_torch.kernels.loghd_head import (loghd_head_logits,
                                                loghd_head_logits_ref)
    from repro_torch.precision import full_f32
    g = torch.Generator(device=dev).manual_seed(14)
    b_max = max(s[0] for s in shapes)
    _, d, n, v = shapes[0]
    # the LM's scales: a final-normed state, bundles N(0, 1/D), profiles
    # 0.05 N(0, 1)
    h_all = torch.randn((b_max, d), generator=g, device=dev)
    m32 = torch.randn((n, d), generator=g, device=dev) / d ** 0.5
    p32 = torch.randn((v, n), generator=g, device=dev) * 0.05
    err = None

    def one(h, m, p, tag):
        got = loghd_head_logits(h, m, p)
        with full_f32():
            want = loghd_head_logits_ref(h, m, p)
        again = loghd_head_logits(h, m, p)
        torch.cuda.synchronize()
        name = str(h.dtype).split(".")[1]
        e = max_err(got, want)
        log(f"loghd_head     {tag} h/M {name}, P "
            f"{str(p.dtype).split('.')[1]}: max_abs_err {e:.3e}")
        check(got.shape == (h.shape[0], p.shape[0])
              and got.dtype == torch.float32,
              "loghd_head output shape / dtype")
        check(bool(torch.isfinite(got).all()), "loghd_head not finite")
        torch.testing.assert_close(got, want, **LH_TOL[name])
        if h.dtype == torch.float32:
            check(torch.equal(got.argmax(-1), want.argmax(-1)),
                  f"loghd_head {tag} argmax differs from plain (f32)")
        check(torch.equal(got, again), f"loghd_head {tag}: two launches "
              f"differ")
        if p.dtype == torch.bfloat16:
            check(torch.equal(got, loghd_head_logits(h, m, p.float())),
                  f"loghd_head {tag}: bf16 P as stored differs from its "
                  f"f32 cast")
        return got, e

    for hm in (torch.float32, torch.bfloat16):
        m = m32.to(hm)
        for pd in (torch.float32, torch.bfloat16):
            p = p32.to(pd)
            outs = []
            for (b, _, _, _) in shapes:
                got, e = one(h_all[:b].to(hm).contiguous(), m, p,
                             f"({b}, {d}, {n}, {v})")
                outs.append(got)
                if (b, hm, pd) == (4, torch.bfloat16, torch.bfloat16):
                    err = e
            big = outs[-1]
            check(all(torch.equal(o, big[:o.shape[0]]) for o in outs[:-1]),
                  f"loghd_head rows depend on B (h/M {hm}, P {pd})")
            del outs, big
    log(f"loghd_head: rows bitwise equal at B = "
        + ", ".join(str(s[0]) for s in shapes) + " for every dtype pair")
    if ragged:
        b, d, n, v = ragged
        h = torch.randn((b, d), generator=g, device=dev)
        m = torch.randn((n, d), generator=g, device=dev) / d ** 0.5
        p = torch.randn((v, n), generator=g, device=dev) * 0.05
        for hm in (torch.float32, torch.bfloat16):
            for pd in (torch.float32, torch.bfloat16):
                one(h.to(hm), m.to(hm), p.to(pd), f"({b}, {d}, {n}, {v})")
    from repro_torch.kernels.loghd_head import ops as lh_ops
    for (b, d, n, v) in shapes + ([ragged] if ragged else []):
        for p_bf16 in (True, False):
            ks, chunks, wc, t, rb, vbk, smem = lh_ops._launch_args(
                torch.cuda.current_device(), b, d, n, v, p_bf16)
            act = lh_ops.loghd_head_geometry(b, d, n, v, p_bf16).act_grid
            log(f"loghd_head launch at ({b}, {d}, {n}, {v}), P "
                f"{'bf16' if p_bf16 else 'f32'}: A stage grid {act}; score "
                f"grid ({rb}, {vbk}), {wc} warp columns, {t} row tiles a "
                f"warp, {ks} k-steps x {chunks} chunks, {smem} bytes of "
                f"shared memory a block")
    return err


def decode_vs_forward(torch, dev, cfg32, g, tol: float) -> tuple:
    """Teacher-forced ``decode_step`` against ``forward`` of `cfg32` in
    float32 over (2, 32) tokens drawn from `g`, within `tol`: (the max abs
    error, the share of positions whose argmax agrees)."""
    from repro_torch.models import model as M
    from repro_torch.precision import full_f32
    torch.cuda.reset_peak_memory_stats()
    with full_f32(), torch.no_grad():
        t0 = time.perf_counter()
        model = M.init_params(cfg32, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.randint(0, cfg32.vocab, (2, 32), generator=g,
                               device=dev)
        want, _ = M.forward(model, cfg32, tokens)
        state = M.init_decode_state(cfg32, 2, 32, device=dev)
        steps = []
        for t in range(tokens.shape[1]):
            lg, state = M.decode_step(model, cfg32, state, tokens[:, t:t + 1],
                                      t)
            steps.append(lg[:, 0])
        got = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
    err = max_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"LM {cfg32.name} float32 ({n_params} parameters, {cfg32.n_layers} "
        f"layers, drawn in {init_s:.2f} s, peak allocated "
        f"{torch.cuda.max_memory_allocated()} B): teacher-forced decode vs "
        f"forward over (2, 32) tokens: max_abs_err {err:.3e} (bound {tol}) "
        f"on logits up to {float(want.abs().max()):.2f}, argmax agrees on "
        f"{agree:.4f}")
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"LM {cfg32.name} float32 decode logits not finite or misshapen")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    del model, state, want, got, steps
    torch.cuda.empty_cache()
    return err, agree


def phase_lm(torch, dev, cfg32=None, cfg16=None, *, heads=("loghd", "dense"),
             decode_tol: float = 2e-3, keep_model: bool = True) -> dict:
    """The decoder LM at full width: teacher-forced decode against forward
    in float32 within `decode_tol` (``decode_vs_forward``; `cfg32` False:
    not checked), then ``run_serving`` with the ``launch/serve.py``
    traffic in bfloat16 under each of `heads`, with launch counting, a
    repeat, and a profile of one decode step.  Each model's parameters,
    init seconds and peak allocated bytes are printed; `keep_model` keeps
    the loghd model for ``time_lm_head``."""
    import dataclasses

    import numpy as np
    from repro_torch.kernels import common
    from repro_torch.launch.serve import requests_for
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop

    cfg32 = lm_config(dtype="float32") if cfg32 is None else cfg32
    cfg16 = cfg16 or lm_config()
    out: dict = {}

    # 1. decode against forward, float32, tokens (2, 32)
    g = torch.Generator(device=dev).manual_seed(0)
    if cfg32:
        out["decode_vs_forward_err"], out["argmax_agree"] = \
            decode_vs_forward(torch, dev, cfg32, g, decode_tol)

    # 2. serving in bf16, under each head
    serve = serve_loop.ServeLoopConfig(batch_slots=4, max_new_tokens=16,
                                       max_len=256)
    for head in heads:
        cfg = dataclasses.replace(cfg16, head=head)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        reqs = requests_for(cfg, 6, seed=0)
        steps = [0]
        real_step = serve_loop.decode_step

        def counted(*args, **kw):
            steps[0] += 1
            return real_step(*args, **kw)

        serve_loop.decode_step = counted
        try:
            torch.cuda.synchronize()
            common.reset_launches()
            t0 = time.perf_counter()
            toks = serve_loop.run_serving(cfg, model, reqs, serve)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(common.launches)
            n_steps = steps[0]
            t0 = time.perf_counter()
            again = serve_loop.run_serving(cfg, model, reqs, serve)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        finally:
            serve_loop.decode_step = real_step
        n_tok = sum(len(v) for v in toks.values())
        per_step = launches.get("loghd_head", 0) / n_steps
        log(f"LM serve {cfg.name} {cfg.dtype} head {head} ({n_params} "
            f"parameters, {cfg.n_layers} layers, drawn in {init_s:.2f} s): "
            f"{len(toks)} requests, {n_tok} tokens, {n_steps} decode steps "
            f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s); repeat "
            f"{wall2:.3f} s ({n_tok / wall2:.1f} tokens/s); launches "
            f"{launches}, loghd_head {per_step:g} a decode step; peak "
            f"allocated {torch.cuda.max_memory_allocated()} B")
        for uid in sorted(toks):
            log(f"  req {uid} (prompt {len(reqs[uid].prompt)}): "
                f"{toks[uid][:8].tolist()}...")
        check(sorted(toks) == list(range(6)), "LM serve: requests missing")
        check(all(len(v) == 17 and v.min() >= 0 and v.max() < cfg.vocab
                  for v in toks.values()), "LM serve: tokens misshapen")
        check(all(np.array_equal(toks[u], again[u]) for u in toks),
              f"LM serve {cfg.name} ({head}): a second run gave other tokens")
        want_lh = n_steps if head == "loghd" else 0
        check(launches.get("loghd_head", 0) == want_lh,
              f"loghd_head launched {launches.get('loghd_head', 0)} times "
              f"over {n_steps} decode steps with the {head} head, not "
              f"{want_lh}")
        want_ms = n_steps * moe_layers(model)
        check(launches.get("moe_slots", 0) == want_ms,
              f"moe_slots launched {launches.get('moe_slots', 0)} times "
              f"over {n_steps} decode steps, not {want_ms}")
        check(sum(lm_launches(launches, NO_FLASH, "LM serve").values())
              == want_lh + want_ms,
              f"other kernels launched on the LM path: {launches}")

        # one decode step at the serving batch, profiled
        state = M.init_decode_state(cfg, 4, 256, device=dev)
        tok = torch.randint(0, cfg.vocab, (4, 1), generator=g, device=dev)
        pos = torch.tensor([5, 9, 17, 33], device=dev)

        def step():
            return M.decode_step(model, cfg, state, tok, pos)
        step()
        walls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_wall = statistics.median(walls) * 1e3
        busy, count, top = profile_calls(torch, step)
        x = torch.randn((4, 1, cfg.d_model), generator=g, device=dev).to(
            model.embed.table.dtype)
        head_ms = device_ms(torch, lambda: model.head(x))
        head_top = profile_calls(torch, lambda: model.head(x), calls=20)[2]
        log(f"LM decode step {cfg.name} ({head} head, B = 4): wall "
            f"{step_wall:.3f} ms (median of 20), device busy {busy:.3f} ms, "
            f"so the device idles {1 - busy / step_wall:.1%}; {count:.0f} "
            f"device kernels and copies a step")
        for ms, cnt, key in top[:8]:
            log(f"  {ms:9.4f} ms  {cnt:5.0f}x  {key[:90]}")
        log(f"LM head ({head}) alone: {head_ms} ms of device time a call")
        for ms, cnt, key in head_top[:3]:
            log(f"  {ms:9.5f} ms  {cnt:5.2f}x  {key[:90]}")
        out[head] = dict(launches=launches, steps=n_steps, tokens=n_tok,
                         wall_s=wall, repeat_wall_s=wall2,
                         step_wall_ms=step_wall, step_device_ms=busy,
                         kernels_per_step=count, head_device_ms=head_ms,
                         n_params=n_params, init_s=init_s,
                         model=model if head == "loghd" and keep_model
                         else None)
        del model, state
        torch.cuda.empty_cache()
    return out


# the training phase: the loghd_head gradient at the CLI's training batch
# (global batch 8 x seq 128 = 1,024 rows), against autograd through the
# plain version, each gradient's max abs error relative to its max: float32
# at the forward's float32 rtol (LH_TOL), bfloat16 at the JAX package's
# bf16 kernel tolerance (TOL): a bf16 gradient is rounded to 8 bits once
# on both routes, 2^-8 = 3.9e-3 of a value
LT_SHAPE = (1024, 2048, 20, 151936)
LT_GRAD_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
LT_STEPS = 20               # steps a head at the CLI's defaults
LT_BATCH, LT_SEQ = 8, 128   # launch/train.py's --global-batch, --seq-len
LT_CHUNKED = (2, 1024)      # (B, S) of the chunked-CE step: 2 chunks of 512
# the chunked loss against the unchunked one: only the float32 sum of the
# token NLLs is ordered otherwise (loghd_head rows do not depend on B)
LT_CHUNK_RTOL = 1e-5
# the loghd head's 20 losses through the kernel against the same steps with
# the head through its plain version on the card: the forwards differ in
# float32 rounding (about 1e-6 of a logit), and a bf16 parameter rounded
# the other way moves the later losses; both routes repeat bit for bit, and
# two runs on the H100 measured the same largest difference, 4.56e-3 (at
# the 18th step), so the bound is about twice it
LT_PLAIN_ATOL = 1e-2
# the resumed run's losses against the straight run's when the card's
# backward is not bitwise repeatable (atomic adds in the embedding's
# backward): a bf16 parameter rounded the other way moves a loss by about
# 2^-8 of a step's change
LT_RESUME_RTOL = 2e-3
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke_train_ckpt"


def check_head_grad(torch, dev, shape=LT_SHAPE) -> dict:
    """loghd_head's autograd Function (kernel forward, torch backward)
    against autograd through the plain version, in bfloat16 and float32:
    the logits bitwise the kernel-only call's and within LH_TOL of the
    plain logits (in float32 with the same argmax), each gradient within
    LT_GRAD_BOUND of plain relative to its max."""
    from repro_torch.kernels.loghd_head import (loghd_head_autograd,
                                                loghd_head_logits,
                                                loghd_head_logits_ref)
    from repro_torch.precision import full_f32
    b, d, n, v = shape
    g = torch.Generator(device=dev).manual_seed(21)
    h32 = torch.randn((b, d), generator=g, device=dev)
    m32 = torch.randn((n, d), generator=g, device=dev) / d ** 0.5
    p32 = torch.randn((v, n), generator=g, device=dev) * 0.05
    up = torch.randn((b, v), generator=g, device=dev) / (b * 8)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        leaves = [t.to(dt).requires_grad_() for t in (h32, m32, p32)]
        plain = [t.detach().clone().requires_grad_() for t in leaves]
        with torch.no_grad():
            want_fwd = loghd_head_logits(*[t.detach() for t in leaves])
        got = loghd_head_autograd(*leaves)
        check(torch.equal(got, want_fwd),
              f"loghd_head autograd forward ({name}) differs from the "
              f"kernel-only call")
        del want_fwd
        with full_f32():
            ref = loghd_head_logits_ref(*plain)
        fwd_err = max_err(got, ref)
        log(f"loghd_head logits at {shape} {name}: max_abs_err {fwd_err:.3e} "
            f"against plain ({LH_TOL[name]})")
        torch.testing.assert_close(got.detach(), ref.detach(), **LH_TOL[name])
        if dt == torch.float32:
            check(torch.equal(got.argmax(-1), ref.argmax(-1)),
                  f"loghd_head {shape} argmax differs from plain (f32)")
        got.backward(up)
        del got
        with full_f32():
            ref.backward(up)
        del ref
        torch.cuda.synchronize()
        errs = {"logits": fwd_err}
        grads = {}
        for label, t, r in zip(("dh", "dM", "dP"), leaves, plain):
            check(t.grad.dtype == dt and bool(torch.isfinite(t.grad).all()),
                  f"loghd_head {label} ({name}) not finite or of dtype "
                  f"{t.grad.dtype}")
            grads[label] = max_err(t.grad, r.grad) / float(
                r.grad.float().abs().max())
        log(f"loghd_head gradient at {shape} {name}: max abs error against "
            f"plain relative to its max: " + ", ".join(
                f"{k} {e:.3e}" for k, e in grads.items())
            + f" (bound {LT_GRAD_BOUND[name]})")
        check(all(e <= LT_GRAD_BOUND[name] for e in grads.values()),
              f"loghd_head gradient ({name}) beyond {LT_GRAD_BOUND[name]} "
              f"of plain: {grads}")
        errs.update(grads)
        out[name] = errs
        del leaves, plain
    del up
    torch.cuda.empty_cache()
    return out


def train_step_times(torch, cfg, model, opt_state, step_fn, pipe,
                     step0: int) -> dict:
    """After the counted steps: one step profiled (device time by kernel,
    and its own wall, which the idle share divides by), then the optimizer
    alone and the head alone (forward and backward), each the median of 3
    walls around a synchronisation."""
    from repro_torch.models.model import _xent_from_logits, loss_fn
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    batch = pipe.batch(step0)
    state = {"step": step0, "walls": []}

    def one_step():
        state["step"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(model, opt_state, batch, state["step"])[2].item()
        state["walls"].append((time.perf_counter() - t0) * 1e3)
        return loss

    busy, count, top = profile_calls(torch, one_step, calls=1)
    profiled_ms = state["walls"][-1]
    params = dict(model.named_parameters())
    loss = loss_fn(model, cfg, batch["tokens"], batch["targets"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    del loss

    def wall_ms(fn, reps: int = 3) -> float:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    opt_ms = wall_ms(lambda: adamw_update(opt_state, params, grads,
                                          AdamWConfig(), lr=1e-6))
    del grads
    with torch.no_grad():
        x = model.backbone(batch["tokens"])[0]
    x.requires_grad_()
    head_params = list(model.head.parameters())
    targets = batch["targets"].long()

    def head():
        nll = _xent_from_logits(model.head(x), targets) / targets.numel()
        torch.autograd.grad(nll, [x, *head_params])
    head_ms = wall_ms(head)
    return dict(profiled_busy_ms=busy, profiled_wall_ms=profiled_ms,
                kernels_per_step=count, top=top, opt_ms=opt_ms,
                head_ms=head_ms)


def train_losses(torch, dev, cfg, steps: int = LT_STEPS) -> dict:
    """`steps` training steps of `cfg` at the CLI's defaults through
    ``make_train_step`` from seed 0 and the ``TokenPipeline`` of seed 0:
    the model, its losses, each step's wall and ``loghd_head`` launches,
    the launches in all and the peak allocated bytes."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.models.convert import stacked_layers
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                make_train_step)
    model = init_params(cfg, seed=0, device=dev)
    pipe = TokenPipeline(cfg.vocab, LT_SEQ, LT_BATCH, seed=0, device=dev)
    loop = TrainLoopConfig(total_steps=100, warmup_steps=10, peak_lr=3e-4)
    opt_state = adamw_init(dict(model.named_parameters()), AdamWConfig(),
                           stacked_layers(model))
    step_fn = make_train_step(cfg, AdamWConfig(), loop)
    losses, walls, per_step = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    for step in range(steps):
        before = common.launches["loghd_head"]
        t0 = time.perf_counter()
        _, _, loss = step_fn(model, opt_state, pipe.batch(step), step)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
        per_step.append(common.launches["loghd_head"] - before)
    return dict(model=model, opt_state=opt_state, step_fn=step_fn, pipe=pipe,
                losses=losses, walls=walls, per_step=per_step,
                launches=dict(common.launches),
                peak=torch.cuda.max_memory_allocated())


def check_grads_nonzero(torch, dev, cfg) -> float:
    """Every parameter of a fresh full-width model gets a finite, nonzero
    gradient from the loss of the pipeline's first batch (the LogHD head's
    through ``loghd_head``'s autograd Function on the card; an MoE block's
    router and expert leaves among them).  The expert slices with a zero
    gradient are counted, not refused: an expert that no token of the
    batch chose gets none, in the reference too.  Returns the batch's MoE
    aux loss (0.0 without MoE blocks)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model import init_params, loss_fn
    model = init_params(cfg, seed=0, device=dev)
    batch = TokenPipeline(cfg.vocab, LT_SEQ, LT_BATCH, seed=0,
                          device=dev).batch(0)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss_fn(model, cfg, batch["tokens"],
                                        batch["targets"]),
                                list(params.values()))
    zero = [n for n, gr in zip(params, grads)
            if not (bool(torch.isfinite(gr).all()) and bool(gr.any()))]
    experts = [(n, gr) for n, gr in zip(params, grads)
               if ".moe.w" in n]
    idle = [(n, int((~gr.flatten(1).any(1)).sum())) for n, gr in experts]
    idle = [(n, k) for n, k in idle if k]
    log(f"LM {cfg.name} head {cfg.head}: {len(params) - len(zero)} of "
        f"{len(params)} parameters have a finite nonzero gradient; "
        f"{len(experts)} stacked expert leaves, "
        f"{sum(gr.shape[0] for _, gr in experts)} expert slices, "
        f"{sum(k for _, k in idle)} of them with a zero gradient")
    if idle:
        log(f"  experts no token of the batch chose: {idle[:8]}")
    check(not zero, f"{cfg.head} head: zero or non-finite gradients on "
          f"{zero[:8]} ({len(zero)} of {len(params)} parameters)")
    with torch.no_grad():
        aux = float(model.backbone(batch["tokens"])[1])
    return aux


def train_head(torch, dev, cfg, steps: int = LT_STEPS) -> dict:
    """`steps` training steps of `cfg` (``train_losses``): finite losses,
    exactly one ``loghd_head`` launch a step under the loghd head and none
    under the dense one; then the step's walls, peak memory and time
    shares.  The caller judges the losses' course."""
    import math
    check_grads_nonzero(torch, dev, cfg)
    r = train_losses(torch, dev, cfg, steps)
    model, losses, launches = r["model"], r["losses"], r["launches"]
    n_params = sum(p.numel() for p in model.parameters())
    want = 1 if cfg.head == "loghd" else 0
    log(f"LM train {cfg.name} head {cfg.head} ({n_params} parameters, "
        f"{cfg.dtype}, remat {cfg.remat_policy}, batch {LT_BATCH} x "
        f"{LT_SEQ}): losses " + " ".join(f"{x:.4f}" for x in losses))
    check(all(math.isfinite(x) for x in losses),
          f"{cfg.head} head: a loss is not finite: {losses}")
    check(all(c == want for c in r["per_step"]),
          f"{cfg.head} head: loghd_head launches a step {r['per_step']}, "
          f"not {want} each")
    flash = flash_train_launches(model, cfg, steps, LT_SEQ)
    check(sum(lm_launches(launches, flash, cfg.head).values()) == want * steps,
          f"{cfg.head} head: kernels launched on the training path: "
          f"{launches}")
    step_ms = statistics.median(r["walls"]) * 1e3
    t = train_step_times(torch, cfg, model, r["opt_state"], r["step_fn"],
                         r["pipe"], steps)
    log(f"  step wall {step_ms:.2f} ms (median of {steps}), "
        f"{LT_BATCH * LT_SEQ / step_ms * 1e3:.0f} tokens/s, peak allocated "
        f"{r['peak']} B; one profiled step: {t['profiled_busy_ms']:.2f} ms "
        f"of device work in its wall of {t['profiled_wall_ms']:.2f} ms, "
        f"{t['kernels_per_step']:.0f} kernels and copies, idle "
        f"{1 - t['profiled_busy_ms'] / t['profiled_wall_ms']:.1%}; "
        f"optimizer alone "
        f"{t['opt_ms']:.2f} ms ({t['opt_ms'] / step_ms:.1%} of the step), "
        f"head forward + backward {t['head_ms']:.3f} ms "
        f"({t['head_ms'] / step_ms:.1%}); launches {launches}")
    for ms, cnt, key in t["top"][:10]:
        log(f"  {ms:9.3f} ms  {cnt:6.1f}x  {key[:90]}")
    return dict(model=model, losses=losses, launches=launches,
                step_ms=step_ms, peak_bytes=r["peak"], n_params=n_params,
                **{k: v for k, v in t.items() if k != "top"})


def plain_head_losses(torch, dev, cfg, steps: int = LT_STEPS) -> list:
    """The same `steps` steps of the loghd head with the head through its
    plain version on the card (autograd through ``loghd_head_logits_ref``,
    no launch): the losses the kernel route is held against."""
    from repro_torch.api import dispatch
    from repro_torch.kernels.loghd_head import loghd_head_logits_ref
    from repro_torch.kernels import common
    real = dispatch.loghd_head_autograd
    dispatch.loghd_head_autograd = loghd_head_logits_ref
    try:
        r = train_losses(torch, dev, cfg, steps)
    finally:
        dispatch.loghd_head_autograd = real
    flash = flash_train_launches(r["model"], cfg, steps, LT_SEQ)
    check(not lm_launches(r["launches"], flash, "plain head"),
          f"plain-head run launched {r['launches']}")
    del r["model"], r["opt_state"]
    return r["losses"]


def check_chunked(torch, dev, cfg, model) -> dict:
    """One gradient step at (B, S) = LT_CHUNKED with cfg.loss_chunk = 512:
    exactly 4 ``loghd_head`` launches (two chunks, a forward and a
    recomputation each), the loss within LT_CHUNK_RTOL of loss_chunk=0."""
    import dataclasses

    from repro_torch.kernels import common
    from repro_torch.models.model import loss_fn
    b, s = LT_CHUNKED
    check(cfg.loss_chunk and s % cfg.loss_chunk == 0 and s > cfg.loss_chunk,
          f"chunked CE needs S = {s} a multiple above loss_chunk "
          f"{cfg.loss_chunk}")
    g = torch.Generator(device=dev).manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    tgt = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    common.reset_launches()
    loss = loss_fn(model, cfg, tok, tgt)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    launches = dict(common.launches)
    del grads
    with torch.no_grad():
        whole = loss_fn(model, dataclasses.replace(cfg, loss_chunk=0), tok,
                        tgt)
    rel = abs(loss.item() - whole.item()) / abs(whole.item())
    log(f"LM chunked CE at (B, S) = {LT_CHUNKED}, chunk {cfg.loss_chunk}: "
        f"loss {loss.item():.6f} against {whole.item():.6f} unchunked "
        f"(relative {rel:.2e}, bound {LT_CHUNK_RTOL}); launches {launches}")
    check(rel <= LT_CHUNK_RTOL, f"chunked CE loss {rel:.2e} from unchunked")
    flash = flash_train_launches(model, cfg, 1, s)
    check(lm_launches(launches, flash, "chunked CE") == {"loghd_head": 4},
          f"chunked CE step launched {launches}, not loghd_head 4 times")
    return dict(launches=launches, rel=rel)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def check_entry_point(torch, dev, cfg) -> dict:
    """``run_training`` at full width with int8 moments for 3 steps into
    TRAIN_CKPT_DIR: its final checkpoint's bytes and write time (the
    AsyncCheckpointer's save to its wait), free disk before; the directory
    removed after."""
    import math

    from repro_torch.kernels import common
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train_loop
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    TRAIN_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(TRAIN_CKPT_DIR.parent).free
    marks = {}
    real = train_loop.AsyncCheckpointer

    class Timed(real):
        def save(self, step, tree):
            marks["save"] = time.perf_counter()
            super().save(step, tree)
            marks["host"] = time.perf_counter()

        def wait(self):
            super().wait()
            marks["done"] = time.perf_counter()

    train_loop.AsyncCheckpointer = Timed
    try:
        common.reset_launches()
        t0 = time.perf_counter()
        out = train_loop.run_training(
            cfg, loop=train_loop.TrainLoopConfig(
                total_steps=3, ckpt_dir=str(TRAIN_CKPT_DIR), ckpt_every=50),
            opt_cfg=AdamWConfig(moment_dtype="int8"), device=dev)
        wall = time.perf_counter() - t0
    finally:
        train_loop.AsyncCheckpointer = real
    launches = dict(common.launches)
    written = dir_bytes(TRAIN_CKPT_DIR)
    files = sum(1 for f in TRAIN_CKPT_DIR.rglob("*") if f.is_file())
    log(f"LM run_training {cfg.name} head {cfg.head}, int8 moments, 3 steps:"
        f" losses {out['losses']}; {wall:.2f} s in all; free disk before "
        f"{free} B; checkpoint {written} B in {files} files, host copy "
        f"{marks['host'] - marks['save']:.2f} s, written by "
        f"{marks['done'] - marks['save']:.2f} s after save(); launches "
        f"{launches}")
    del out
    shutil.rmtree(TRAIN_CKPT_DIR)
    check(not TRAIN_CKPT_DIR.exists(), "training checkpoint not removed")
    torch.cuda.empty_cache()
    return dict(launches=launches, bytes=written, free=free, wall_s=wall,
                write_s=marks["done"] - marks["save"])


def check_restart(torch, dev, cfg) -> dict:
    """``cfg`` at n_periods = 2, int8 moments: 6 steps straight against 3,
    a stop (checkpoint) and a resume for 3; the resumed losses equal the
    straight run's bit for bit, or, where a repeat of the first 3 steps
    shows that the card's backward is not repeatable, within
    LT_RESUME_RTOL."""
    import dataclasses

    import numpy as np
    from repro_torch.kernels import common
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
    cfg = dataclasses.replace(cfg, n_periods=2)
    opt = AdamWConfig(moment_dtype="int8")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    common.reset_launches()
    t0 = time.perf_counter()

    def run(name, **kw):
        loop = TrainLoopConfig(total_steps=6, warmup_steps=2, ckpt_every=100,
                               ckpt_dir=str(TRAIN_CKPT_DIR / name))
        return run_training(cfg, loop=loop, opt_cfg=opt, device=dev, **kw)
    straight = run("straight")["losses"]
    first = run("stopped", stop_after=3)["losses"]
    resumed = run("stopped")
    launches = dict(common.launches)
    check(resumed["resumed"] and resumed["first_step"] == 3,
          "restart: the second run did not resume at step 3")
    got = first + resumed["losses"]
    bitwise = got == straight
    rel = float(np.abs(np.array(got) - straight).max()
                / np.abs(straight).max())
    repeatable = None
    if not bitwise:
        repeatable = run("repeat", stop_after=3)["losses"] == straight[:3]
    shutil.rmtree(TRAIN_CKPT_DIR)
    log(f"LM restart {cfg.name} x 2 periods head {cfg.head}: straight "
        f"{straight}; stopped + resumed {first} + {resumed['losses']}; "
        f"bitwise {bitwise}, max relative difference {rel:.2e}"
        + ("" if bitwise else f"; a repeat of the first 3 steps equal: "
           f"{repeatable}") + f"; {time.perf_counter() - t0:.2f} s; "
        f"launches {launches}")
    if not bitwise:
        check(not repeatable and rel <= LT_RESUME_RTOL,
              f"restart: resumed losses differ ({rel:.2e}) though the "
              f"first 3 steps repeat bitwise ({repeatable})")
    return dict(launches=launches, bitwise=bitwise, rel=rel,
                repeatable=repeatable)


def phase_lm_train(torch, dev, cfg=None) -> dict:
    """LM training at full width (qwen3-1.7b, bf16, remat "full"): the
    head's gradient, both heads through ``make_train_step`` at the CLI's
    defaults, the chunked CE, ``run_training`` with int8 moments and a
    checkpoint, and restart exactness.

    The losses' course: under the dense head the last five losses average
    below the first.  Under the loghd head they rise at these settings, in
    the JAX package too: ``tests/test_torch_lm_loss_course.py`` runs both
    packages from the same weights on the same batches at this width with
    one layer, and both rise alike.  So the kernel route is held against
    the plain route on the card, step by step, within LT_PLAIN_ATOL."""
    import dataclasses
    cfg = cfg or lm_config()
    t_phase = time.perf_counter()
    marks = [("start", t_phase)]
    out = {"grad": check_head_grad(torch, dev)}
    marks.append(("gradient", time.perf_counter()))
    for head in ("loghd", "dense"):
        r = train_head(torch, dev, dataclasses.replace(cfg, head=head))
        marks.append((f"train {head}", time.perf_counter()))
        if head == "loghd":
            out["chunked"] = check_chunked(torch, dev, cfg, r["model"])
            marks.append(("chunked", time.perf_counter()))
        del r["model"]
        torch.cuda.empty_cache()
        out[head] = r
        if head == "loghd":
            plain = plain_head_losses(torch, dev, cfg)
            diff = max(abs(a - b) for a, b in zip(r["losses"], plain))
            log(f"LM train loghd head through the plain version: losses "
                + " ".join(f"{x:.4f}" for x in plain)
                + f"; largest difference from the kernel route {diff:.2e} "
                f"(bound {LT_PLAIN_ATOL})")
            check(diff <= LT_PLAIN_ATOL, f"loghd head: kernel-route losses "
                  f"{diff:.2e} from the plain route's")
            r["plain_diff"] = diff
            marks.append(("plain loghd", time.perf_counter()))
            torch.cuda.empty_cache()
        else:
            last5 = statistics.mean(r["losses"][-5:])
            check(last5 < r["losses"][0],
                  f"{head} head: the last five losses average {last5:.4f}, "
                  f"not below the first {r['losses'][0]:.4f}")
    out["entry"] = check_entry_point(torch, dev, cfg)
    marks.append(("run_training", time.perf_counter()))
    out["restart"] = check_restart(torch, dev, cfg)
    marks.append(("restart", time.perf_counter()))
    lh, de = out["loghd"], out["dense"]
    log(f"LM train shares, loghd against dense: optimizer "
        f"{lh['opt_ms'] / lh['step_ms']:.1%} / {de['opt_ms'] / de['step_ms']:.1%}"
        f" of the step, head {lh['head_ms'] / lh['step_ms']:.1%} / "
        f"{de['head_ms'] / de['step_ms']:.1%}; steps {lh['step_ms']:.2f} / "
        f"{de['step_ms']:.2f} ms; the phase {time.perf_counter() - t_phase:.1f}"
        f" s (" + ", ".join(f"{name} {t - marks[i][1]:.1f} s" for i, (name, t)
                            in enumerate(marks[1:])) + ")")
    return out


# slice 12's architectures at their published widths: (arch, the float32
# decode-vs-forward check's overrides, None: no check; its bound; the served
# bf16 model's overrides; the heads served).  The bounds are the JAX
# package's own (tests/test_arch_smoke.py:93 for attention, :111 for the
# recurrent mixers); the capacity factors are E / k, so that no MoE token
# is dropped and decode and forward compute one network (a decode step's
# capacity counts its B tokens, a forward's all B x S).
LM_ARCHS = (
    ("granite-moe-1b-a400m", {"capacity_factor": 4.0}, 2e-3, {},
     ("loghd", "dense")),
    # one period: with more, the reference's decode walks the body in
    # another order than its forward (ROADMAP queue 3)
    ("xlstm-125m", {"n_periods": 1}, 5e-3, {}, ("loghd", "dense")),
    # one period of 4: 13.3 B parameters, 27 GB in bf16 and 53 GB in
    # float32; the whole 52 B would need 104 GB in bf16
    ("jamba-v0.1-52b", {"n_periods": 1, "capacity_factor": 8.0}, 5e-3,
     {"n_periods": 1}, ("loghd",)),
    # one dense MLA layer and one MoE MLA layer of 256 experts: 14 B
    # parameters, 28 GB in bf16; bf16 only
    ("deepseek-v3-671b", None, None, {"n_prefix": 1, "n_periods": 1},
     ("loghd",)),
)
LM_ARCH_KERNEL_ROWS = (1, 4, 64)
# the rows of a training step's head call (batch x loss chunk) where a
# benchmark cell trains at that head shape: deepseek-v3-ep32's 4 x 512
LM_ARCH_TRAIN_ROWS = {"deepseek-v3-671b": (2048,)}


def lm_arch_head_shapes(b: int) -> list:
    """(arch, (b, d_model, n, V)) of the loghd head of each of
    ``LM_ARCHS``."""
    from repro_torch.configs import get_config
    return [(arch, (b, cfg.d_model, cfg.loghd_bundles, cfg.vocab))
            for arch, *_ in LM_ARCHS for cfg in [get_config(arch)]]


def phase_lm_arch_kernels(torch, dev) -> dict:
    """``phase_lm_kernel`` at each of ``LM_ARCHS``' head shapes, B = 1, 4
    and 64, and ``LM_ARCH_TRAIN_ROWS`` (widths 768 to 7,168, n = 18 and
    19, where the A stage never ran before): both dtype pairs of h / M and
    of P, the float32 argmax of plain, two launches equal, rows independent
    of B.  Returns each arch's max abs error at B = 4 in bf16."""
    errs = {}
    for arch, (_, d, n, v) in lm_arch_head_shapes(1):
        rows = LM_ARCH_KERNEL_ROWS + LM_ARCH_TRAIN_ROWS.get(arch, ())
        errs[arch] = phase_lm_kernel(
            torch, dev, shapes=[(b, d, n, v) for b in rows], ragged=None)
    return errs


def lm_arch_train(torch, dev, cfg) -> dict:
    """Two steps of ``make_train_step`` at ``launch/train.py``'s defaults
    (``train_losses``) of `cfg` at full width, after every parameter's and
    every expert's gradient is checked nonzero: finite losses, a positive
    MoE aux loss, one ``loghd_head`` launch a step."""
    import math
    aux = check_grads_nonzero(torch, dev, cfg)
    torch.cuda.empty_cache()
    r = train_losses(torch, dev, cfg, steps=2)
    n_params = sum(p.numel() for p in r["model"].parameters())
    log(f"LM train {cfg.name} head {cfg.head} ({n_params} parameters, "
        f"{cfg.dtype}, remat {cfg.remat_policy}, batch {LT_BATCH} x "
        f"{LT_SEQ}): aux loss of the first batch {aux:.6f}; losses "
        + " ".join(f"{x:.4f}" for x in r["losses"])
        + "; step walls " + " ".join(f"{w * 1e3:.1f}" for w in r["walls"])
        + f" ms; peak allocated {r['peak']} B; launches {r['launches']}")
    check(all(math.isfinite(x) for x in r["losses"]),
          f"{cfg.name}: a loss is not finite: {r['losses']}")
    check(aux > 0, f"{cfg.name}: MoE aux loss {aux} not positive")
    want = 1 if cfg.head == "loghd" else 0
    check(r["per_step"] == [want, want], f"{cfg.name}: loghd_head launches "
          f"a step {r['per_step']}, not {want} each")
    # two steps, each routing in the forward and, under remat, again in
    # the backward's recomputation
    want_ms = 2 * moe_layers(r["model"]) * (
        1 if cfg.remat_policy == "none" else 2)
    check(r["launches"].get("moe_slots", 0) == want_ms,
          f"{cfg.name}: moe_slots launches {r['launches']}, not {want_ms}")
    flash = flash_train_launches(r["model"], cfg, 2, LT_SEQ)
    check(sum(lm_launches(r["launches"], flash, cfg.name).values())
          == 2 * want + want_ms,
          f"{cfg.name}: kernels launched on the training path: "
          f"{r['launches']}")
    out = dict(losses=r["losses"], launches=r["launches"], aux=aux,
               walls=r["walls"], peak_bytes=r["peak"], n_params=n_params)
    del r
    torch.cuda.empty_cache()
    return out


def phase_lm_archs(torch, dev) -> dict:
    """Slice 12's architectures through the LM entry points at their
    published widths (``LM_ARCHS``; every depth cut printed):
    ``phase_lm``'s decode-against-forward check in float32, ``run_serving``
    of the CLI's traffic in bf16 with its launch, repeat and profile
    checks, each model freed before the next; and granite-moe's two
    training steps (``lm_arch_train``)."""
    import dataclasses
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    log(f"slice 12 LM phase: {torch.cuda.memory_allocated()} B allocated "
        f"by earlier phases")
    out = {}
    for arch, dec_over, tol, serve_over, heads in LM_ARCHS:
        t0 = time.perf_counter()
        full = dataclasses.replace(get_config(arch), head="loghd")
        cfg32 = (dataclasses.replace(full, dtype="float32", **dec_over)
                 if dec_over is not None else False)
        cfg16 = dataclasses.replace(full, **serve_over)
        for what, cfg in (("decode check (float32)", cfg32),
                          ("serving (bf16)", cfg16)):
            if cfg and cfg.n_layers != full.n_layers:
                log(f"LM {arch} {what}: depth cut to {cfg.n_layers} of "
                    f"{full.n_layers} layers ({cfg.param_count()} of "
                    f"{full.param_count()} parameters)")
        r = phase_lm(torch, dev, cfg32, cfg16, heads=heads,
                     decode_tol=tol or 0.0, keep_model=False)
        if full.n_experts and arch.startswith("granite"):
            r["train"] = lm_arch_train(torch, dev, full)
        out[arch] = r
        log(f"LM {arch}: {time.perf_counter() - t0:.1f} s")
    log(f"slice 12 LM phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ----------------------------------------------------- slice 13: sharded LM --

# the sharded training run: launch/train.py --mesh debug at its defaults
LS_STEPS = 3
LS_CKPT_DIR = ROOT / "build" / "chip_smoke_sharded_ckpt"
# the elastic restore at full width cut to 2 layers (the checkpoint is then
# 3 GB instead of 17): written unsharded at step 2, resumed with and
# without the mesh
LS_RESTORE_PERIODS = 2
# granite-moe's expert-parallel decode: teacher-forced steps at B = 4
LS_EP_STEPS = 8
# the sequence-sharded flash decode at qwen3's attention widths
LS_FLASH_CACHE, LS_FLASH_POS = 4096, 3000
LS_FLASH_TOL = 2e-4
# the dry run's cells, each in a process of its own (the fake group is
# process-global): a dense train cell and a MoE decode cell
LS_DRY_CELLS = (("qwen3-1.7b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"))
LS_DRY_DIR = ROOT / "build" / "chip_smoke_dryrun"
LS_DRY_TIMEOUT = 900
LS_PHASE_LIMIT = 150.0


def start_dry_runs() -> list:
    """``python -m repro_torch.launch.dryrun`` for each of LS_DRY_CELLS, in
    processes of their own, started at once."""
    import os
    shutil.rmtree(LS_DRY_DIR, ignore_errors=True)
    LS_DRY_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mesh in LS_DRY_CELLS:
        log_path = LS_DRY_DIR / f"{arch}__{shape}__{mesh}.log"
        procs.append((arch, shape, mesh, log_path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             str(LS_DRY_DIR)], cwd=ROOT, env=env,
            stdout=open(log_path, "w"), stderr=subprocess.STDOUT)))
    return procs


def finish_dry_runs(procs: list, kind: str) -> list:
    """Wait for the dry runs; print each cell's GiB a device, FLOPs,
    collective bytes by kind and its roofline row on `kind`'s peaks."""
    from repro_torch.launch import dryrun, roofline
    rows = []
    t0 = time.perf_counter()
    for arch, shape, mesh, log_path, proc in procs:
        try:
            code = proc.wait(timeout=max(1.0, LS_DRY_TIMEOUT
                                         - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = None
        text = log_path.read_text()
        check(code == 0, f"dry run {arch} x {shape} x {mesh} exited with "
              f"{code}: {text[-2000:]}")
        with open(LS_DRY_DIR / f"{arch}__{shape}__{mesh}.json") as f:
            rec = json.load(f)
        row = roofline.roofline_cell(rec, kind)
        log(f"dry run {arch} x {shape} x {mesh} ({rec['n_devices']} fake "
            f"ranks, layout arithmetic, not a measurement): "
            f"{dryrun.summary(rec)}")
        log(f"  roofline on {kind}'s published peaks: " + roofline.HEADER)
        log(f"  roofline on {kind}'s published peaks: "
            + roofline.row_text(row))
        check(rec["memory"]["per_device_total_bytes"] > 0
              and rec["collectives"]["total_bytes"] > 0
              and row["T_compute_s"] > 0,
              f"dry run {arch} x {shape} x {mesh}: an empty record {rec}")
        rows.append(dict(record=rec, roofline=row))
    return rows


def ls_train(torch, dev, mesh) -> dict:
    """LS_STEPS steps of ``launch/train.py --mesh debug`` at its defaults
    (batch 8 x 128, seed 0) with qwen3-1.7b's loghd head (the config the
    CLI reads is patched to ``lm_config()``), against the same steps
    without the mesh (``train_losses``): losses, each step's wall and
    loghd_head launches, peak allocated bytes."""
    import repro_torch.configs as configs
    from repro_torch.kernels import common
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import train_loop
    cfg = lm_config()
    torch.cuda.empty_cache()
    flat = train_losses(torch, dev, cfg, steps=LS_STEPS)
    flat = {k: flat[k] for k in ("losses", "walls", "per_step", "peak")}
    torch.cuda.empty_cache()
    walls, per_step = [], []
    real_make, real_get = train_loop.make_train_step, configs.get_config

    def timed_make(*args, **kw):
        step_fn = real_make(*args, **kw)

        def step(*a):
            before = common.launches["loghd_head"]
            t0 = time.perf_counter()
            out = step_fn(*a)
            out[2].item()
            walls.append(time.perf_counter() - t0)
            per_step.append(common.launches["loghd_head"] - before)
            return out
        return step

    shutil.rmtree(LS_CKPT_DIR, ignore_errors=True)
    train_loop.make_train_step = timed_make
    configs.get_config = lambda name, **kw: (
        cfg if name == LM_ARCH else real_get(name, **kw))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.perf_counter()
        out = train_cli.main(["--arch", LM_ARCH, "--steps", str(LS_STEPS),
                              "--mesh", "debug", "--ckpt-dir",
                              str(LS_CKPT_DIR), "--ckpt-every", "1000"])
        wall = time.perf_counter() - t0
        launches = dict(common.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        train_loop.make_train_step = real_make
        configs.get_config = real_get
    placed = out["params"].embed.table
    check(shd_mesh_names(placed) == ("data", "model"),
          f"the CLI's model is not on the debug mesh: {type(placed)}")
    flash = flash_train_launches(out["params"], cfg, LS_STEPS, LT_SEQ)
    del out["params"]
    written = dir_bytes(LS_CKPT_DIR)
    shutil.rmtree(LS_CKPT_DIR)
    torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(out["losses"], flat["losses"]))
    log(f"LM sharded train {cfg.name} head {cfg.head} on the debug mesh "
        f"{mesh.shape} ({LS_STEPS} steps of launch/train.py --mesh debug, "
        f"batch {LT_BATCH} x {LT_SEQ}): losses "
        + " ".join(f"{x:.5f}" for x in out["losses"])
        + " against " + " ".join(f"{x:.5f}" for x in flat["losses"])
        + f" without the mesh (max diff {diff:.3e}, bound {LT_PLAIN_ATOL}); "
        f"step walls " + " ".join(f"{w * 1e3:.1f}" for w in walls)
        + " ms against " + " ".join(f"{w * 1e3:.1f}" for w in flat["walls"])
        + f" ms; peak allocated {peak} B against {flat['peak']} B; "
        f"loghd_head a step {per_step}; the CLI took {wall:.2f} s with its "
        f"{written} B checkpoint; launches {launches}")
    check(diff <= LT_PLAIN_ATOL, f"sharded losses {out['losses']} against "
          f"{flat['losses']}")
    check(per_step == [1] * LS_STEPS, f"loghd_head launches a sharded "
          f"step: {per_step}")
    check(lm_launches(launches, flash, "sharded training")
          == {"loghd_head": LS_STEPS}, f"kernels launched on the "
          f"sharded training path: {launches}")
    return dict(losses=out["losses"], flat_losses=flat["losses"],
                walls=walls, flat_walls=flat["walls"], peak=peak,
                flat_peak=flat["peak"], launches=launches, diff=diff,
                cli_s=wall, ckpt_bytes=written)


def shd_mesh_names(t) -> tuple:
    from repro_torch.models import sharding as shd
    return tuple(t.device_mesh.mesh_dim_names) if shd.is_dtensor(t) else ()


def ls_serve(torch, dev, mesh) -> dict:
    """The serving CLI's traffic (``launch/serve.py``'s requests, 4 slots,
    16 new tokens) through ``decode_step`` with and without the mesh on
    one bf16 qwen3-1.7b (loghd head), laid on the mesh between the runs:
    the same tokens, one loghd_head launch a decode step, and a decode
    step's median wall each way."""
    import numpy as np
    from repro_torch.kernels import common
    from repro_torch.launch.serve import requests_for
    from repro_torch.models import model as M
    from repro_torch.models import sharding as shd
    from repro_torch.runtime import serve_loop
    cfg = lm_config()
    model = M.init_params(cfg, seed=0, device=dev)
    reqs = requests_for(cfg, 6, seed=0)
    serve = serve_loop.ServeLoopConfig(batch_slots=4, max_new_tokens=16,
                                       max_len=256)
    g = torch.Generator(device=dev).manual_seed(11)
    tok = torch.randint(0, cfg.vocab, (4, 1), generator=g, device=dev)
    pos = torch.tensor([5, 9, 17, 33], device=dev)

    def step_wall(use_mesh) -> float:
        state = M.init_decode_state(cfg, 4, 256, device=dev)
        walls = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.decode_step(model, cfg, state, tok, pos, use_mesh)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls[1:]) * 1e3

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = serve_loop.run_serving(cfg, model, reqs, serve)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    flat_ms = step_wall(None)
    shd.shard_model(model, mesh)
    real, steps = serve_loop.decode_step, [0]

    def meshed(params, cfg_, state, tokens, p, *a, **kw):
        steps[0] += 1
        logits, state = real(params, cfg_, state, tokens, p, mesh)
        return logits.full_tensor(), state

    serve_loop.decode_step = meshed
    try:
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        toks = serve_loop.run_serving(cfg, model, reqs, serve)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(common.launches)
    finally:
        serve_loop.decode_step = real
    mesh_ms = step_wall(mesh)
    same = all(np.array_equal(toks[u], flat[u]) for u in flat)
    n_tok = sum(len(v) for v in toks.values())
    log(f"LM sharded serve {cfg.name} bf16 head loghd on the debug mesh: "
        f"{len(toks)} requests, {n_tok} tokens, {steps[0]} decode steps in "
        f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s) against {flat_s:.3f} s "
        f"without the mesh; the same tokens: {same}; a decode step's wall "
        f"(B = 4, median of 10) {mesh_ms:.3f} ms on the mesh against "
        f"{flat_ms:.3f} ms; launches {launches}")
    check(same, "the sharded decode served other tokens than the unsharded")
    check(lm_launches(launches, NO_FLASH, "sharded decode")
          == {"loghd_head": steps[0]}, f"loghd_head launches over "
          f"{steps[0]} sharded decode steps: {launches}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps[0], wall_s=wall,
                flat_wall_s=flat_s, step_ms=mesh_ms, flat_step_ms=flat_ms,
                tokens_per_s=n_tok / wall)


def ls_granite(torch, dev, mesh) -> dict:
    """granite-moe-1b-a400m at full width (bf16, loghd head) decoded
    teacher-forced for LS_EP_STEPS steps at B = 4 through the expert-
    parallel MoE (``moe_block`` on the mesh: the all_to_all to the
    experts' owners and back on the "model" group) against the same steps
    without the mesh, within the loghd head's bf16 bound (LH_TOL)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import model as M
    from repro_torch.models import sharding as shd
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              head="loghd")
    model = M.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    tokens = torch.randint(0, cfg.vocab, (4, LS_EP_STEPS), generator=g,
                           device=dev)

    def run(use_mesh):
        state = M.init_decode_state(cfg, 4, 64, device=dev)
        outs = []
        for t in range(LS_EP_STEPS):
            lg, state = M.decode_step(model, cfg, state,
                                      tokens[:, t:t + 1], t, use_mesh)
            outs.append(shd.full(lg)[:, 0].float())
        torch.cuda.synchronize()
        return torch.stack(outs, 1)

    want = run(None)
    shd.shard_model(model, mesh)
    common.reset_launches()
    got = run(mesh)
    launches = dict(common.launches)
    err = max_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    tol = LH_TOL["bfloat16"]
    log(f"LM sharded decode {cfg.name} (bf16, loghd head, {cfg.n_experts} "
        f"experts over 'model'): {LS_EP_STEPS} steps at B = 4: max_abs_err "
        f"{err:.3e} against the unsharded decode (bound {tol}), argmax "
        f"agrees on {agree:.4f}; launches {launches}")
    check(bool(torch.isfinite(got).all()), "granite EP logits not finite")
    torch.testing.assert_close(got, want, **tol)
    check(lm_launches(launches, NO_FLASH, "EP decode")
          == {"loghd_head": LS_EP_STEPS,
              "moe_slots": LS_EP_STEPS * moe_layers(model)},
          f"loghd_head and moe_slots launches over {LS_EP_STEPS} "
          f"expert-parallel decode steps: {launches}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, agree=agree)


def ls_flash(torch, dev, mesh) -> float:
    """``decode_attention_seqsharded`` at qwen3-1.7b's attention widths
    (16 heads, 8 KV heads of 128, qk-norm) over a float32 cache of
    LS_FLASH_CACHE positions at B = 4, on the mesh's "data" axis, against
    ``Attention.decode`` on a copy of the same cache: max abs error, and
    the two caches equal after the write."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.attention import (Attention, DecodeIndex,
                                              decode_attention_seqsharded)
    from repro_torch.models.layers import rope_table
    from repro_torch.models.model import _mixer_cfg
    cfg = get_config(LM_ARCH)
    acfg = _mixer_cfg(cfg, cfg.pattern[0])
    g = torch.Generator(device=dev).manual_seed(13)
    attn = Attention(acfg, device=dev, dtype=torch.float32)
    attn.init_weights(g)
    shape = (4, LS_FLASH_CACHE, acfg.n_kv_heads, acfg.head_dim)
    cache = {k: torch.randn(shape, generator=g, device=dev) for k in "kv"}
    plain = {k: v.clone() for k, v in cache.items()}
    x = torch.randn((4, 1, acfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        got, _ = decode_attention_seqsharded(attn, x, cache, LS_FLASH_POS,
                                             axis="data", mesh=mesh)
        pos = torch.full((4,), LS_FLASH_POS, device=dev)
        want = attn.decode(x, plain["k"], plain["v"],
                           rope_table(pos[:, None], acfg.head_dim,
                                      acfg.rope_theta),
                           DecodeIndex.of(pos, LS_FLASH_CACHE, False))
    torch.cuda.synchronize()
    err = max_err(got, want)
    same = all(torch.equal(cache[k], plain[k]) for k in "kv")
    log(f"LM flash decode (sequence-sharded over 'data' of "
        f"{mesh.shape['data']}) at {LM_ARCH}'s widths, cache {shape} "
        f"float32, pos {LS_FLASH_POS}: max_abs_err {err:.3e} against the "
        f"plain decode (bound {LS_FLASH_TOL}); caches equal after the "
        f"write: {same}")
    torch.testing.assert_close(got, want, rtol=LS_FLASH_TOL,
                               atol=LS_FLASH_TOL)
    check(same, "the flash decode wrote its cache otherwise")
    return err


def ls_restore(torch, dev, mesh) -> dict:
    """The elastic restore: qwen3-1.7b (loghd head, bf16) at full width cut
    to LS_RESTORE_PERIODS layers trains 2 steps unsharded and writes its
    checkpoint; the run resumes for one step without the mesh and, from a
    copy, on the mesh (the checkpoint laid onto it by
    ``restore_checkpoint(..., shardings=)``).  The resumed runs' own final
    checkpoints are not written (the checkpointer's save is patched out):
    the restore is what is checked.  The first resumed losses agree."""
    import dataclasses
    from repro_torch.kernels import common
    from repro_torch.runtime import train_loop
    cfg = dataclasses.replace(lm_config(), n_periods=LS_RESTORE_PERIODS)
    base = LS_CKPT_DIR.parent / "chip_smoke_restore"
    shutil.rmtree(base, ignore_errors=True)
    loop = dict(total_steps=3, ckpt_every=1000, warmup_steps=10,
                peak_lr=3e-4)
    train_loop.run_training(cfg, loop=train_loop.TrainLoopConfig(
        ckpt_dir=str(base / "flat"), **loop), device=dev, stop_after=2)
    written = dir_bytes(base / "flat")
    shutil.copytree(base / "flat", base / "mesh")
    real = train_loop.AsyncCheckpointer

    class Unsaved(real):
        def save(self, step, tree):
            pass

    train_loop.AsyncCheckpointer = Unsaved
    try:
        flat = train_loop.run_training(cfg, loop=train_loop.TrainLoopConfig(
            ckpt_dir=str(base / "flat"), **loop), device=dev)
        common.reset_launches()
        meshed = train_loop.run_training(
            cfg, mesh=mesh, loop=train_loop.TrainLoopConfig(
                ckpt_dir=str(base / "mesh"), **loop), device=dev)
        launches = dict(common.launches)
    finally:
        train_loop.AsyncCheckpointer = real
    shutil.rmtree(base)
    placed = shd_mesh_names(meshed["params"].embed.table)
    log(f"LM elastic restore {cfg.name} at {cfg.n_layers} layers: a "
        f"{written} B unsharded checkpoint of step 2 resumed at step "
        f"{meshed['first_step']} on the debug mesh ({placed}): loss "
        f"{meshed['losses'][0]:.6f} against {flat['losses'][0]:.6f} "
        f"without the mesh; launches {launches}")
    check(meshed["resumed"] and flat["resumed"]
          and meshed["first_step"] == flat["first_step"] == 2,
          "the elastic restore did not resume at step 2")
    check(placed == ("data", "model"), "the restored model is not sharded")
    check(abs(meshed["losses"][0] - flat["losses"][0])
          <= LT_RESUME_RTOL * abs(flat["losses"][0]),
          f"resumed losses {meshed['losses']} against {flat['losses']}")
    flash = flash_train_launches(meshed["params"], cfg,
                                 len(meshed["losses"]), LT_SEQ)
    check(lm_launches(launches, flash, "restored step")
          == {"loghd_head": 1}, f"kernels launched on the restored "
          f"step: {launches}")
    del meshed, flat
    torch.cuda.empty_cache()
    return dict(launches=launches, bytes=written)


def phase_lm_sharded(torch, dev) -> dict:
    """Slice 13: the LM's multi-device layout on the card, over an NCCL
    group of one rank and ``make_debug_mesh()`` (the ("data", "model")
    mesh of (1, 1)): ``launch/train.py --mesh debug`` (``ls_train``), the
    serving traffic through ``decode_step(..., mesh)`` (``ls_serve``),
    granite-moe's expert-parallel decode (``ls_granite``), the
    sequence-sharded flash decode (``ls_flash``), the elastic restore
    (``ls_restore``), and the dry run of two production-mesh cells in
    processes of their own, started first (``start_dry_runs``).  The
    group is destroyed at the end, whatever happened."""
    import datetime
    import os

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    t_phase = time.perf_counter()
    procs = start_dry_runs()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_debug_mesh(dev)
        check(mesh.axis_names == ("data", "model")
              and mesh.shape == {"data": 1, "model": 1}
              and mesh.device_mesh is not None
              and mesh.device_type == "cuda",
              f"the debug mesh: {mesh}")
        out = {}
        for name, fn in (("train", ls_train), ("serve", ls_serve),
                         ("granite", ls_granite), ("flash", ls_flash),
                         ("restore", ls_restore)):
            t0 = time.perf_counter()
            out[name] = fn(torch, dev, mesh)
            log(f"LM sharded {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
        for *_, proc in procs:
            if proc.poll() is None and sys.exc_info()[0] is not None:
                proc.kill()
    out["dry_run"] = finish_dry_runs(procs, torch.cuda.get_device_name(0))
    phase_s = time.perf_counter() - t_phase
    log(f"slice 13 LM sharded phase: {phase_s:.1f} s (limit "
        f"{LS_PHASE_LIMIT:.0f} s)")
    check(phase_s <= LS_PHASE_LIMIT, f"the sharded phase took {phase_s:.1f} s")
    return out


# ----------------------------------------------------- the four examples --

EXAMPLES_DIR = ROOT / "examples"
# the phase's wall, checks and timings included (36 s on the H100: the
# four runs take 15 s at the JAX examples' sizes, the rest is checks and
# timing)
EX_PHASE_LIMIT = 120.0
EX_LM_STEPS = 60            # the LM example's default --steps


def load_example(name: str):
    """``examples/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, mod, argv: list) -> tuple:
    """``mod.main(argv)`` as a user runs it, counted: every launch count is
    set to 0 just before and read just after.  Returns (result, launches,
    wall s)."""
    from repro_torch.kernels import common
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.launches)
    return out, launches, wall


def counts_equal(acc, correct, n: int) -> bool:
    """An accuracy (or matrix of them) holds the same counts of correct
    labels out of `n` as `correct` (``tests/test_torch_slice.py``'s rule:
    the mean may round count / n an ulp apart)."""
    import numpy as np
    return np.array_equal(np.rint(np.asarray(acc, np.float64) * n),
                          np.rint(np.asarray(correct, np.float64)))


def ex_quickstart(torch, dev) -> dict:
    """``examples/quickstart_torch.py`` at its defaults; its clean
    accuracies against the plain route's labels, its two sweeps against
    the per-point loop of one-point ``corrupted_materialized`` calls and
    the family's predict (equal counts of correct labels)."""
    import numpy as np
    from repro_torch.api import dispatch
    from repro_torch.core.evaluate import trial_seeds
    qs = load_example("quickstart_torch")
    r, launches, wall = run_example(torch, qs, [])
    log(f"example quickstart: {wall:.2f} s, launches {launches}")
    for k in ("hdc_encode", "bundle_update", "bundle_sim", "profile_decode",
              "flip_corrupt"):
        check(launches.get(k, 0) >= 1, f"quickstart launched no {k}")
    check(launches.get("flip_corrupt") == 2,
          f"quickstart: flip_corrupt launched {launches.get('flip_corrupt')} "
          f"times, not once a sweep")
    h, y = r["h_te"], torch.as_tensor(r["y_te"], device=dev)
    n = len(r["y_te"])
    diff = {}
    for name, clf in r["classifiers"].items():
        kern = dispatch.predict_encoded(clf.model, h)
        plain = dispatch.predict_encoded(clf.model, h, use_kernels=False)
        diff[name] = int((kern != plain).sum())
        check(counts_equal(r[f"acc_{name}"], int((plain == y).sum()), n),
              f"quickstart {name}: accuracy {r[f'acc_{name}']} is not the "
              f"plain route's {int((plain == y).sum())} / {n}")
    for name in ("loghd", "sparsehd"):
        model = r["classifiers"][name].model
        q = model.quantized(1)
        rows = trial_seeds(torch.Generator().manual_seed(0), qs.N_TRIALS,
                           len(q.to_dict()) - 1)
        loop = np.zeros((len(qs.P_GRID), qs.N_TRIALS))
        for i, p in enumerate(qs.P_GRID):
            for t in range(qs.N_TRIALS):
                noisy = q.corrupted_materialized(p, rows[t], "hv")
                loop[i, t] = int((noisy.predict_encoded(h) == y).sum())
        check(counts_equal(r[f"sweep_{name}"], loop, n),
              f"quickstart {name}: sweep {r[f'sweep_{name}']} differs from "
              f"the per-point loop {loop / n}")
        check(bool(np.isfinite(r[f"sweep_{name}"]).all()), "sweep finite")
    log(f"example quickstart: accuracies conventional "
        f"{r['acc_conventional']:.4f}, LogHD {r['acc_loghd']:.4f} (n = "
        f"{r['n_bundles']}), SparseHD {r['acc_sparsehd']:.4f}; kernel labels "
        f"differing from plain {diff}; sweeps equal to the per-point loop")
    return dict(result=r, launches=launches, wall=wall,
                differing=diff, module=qs)


def ex_extreme(torch, dev) -> dict:
    """``examples/extreme_classification_torch.py`` at its defaults; both
    models' kernel labels against the plain route's on the 2,048 test
    rows (0 may differ)."""
    from repro_torch.api import dispatch
    xc = load_example("extreme_classification_torch")
    torch.cuda.reset_peak_memory_stats()
    r, launches, wall = run_example(torch, xc, [])
    peak = torch.cuda.max_memory_allocated()
    log(f"example extreme: {wall:.2f} s (encode {r['encode_s']:.3f} s), "
        f"peak {peak} B, launches {launches}")
    for k in ("hdc_encode", "bundle_sim", "profile_decode"):
        check(launches.get(k, 0) >= 1, f"extreme launched no {k}")
    diff = {}
    for name, clf in r["classifiers"].items():
        kern = dispatch.predict_encoded(clf.model, r["h_te"])
        plain = dispatch.predict_encoded(clf.model, r["h_te"],
                                         use_kernels=False)
        diff[name] = int((kern != plain).sum())
        check(diff[name] == 0, f"extreme {name}: {diff[name]} of "
              f"{len(kern)} kernel labels differ from plain")
    log(f"example extreme: conventional {r['conventional_bytes']} B, acc "
        f"{r['acc_conventional']:.4f}, {r['qps_conventional']:.1f} queries/s; "
        f"LogHD n = {r['n_bundles']}, {r['loghd_bytes']} B, acc "
        f"{r['acc_loghd']:.4f}, {r['qps_loghd']:.1f} queries/s; rows "
        f"differing from plain {diff}")
    return dict(result=r, launches=launches, wall=wall,
                differing=diff, peak_bytes=peak)


def ex_train_100m(torch, dev) -> dict:
    """``examples/train_100m_torch.py`` at its defaults: 12 shards of
    4,096 rows at D = 2,048 through ``fused_onlinehd_fit_dp`` on the
    example's own NCCL group of one rank, int8 all-reduce."""
    import math
    import torch.distributed as dist
    t100 = load_example("train_100m_torch")
    r, launches, wall = run_example(torch, t100, [])
    check(not dist.is_initialized(), "train_100m left its group behind")
    check(launches.get("hdc_encode", 0) == 13,
          f"train_100m: hdc_encode launched {launches.get('hdc_encode')} "
          f"times, not once a shard and once for the held-out rows")
    check(r["ranks"] == 1 and r["examples"] == 12 * 4096, "train_100m run")
    check(all(math.isfinite(x["acc"]) for x in r["log"])
          and 0.0 < r["final_acc"] <= 1.0, "train_100m accuracies")
    check(bool(torch.isfinite(r["protos"]).all()), "train_100m protos")
    log(f"example train_100m: {wall:.2f} s, {r['words_per_s']:.1f} words/s, "
        f"superposition acc {r['acc_superposition']:.4f} -> final "
        f"{r['final_acc']:.4f}, log {r['log']}, launches {launches}")
    shard = shard_fit_profile(torch, dev, r["protos"])
    return dict(result={k: v for k, v in r.items() if k != "protos"},
                launches=launches, wall=wall,
                shard_fit=shard)


def shard_fit_profile(torch, dev, protos) -> dict:
    """One shard's fit of the stream (4,096 unit rows at D = 2,048, one
    epoch of 16 global steps of 256, int8 all-reduce) on a group of one
    rank made for it: its wall, its device work and kernels under the
    profiler, and the device's idle share."""
    import datetime
    import torch.distributed as dist
    from repro_torch.api import fit_engine
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.launch.mesh import make_debug_mesh
    g = torch.Generator(device=dev).manual_seed(25)
    h = l2_normalize(torch.randn((4096, protos.shape[1]), generator=g,
                                 device=dev))
    y = torch.randint(0, protos.shape[0], (4096,), generator=g, device=dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_debug_mesh(dev)

        def fit():
            return fit_engine.fused_onlinehd_fit_dp(
                protos, h, y, lr=3e-3, batch_size=256, epochs=1, mesh=mesh,
                compress="int8")
        fit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy, count, top = profile_calls(torch, fit, calls=3)
    finally:
        dist.destroy_process_group()
    idle = 1.0 - busy / wall_ms
    log(f"example train_100m, one shard's fit: wall {wall_ms:.3f} ms, device "
        f"{busy:.4f} ms in {count:.0f} kernels and copies (idle {idle:.4f}); "
        f"largest: {[(round(ms, 4), name[:50]) for ms, _, name in top[:5]]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "device_events": count,
            "idle": idle}


def ex_lm(torch, dev) -> dict:
    """``examples/lm_loghd_head_torch.py`` at its defaults (60 steps a
    head); the loghd run repeated with the head through its plain version:
    both routes' last five losses below loss[0], and the kernel route's
    losses within LT_PLAIN_ATOL of the plain route's."""
    import numpy as np
    from repro_torch.api import dispatch
    from repro_torch.kernels import common
    from repro_torch.kernels.loghd_head import loghd_head_logits_ref
    lm = load_example("lm_loghd_head_torch")
    r, launches, wall = run_example(torch, lm, [])
    check(launches.get("loghd_head") == EX_LM_STEPS and set(launches) == {
        "loghd_head"}, f"LM example launches {launches}: not one loghd_head "
        f"launch a loghd step")
    real = dispatch.loghd_head_autograd
    dispatch.loghd_head_autograd = loghd_head_logits_ref
    common.reset_launches()
    try:
        plain, _ = lm.train(lm.example_config("loghd"), EX_LM_STEPS,
                            device=dev)
    finally:
        dispatch.loghd_head_autograd = real
    check(not common.launches, f"plain-head run launched {common.launches}")
    kern = r["loghd"]["losses"]
    gap = float(np.max(np.abs(np.asarray(kern) - np.asarray(plain))))
    for route, losses in (("kernel", kern), ("plain", plain),
                          ("dense", r["dense"]["losses"])):
        check(bool(np.isfinite(losses).all())
              and np.mean(losses[-5:]) < losses[0],
              f"LM example {route}: loss does not fall: {losses[0]} -> "
              f"{losses[-5:]}")
    check(gap <= LT_PLAIN_ATOL, f"LM example: kernel and plain losses "
          f"{gap:.3e} apart")
    log(f"example lm_loghd_head: {wall:.2f} s; dense {r['dense']['losses'][0]:.4f}"
        f" -> {np.mean(r['dense']['losses'][-5:]):.4f}; loghd {kern[0]:.4f} "
        f"-> {np.mean(kern[-5:]):.4f} (last five {kern[-5:]}); plain head "
        f"{plain[0]:.4f} -> {np.mean(plain[-5:]):.4f}, largest gap {gap:.3e}")
    return dict(result=r, launches=launches, wall=wall,
                plain_losses=plain, plain_gap=gap)


def ex_kernel_checks(torch, dev, ex: dict) -> dict:
    """Each kernel against its plain version at the shapes the examples
    gave it that no earlier phase launched (outside the counted runs), at
    phase_kernels' tolerances; then the timing rows at those shapes."""
    from repro_torch.core.bundling import symbol_targets
    from repro_torch.hdc.conventional import (class_prototypes, l2_normalize,
                                              onlinehd_coefficients)
    from repro_torch.kernels.bundle_sim import (bundle_similarity,
                                                bundle_similarity_ref)
    from repro_torch.kernels.bundle_update import (bundle_update,
                                                   bundle_update_ref)
    from repro_torch.kernels.flip_corrupt import (flip_corrupt_grid,
                                                  flip_corrupt_grid_ref)
    from repro_torch.kernels.hdc_encode import hdc_encode, hdc_encode_plain
    from repro_torch.kernels.loghd_head import (loghd_head_logits,
                                                loghd_head_logits_ref)
    from repro_torch.kernels.profile_decode import (profile_decode_scores,
                                                    profile_decode_scores_ref)
    from repro_torch.precision import full_f32
    tol = TOL["float32"]
    g = torch.Generator(device=dev).manual_seed(24)
    xr = ex["extreme"]["result"]
    h = xr["h_te"].contiguous()
    conv = xr["classifiers"]["conventional"].model
    log_m = xr["classifiers"]["loghd"].model
    ops = {}
    # bundle_sim over the 4,096 prototypes and the 14 bundles
    ops["bs_conv"] = (h, l2_normalize(conv.protos).contiguous())
    ops["bs_log"] = (h, l2_normalize(log_m.bundles).contiguous())
    for key in ("bs_conv", "bs_log"):
        hh, m = ops[key]
        got, want = bundle_similarity(hh, m), bundle_similarity_ref(hh, m)
        torch.cuda.synchronize()
        log(f"bundle_sim     {tuple(hh.shape) + (m.shape[0],)}: max_abs_err "
            f"{max_err(got, want):.3e}")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # profile_decode over the 4,096 profiles of 14 bundles
    acts = bundle_similarity(*ops["bs_log"])
    prof = log_m.profiles.float().contiguous()
    got, want = profile_decode_scores(acts, prof), profile_decode_scores_ref(
        acts, prof)
    torch.cuda.synchronize()
    log(f"profile_decode {tuple(acts.shape) + (prof.shape[0],)}: max_abs_err "
        f"{max_err(got, want):.3e}")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    check(torch.equal(got.argmax(-1), want.argmax(-1)),
          "profile_decode argmax differs from plain")
    # the quickstart's predicts by value: conventional (1,000, 10,000, 26),
    # LogHD (1,000, 10,000, 10) and SparseHD (1,000, 3,846, 26) through
    # bundle_sim, LogHD's profile_decode (1,000, 10, 26), on its own models
    # and test encodings
    qr = ex["quickstart"]["result"]
    qh = qr["h_te"].contiguous()
    qy = torch.as_tensor(qr["y_te"], device=dev).long()
    qclf = qr["classifiers"]
    q_conv, q_log, q_sp = (qclf[n].model for n in ("conventional", "loghd",
                                                   "sparsehd"))
    qh_s = l2_normalize(qh[:, q_sp.keep]).contiguous()
    q_acts = None
    for name, hh, m in (("conventional", qh, q_conv.protos),
                        ("loghd", qh, q_log.bundles),
                        ("sparsehd", qh_s, q_sp.protos)):
        m = l2_normalize(m).contiguous()
        got, want = bundle_similarity(hh, m), bundle_similarity_ref(hh, m)
        torch.cuda.synchronize()
        log(f"bundle_sim     quickstart {name} "
            f"{tuple(hh.shape) + (m.shape[0],)}: max_abs_err "
            f"{max_err(got, want):.3e}")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        if name == "loghd":
            q_acts = got
    q_prof = q_log.profiles.float().contiguous()
    got = profile_decode_scores(q_acts, q_prof)
    want = profile_decode_scores_ref(q_acts, q_prof)
    torch.cuda.synchronize()
    log(f"profile_decode quickstart {tuple(q_acts.shape) + (q_prof.shape[0],)}"
        f": max_abs_err {max_err(got, want):.3e}")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # bundle_update at the quickstart's fits' minibatch steps: LogHD's Eq. 9
    # refinement (n = 10, D = 10,000) on its bundles and SparseHD's OnlineHD
    # retrain (C = 26, D' = 3,846) on the compacted class prototypes it
    # starts from, each on a batch of the quickstart's encodings with the
    # fit's own coefficients and with random ones; bitwise repeatable
    log_cfg, sp_cfg = qclf["loghd"].cfg, qclf["sparsehd"].cfg
    hb = qh[:log_cfg.refine_batch].contiguous()
    tt = symbol_targets(q_log.codebook, log_cfg.k).to(dev)[
        qy[:log_cfg.refine_batch]]
    m_log = q_log.bundles.contiguous()
    m_sp = l2_normalize(class_prototypes(qh, qy, q_sp.protos.shape[0])[
        :, q_sp.keep]).contiguous()
    hb_s = l2_normalize(qh[:sp_cfg.batch_size, q_sp.keep]).contiguous()
    updates = {
        "loghd refine": (m_log, (tt - hb @ m_log.T).contiguous(), hb,
                         log_cfg.lr),
        "sparsehd retrain": (m_sp, onlinehd_coefficients(
            m_sp, hb_s, qy[:sp_cfg.batch_size]).contiguous(), hb_s,
            sp_cfg.lr)}
    for name, (m, c, hh, lr) in list(updates.items()):
        for kind, cc in (("fit", c), ("random", torch.randn(
                c.shape, generator=g, device=dev) * 0.01)):
            got = bundle_update(m, cc, hh, lr)
            again = bundle_update(m, cc, hh, lr)
            want = bundle_update_ref(m, cc, hh, lr)
            torch.cuda.synchronize()
            log(f"bundle_update  quickstart {name} "
                f"{(m.shape[0],) + tuple(hh.shape)} {kind} coefficients "
                f"({int((cc != 0).any(1).sum())} of "
                f"{cc.shape[0]} rows nonzero): max_abs_err "
                f"{max_err(got, want):.3e}")
            check(torch.equal(got, again), f"bundle_update quickstart {name} "
                  f"is not bitwise repeatable")
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # hdc_encode at the extreme example's training batches and the stream's
    enc_in = {}
    for (b, f, d) in ((4096, 256, 8192), (4096, 617, 2048)):
        x, w, bias, center = enc_in[(b, f, d)] = enc_inputs(torch, dev, g, b,
                                                            f, d)
        got = hdc_encode(x, w, bias, center, "cos")
        with full_f32():
            want = hdc_encode_plain(x, w, bias, center, "cos")
        torch.cuda.synchronize()
        log(f"hdc_encode     ({b}, {f}, {d}) cos: max_abs_err "
            f"{max_err(got, want):.3e}")
        check(bool(torch.isclose(got, want, **ENC_TOL).all()),
              f"hdc_encode ({b}, {f}, {d}) outside rtol 2e-4 / atol 2e-5")
    # loghd_head at the LM example's training step: 8 x 128 rows, D = 128,
    # n = 15, V = 2,048, float32, at the LM's scales
    b, d, n, v = 1024, 128, 15, 2048
    hl = torch.randn((b, d), generator=g, device=dev)
    ml = torch.randn((n, d), generator=g, device=dev) / d ** 0.5
    pl = torch.randn((v, n), generator=g, device=dev) * 0.05
    got, want = loghd_head_logits(hl, ml, pl), loghd_head_logits_ref(hl, ml,
                                                                      pl)
    torch.cuda.synchronize()
    log(f"loghd_head     ({b}, {d}, {n}, {v}) float32: max_abs_err "
        f"{max_err(got, want):.3e}")
    torch.testing.assert_close(got, want, **LH_TOL["float32"])
    check(torch.equal(got.argmax(-1), want.argmax(-1)),
          "loghd_head argmax differs from plain")
    # flip_corrupt at the quickstart's sweep chunks: 1-bit "hv" leaves of
    # LogHD and SparseHD, 5 p x 2 trials, bit for bit
    qs = ex["quickstart"]
    qmod = qs["module"]
    fc_models = {name: qs["result"]["classifiers"][name].model
                 for name in ("loghd", "sparsehd")}
    for name, model in fc_models.items():
        leaves, cols, n_leaves = fc_sweep_leaves(model, 1, "hv")
        ps, rows = sweep_points(n_leaves, qmod.P_GRID, qmod.N_TRIALS)
        seeds = [[row[i] for i in cols] for row in rows]
        got = flip_corrupt_grid(leaves, ps, seeds)
        want = flip_corrupt_grid_ref(leaves, ps, seeds)
        torch.cuda.synchronize()
        nd = fc_differing(torch, got, want)
        log(f"flip_corrupt   quickstart {name} 1-bit hv, {len(ps)} points "
            f"x {[list(c.shape) for c, _, _ in leaves]}: {nd} elements "
            f"differ")
        check(nd == 0, f"flip_corrupt quickstart {name}: {nd} elements "
              f"differ from plain")
    return dict(ops=ops, acts=acts, prof=prof, enc_in=enc_in,
                updates=updates, lm_head=(hl, ml, pl), fc_models=fc_models,
                fc_grid=(qmod.P_GRID, qmod.N_TRIALS))


def ex_times(torch, rates: dict, k: dict) -> dict:
    """Timing rows at the examples' new shapes, by kernel: bundle_sim at
    (2,048, 8,192, 4,096) and (2,048, 8,192, 14) beside ``F.normalize(h) @
    m.T``; profile_decode at (2,048, 14, 4,096); hdc_encode at (4,096,
    256, 8,192) and (4,096, 617, 2,048); loghd_head at (1,024, 128, 15,
    2,048) float32; bundle_update at the quickstart's refine (10, 64,
    10,000) and retrain (26, 64, 3,846) steps; flip_corrupt at the
    quickstart's two sweep chunks."""
    rows = collections.defaultdict(list)
    for key in ("bs_conv", "bs_log"):
        hh, m = k["ops"][key]
        rows["bundle_sim"].append(shape_row(
            torch, rates, (hh.shape[0], hh.shape[1], m.shape[0]),
            bs_case(torch, hh, m), ("kernel", "plain", "library")))
    a, p = k["acts"], k["prof"]
    rows["profile_decode"].append(shape_row(
        torch, rates, (a.shape[0], a.shape[1], p.shape[0]),
        pd_case(torch, a, p), ("kernel", "plain", "library")))
    for (b, f, d), (x, w, bias, center) in k["enc_in"].items():
        rows["hdc_encode"].append(shape_row(
            torch, rates, (b, f, d), enc_case(torch, x, w, bias, center),
            ("kernel", "plain", "library", "gemm")))
    for name, (m, c, hh, lr) in k["updates"].items():
        row = shape_row(torch, rates, (m.shape[0], hh.shape[0], hh.shape[1]),
                        update_case(torch, m, c, hh, lr),
                        ("kernel", "plain", "library"))
        row["family"] = f"quickstart {name}"
        rows["bundle_update"].append(row)
    rows["loghd_head"].append(lm_head_row(torch, rates, *k["lm_head"],
                                          tag="LM example "))
    grid, trials = k["fc_grid"]
    for name, model in k["fc_models"].items():
        rows["flip_corrupt"].append(fc_row(
            torch, rates, f"quickstart {name} hv", model, 1, "hv", grid,
            trials))
    for name, rs in rows.items():
        for r in rs:
            r["path"] = "examples"
    return dict(rows)


def phase_examples(torch, dev, rates: dict) -> dict:
    """The four examples (``examples/*_torch.py``) as a user runs them, at
    the JAX examples' sizes, each counted on its own; their checks, the
    kernels at the new shapes against plain, and timing rows there."""
    import os
    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    ex = {}
    for name, fn in (("quickstart", ex_quickstart), ("extreme", ex_extreme),
                     ("train_100m", ex_train_100m), ("lm_loghd_head", ex_lm)):
        ex[name] = fn(torch, dev)
    k = ex_kernel_checks(torch, dev, ex)
    ex["times"] = ex_times(torch, rates, k)
    del k
    for name in ("quickstart", "extreme"):
        ex[name].pop("module", None)
        r = ex[name]["result"]
        for key in ("classifiers", "h_te"):
            r.pop(key, None)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"examples phase: {phase_s:.1f} s (runs "
        + ", ".join(f"{n} {ex[n]['wall']:.1f} s" for n in
                    ("quickstart", "extreme", "train_100m", "lm_loghd_head"))
        + f"; limit {EX_PHASE_LIMIT:.0f} s)")
    check(phase_s <= EX_PHASE_LIMIT, f"the examples phase took {phase_s:.1f} s")
    return ex


def phase_fit_profile(torch, mm: dict) -> dict:
    """Where the LogHD fit's time goes: one Eq. 9 epoch (98 minibatch
    steps) on the host clock and on the device (torch.profiler), the
    device kernels a step runs, and the codebook search on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import fit_engine
    from repro_torch.core import codebook as cb
    loghd = mm["families"]["loghd"]["clf"]
    cfg, model = loghd.cfg, loghd.model
    h, y = mm["h_tr"], mm["y_tr"]
    steps = -(-h.shape[0] // cfg.refine_batch)

    def epoch():
        return fit_engine.fused_refine_bundles(
            model.bundles, h, y, model.codebook, cfg.k, epochs=1, lr=cfg.lr,
            batch_size=cfg.refine_batch, seed=cfg.seed)

    epoch()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    per_step = sum(e.count for e in kern) / steps
    log(f"LogHD refine epoch ({steps} steps): wall {wall_ms:.3f} ms "
        f"(median of 5), device busy {dev_ms:.3f} ms, so the device idles "
        f"{1 - dev_ms / wall_ms:.1%} of the epoch; {per_step:.1f} device "
        f"kernels and copies a step, {wall_ms / steps * 1e3:.1f} us of wall "
        f"a step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    # the host-side codebook search of each LogHD-based fit (numpy)
    hybrid_cfg = mm["families"]["hybrid"]["clf"].cfg.loghd
    book_s = {}
    for c in (cfg, hybrid_cfg):
        t0 = time.perf_counter()
        cb.build_codebook(c.n_classes, c.n_bundles, c.k, alpha=c.alpha,
                          seed=c.seed, method=c.codebook_method)
        book_s[c.n_bundles] = time.perf_counter() - t0
    log("codebook search on the host: " + ", ".join(
        f"n={n} {t:.3f} s" for n, t in book_s.items()))
    return dict(epoch_wall_ms=wall_ms, epoch_device_ms=dev_ms,
                steps=steps, kernels_per_step=per_step, codebook_s=book_s)


def lm_head_row(torch, rates: dict, h, m, p, tag: str = "") -> dict:
    """One ``loghd_head`` timing row on h (B, D), M (n, D), P (V, n):
    the kernel, its plain version and the library form (``h @ M^T``, then
    one ``torch.addmm``), each by CUDA events per eager call and profiler
    device time (the two kernels' durations summed, the score stage's wait
    for A included), the span of a call in a CUDA graph with the score
    stage chained by PDL and without, and the bound (h, M and P read once,
    the float32 logits written once)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.loghd_head import (loghd_head_logits,
                                                loghd_head_logits_ref)
    (b, d), (n, _), v = h.shape, m.shape, p.shape[0]

    def library():
        a = h.float() @ m.float().T
        pf = p.float()
        return torch.addmm(-(a * a).sum(1, keepdim=True) - (pf * pf).sum(1),
                           a, pf.T, alpha=2.0)

    def kernel():
        return loghd_head_logits(h, m, p)
    roles = {"kernel": kernel,
             "plain": lambda: loghd_head_logits_ref(h, m, p),
             "library": library}
    t = {role: (time_ms(torch, fn), device_ms(torch, fn))
         for role, fn in roles.items()}
    copies = 20 if b <= 64 else 4 if b <= 512 else 2
    span = graph_span_ms(torch, kernel, copies=copies)
    with common.pdl(False):
        span_off = graph_span_ms(torch, kernel, copies=copies)
    lib_span = graph_span_ms(torch, library, copies=copies)
    n_bytes = (b * d * h.element_size() + n * d * m.element_size()
               + v * n * p.element_size() + b * v * 4)
    n_ops = 2 * b * d * n + 2 * b * v * n + 2 * v * n + 2 * b * n + 3 * b * v
    b_ms, b_by = bound_ms(rates, n_bytes, n_ops, "float32")
    pname = str(p.dtype).split(".")[1]
    log(f"time loghd_head {tag}({b}, {d}, {n}, {v}) P {pname}: bound "
        f"{b_ms:.5f} ms by {b_by} ({n_bytes} B, {n_ops} flop); span in a "
        f"graph {span:.5f} ms (PDL off {span_off:.5f}, library "
        f"{lib_span:.5f}); CUDA events | profiler device ms: "
        + "; ".join(f"{role} {t[role][0]} | {t[role][1]}" for role in t))
    return dict(shape=[b, d, n, v], p_dtype=pname, ms=t["kernel"][0],
                plain_ms=t["plain"][0], library_ms=t["library"][0],
                device_ms=t["kernel"][1], plain_device_ms=t["plain"][1],
                library_device_ms=t["library"][1], span_ms=span,
                span_no_pdl_ms=span_off, library_span_ms=lib_span,
                bound_ms=b_ms, bound_by=b_by)


def time_lm_head(torch, lm: dict, rates: dict) -> dict:
    """``lm_head_row`` on the served LM's bf16 bundles and bf16 hidden
    states, with its bf16 profiles and their float32 cast, at the decode
    step (B = 4; with bf16 profiles, the row of the kernels line) and at a
    512-row prefill, and with the bf16 profiles at the training step's
    1,024 rows; then at the decode step of each of slice 12's
    architectures (``time_lm_head_archs``)."""
    head = lm["loghd"]["model"].head
    m = head.bundles.detach().contiguous()
    p16 = head.profiles.detach().contiguous()
    g = torch.Generator(device=m.device).manual_seed(5)
    d = m.shape[1]
    rows, first = [], None
    # the decode step and a prefill with bf16 and float32 profiles, and the
    # training step's rows (LT_SHAPE) with the bf16 profiles it trains
    for b, ps in ((4, (p16, p16.float())), (512, (p16, p16.float())),
                  (LT_SHAPE[0], (p16,))):
        h = torch.randn((b, d), generator=g, device=m.device).to(m.dtype)
        for p in ps:
            row = lm_head_row(torch, rates, h, m, p)
            rows.append(row)
            if b == 4 and p is p16:
                first = dict(row)
    first["shapes"] = rows + time_lm_head_archs(torch, rates, m.device)
    return first


def time_lm_head_archs(torch, rates: dict, dev) -> list:
    """``lm_head_row`` at the decode step (B = 4) of each architecture of
    ``LM_ARCHS``, on bf16 h, M and P drawn at the LM's scales (a
    final-normed state, bundles N(0, 1/D), profiles 0.05 N(0, 1)), with
    bf16 profiles and their float32 cast; each row names its
    architecture."""
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for arch, (b, d, n, v) in lm_arch_head_shapes(4):
        h = torch.randn((b, d), generator=g, device=dev).bfloat16()
        m = (torch.randn((n, d), generator=g, device=dev) / d ** 0.5
             ).bfloat16()
        p = (torch.randn((v, n), generator=g, device=dev) * 0.05).bfloat16()
        for pp in (p, p.float()):
            row = lm_head_row(torch, rates, h, m, pp, tag=f"{arch} ")
            row["arch"] = arch
            rows.append(row)
    return rows


def enc_case(torch, x, proj, bias, center) -> dict:
    """hdc_encode's roles on one input: the kernel, its plain version, the
    library form, and cuBLAS's x @ W alone (the product without the cos /
    sin epilogue and the normalisations); its bytes, and its flops in the
    units of its product (3xTF32)."""
    from repro_torch.kernels.hdc_encode import hdc_encode, hdc_encode_plain
    (rows, f), d = x.shape, proj.shape[1]
    return dict(
        kernel=lambda: hdc_encode(x, proj, bias, center, "cos"),
        plain=lambda: hdc_encode_plain(x, proj, bias, center, "cos"),
        library=lambda: torch.cos(torch.addmm(bias, x, proj))
        * torch.sin(x @ proj),
        gemm=lambda: x @ proj,
        bytes=(rows * f + f * d + rows * d + 2 * d) * 4,
        ops=2 * rows * f * d, op_type="tf32x3")


def pd_case(torch, acts, prof) -> dict:
    """profile_decode's roles on one input: the kernel, its plain version,
    the library form (one addmm with the two norms as its bias); its bytes
    and flops."""
    from repro_torch.kernels.profile_decode import (profile_decode_scores,
                                                    profile_decode_scores_ref)
    (b, n), c = acts.shape, prof.shape[0]
    return dict(
        kernel=lambda: profile_decode_scores(acts, prof),
        plain=lambda: profile_decode_scores_ref(acts, prof),
        library=lambda: torch.addmm(
            -(acts * acts).sum(1, keepdim=True) - (prof * prof).sum(1),
            acts, prof.T, alpha=2.0),
        bytes=(b * n + c * n) * acts.element_size() + b * c * 4,
        ops=2 * b * c * n + 2 * (b + c) * n + 2 * b * c, op_type="float32")


def time_chains(torch, main: dict) -> dict:
    """The predict path's chain on slice 1's LogHD model (n = 10 bundles,
    isolet's 26 classes): bundle_sim, then profile_decode as its
    programmatic dependent, at a 64-row serving bucket and the 1,559-row
    batch of test encodings.  Each kernel alone and the pair, as spans in a
    CUDA graph (``graph_span_ms``) and as profiler device time; the pair
    with PDL off.  And this card's floor for a launch: a one-element
    ``add_``, timed by the same two methods."""
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels import common
    from repro_torch.kernels.bundle_sim import bundle_similarity
    from repro_torch.kernels.profile_decode import profile_decode_scores
    model = main["model"]
    m = l2_normalize(model.bundles).contiguous()
    prof = model.profiles.float().contiguous()
    x = torch.zeros(1, device=m.device)
    floor = dict(device_ms=device_ms(torch, lambda: x.add_(1.0)),
                 span_ms=graph_span_ms(torch, lambda: x.add_(1.0)))
    log(f"launch floor (one-element add_): device {floor['device_ms']} ms, "
        f"span in a graph {floor['span_ms']:.5f} ms")
    pairs = []
    for rows in (MAX_BATCH, 1559):
        h = main["h_te"][:rows].contiguous()
        acts = bundle_similarity(h, m)

        def sim(h=h):
            return bundle_similarity(h, m)

        def dec(acts=acts):
            return profile_decode_scores(acts, prof)

        def pair(h=h):
            return profile_decode_scores(bundle_similarity(h, m), prof,
                                         pdl=True)
        row = dict(shape=[rows, m.shape[1], m.shape[0], prof.shape[0]],
                   bundle_sim_span_ms=graph_span_ms(torch, sim),
                   profile_decode_span_ms=graph_span_ms(torch, dec),
                   pair_span_ms=graph_span_ms(torch, pair))
        with common.pdl(False):
            row["pair_span_no_pdl_ms"] = graph_span_ms(torch, pair)
        row["bundle_sim_device_ms"] = device_ms(torch, sim)
        row["profile_decode_device_ms"] = device_ms(torch, dec)
        row["sum_alone_minus_pair_ms"] = (row["bundle_sim_span_ms"]
                                          + row["profile_decode_span_ms"]
                                          - row["pair_span_ms"])
        log(f"time chain bundle_sim -> profile_decode at {rows} rows: "
            + ", ".join(f"{k} {v}" for k, v in row.items()))
        pairs.append(row)
    return {"launch_floor": floor, "pairs": pairs}


def bs_inputs(torch, dev, g, b: int, d: int, n: int):
    """Queries h (B, D) standard normal, unit bundles m (n, D)."""
    from repro_torch.hdc.conventional import l2_normalize
    h = torch.randn((b, d), generator=g, device=dev)
    m = l2_normalize(torch.randn((n, d), generator=g, device=dev))
    return h, m


def bs_case(torch, h, m) -> dict:
    """bundle_sim's roles on one input: the kernel, its plain version, two
    library forms (``F.normalize(h) @ m.T`` and ``(h @ m.T) * rsqrt(||h||^2
    + 1e-12)``); its bytes, and its flops in the units of its product
    (3xTF32 ``mma.sync``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.bundle_sim import (bundle_similarity,
                                                bundle_similarity_ref)
    (b, d), n = h.shape, m.shape[0]
    return dict(
        kernel=lambda: bundle_similarity(h, m),
        plain=lambda: bundle_similarity_ref(h, m),
        library=lambda: F.normalize(h, dim=-1) @ m.T,
        library_rsqrt=lambda: (h @ m.T) * torch.rsqrt(
            (h * h).sum(-1, keepdim=True) + 1e-12),
        bytes=b * d * h.element_size() + n * d * 4 + b * n * 4,
        ops=2 * b * d * n + 2 * b * d, op_type="tf32x3")


def update_inputs(torch, dev, g, n: int, b: int, d: int):
    """Unit bundles m (n, D), small coefficients c (B, n), unit queries h
    (B, D)."""
    from repro_torch.hdc.conventional import l2_normalize
    m = l2_normalize(torch.randn((n, d), generator=g, device=dev))
    c = torch.randn((b, n), generator=g, device=dev) * 0.01
    h = l2_normalize(torch.randn((b, d), generator=g, device=dev))
    return m, c, h


def update_case(torch, m, c, h, lr: float) -> dict:
    """bundle_update's roles on one input, its bytes and flops."""
    import torch.nn.functional as F
    from repro_torch.kernels.bundle_update import (bundle_update,
                                                   bundle_update_ref)
    (n, d), b = m.shape, h.shape[0]
    return dict(
        kernel=lambda: bundle_update(m, c, h, lr),
        plain=lambda: bundle_update_ref(m, c, h, lr),
        library=lambda: F.normalize(torch.addmm(m, c.T, h, alpha=lr),
                                    dim=-1),
        bytes=(2 * n * d + b * d + b * n) * 4,
        ops=2 * n * b * d + 3 * n * d, op_type="float32")


def fc_case(torch, leaves, ps, seeds) -> dict:
    """flip_corrupt's roles on G points x L leaves: the batched launch
    (``kernel``; a checkout without ``flip_corrupt_grid``, the parent,
    makes it the G x L one-point launches), its plain version, the G x L
    one-point launches (``loop``), and no library call: no PyTorch call
    computes the counter hash.  Bytes: the codes read once, G float32
    outputs written; int32 operations: 24 b + 8 a code at a point whose
    threshold hashes, 8 at p = 0 or 1, where the mask needs no hash."""
    from repro_torch.kernels import flip_corrupt as fc
    from repro_torch.kernels.flip_corrupt.ref import flip_threshold
    grid = getattr(fc, "flip_corrupt_grid", None)
    grid_ref = getattr(fc, "flip_corrupt_grid_ref", None)

    def loop():
        return [fc.flip_corrupt(c, s, b, p, row[j])
                for p, row in zip(ps, seeds)
                for j, (c, s, b) in enumerate(leaves)]

    def plain_loop():
        return [fc.flip_corrupt_ref(c, s, p, row[j], bits=b)
                for p, row in zip(ps, seeds)
                for j, (c, s, b) in enumerate(leaves)]
    hashing = sum(0 < flip_threshold(p) < (1 << 24) for p in ps)
    n = sum(c.numel() for c, _, _ in leaves)
    return dict(
        kernel=(lambda: grid(leaves, ps, seeds)) if grid else loop,
        plain=(lambda: grid_ref(leaves, ps, seeds)) if grid_ref
        else plain_loop,
        loop=loop, library=None, batched=grid is not None,
        bytes=n + 4 * len(ps) * n + 4 * len(leaves),
        ops=sum(c.numel() * (24 * b * hashing + 8 * len(ps))
                for c, _, b in leaves),
        op_type="int32")


def fc_launches(fn) -> int:
    """flip_corrupt's launches in one call of `fn`, as its wrapper counts
    them."""
    from repro_torch.kernels import common
    before = common.launches["flip_corrupt"]
    fn()
    return common.launches["flip_corrupt"] - before


def fc_sweep_leaves(model, bits: int, scope: str):
    """The leaves a sweep of `model` at `bits` and `scope` flips, and their
    columns among the model's seeds."""
    from repro_torch.core.faults import fault_skip_set
    from repro_torch.core.quantize import QTensor
    d = {k: v for k, v in model.quantized(bits).to_dict().items()
         if k != "enc"}
    skip = fault_skip_set(scope)
    cols = [i for i, (k, v) in enumerate(d.items())
            if k not in skip and isinstance(v, QTensor)]
    vals = list(d.values())
    return ([(vals[i].codes, vals[i].scale, vals[i].bits) for i in cols],
            cols, len(d))


def fc_row(torch, rates: dict, name: str, model, bits: int,
           scope: str, grid=P_GRID, n_trials: int = N_TRIALS) -> dict:
    """flip_corrupt at one sweep's chunk (`grid` x `n_trials`, by default
    6 p x 3 trials) of `model`: the batched launch, its plain version and
    the chunk's G x L one-point launches (the parent's sweep), as device
    time, CUDA-event ms a call and span in a CUDA graph, beside the
    bound."""
    leaves, cols, n_leaves = fc_sweep_leaves(model, bits, scope)
    ps, rows = sweep_points(n_leaves, grid, n_trials)
    seeds = [[row[i] for i in cols] for row in rows]
    cs = fc_case(torch, leaves, ps, seeds)
    shape = [len(ps)] + [list(c.shape) for c, _, _ in leaves]
    row = shape_row(torch, rates, shape, cs, ("kernel", "plain", "loop"))
    row.update(name=name, bits=bits, points=len(ps),
               codes=sum(c.numel() for c, _, _ in leaves) * len(ps),
               launches=fc_launches(cs["kernel"]),
               loop_launches=fc_launches(cs["loop"]),
               span_ms=graph_span_ms(torch, cs["kernel"]),
               loop_span_ms=graph_span_ms(torch, cs["loop"]),
               library_ms=None)
    log(f"time flip_corrupt {name} {bits}-bit G={len(ps)}: "
        f"{row['launches']} launch(es), span {row['span_ms']:.5f} ms; "
        f"{row['loop_launches']} one-point launches' span "
        f"{row['loop_span_ms']:.5f} ms")
    return row


def shape_row(torch, rates: dict, shape, cs: dict, roles) -> dict:
    """Device ms (torch.profiler) of each role of a case at one shape, the
    kernel's CUDA-event ms per call (host included) beside it, and the
    bound."""
    b_ms, b_by = bound_ms(rates, cs["bytes"], cs["ops"], cs["op_type"])
    row = {"shape": list(shape), "bound_ms": b_ms, "bound_by": b_by,
           "ms": time_ms(torch, cs["kernel"])}
    row.update({f"{role}_device_ms": device_ms(torch, cs[role])
                for role in roles})
    log(f"time {shape} " + ", ".join(f"{k} {v}" for k, v in row.items()
                                     if k != "shape"))
    return row


# hdc_encode's timed batches: one row (a lone request), a service bucket,
# the predict batch
ENC_TIME_ROWS = (1, MAX_BATCH, 1559)
# bundle_sim's timed shapes (B, D, n): the same batches against the LogHD
# (n = 10) and the conventional (n = 26) bundles of isolet, then the
# predict batches of SparseHD (D' = 4,000, C = 26) and hybrid (D' = 5,200,
# n = 20) at budget 0.4
BS_TIME_SHAPES = ([(b, 10000, n) for n in (10, 26) for b in ENC_TIME_ROWS]
                  + [(1559, 4000, 26), (1559, 5200, 20)])


def phase_times(torch, main: dict, mm: dict, lm: dict, rates: dict) -> dict:
    """Kernel, plain and library times at the main paths' shapes."""
    from repro_torch.core.bundling import symbol_targets
    from repro_torch.hdc.conventional import l2_normalize
    from repro_torch.kernels.bundle_sim import bundle_similarity
    model, h = main["model"], main["h_te"].contiguous()
    m = l2_normalize(model.bundles).contiguous()
    acts = bundle_similarity(h, m)
    prof = model.profiles.contiguous()
    q = model.quantized(4).bundles
    b, d = h.shape
    n, c = m.shape[0], prof.shape[0]
    bits = q.bits
    # one Eq. 9 minibatch of the LogHD fit: its bundles, 64 training rows
    # and their activation errors
    lmodel = mm["families"]["loghd"]["clf"].model
    mu = lmodel.bundles.contiguous()
    hu = mm["h_tr"][:64].contiguous()
    cu = (symbol_targets(lmodel.codebook, 2)[mm["y_tr"][:64]]
          - hu @ mu.T).contiguous()
    lr = 3e-4

    cases = {
        "bundle_sim": bs_case(torch, h, m),
        "profile_decode": pd_case(torch, acts, prof),
        "flip_corrupt": fc_case(torch, [(q.codes, q.scale, bits)], [0.1],
                                [[7]]),
        "bundle_update": update_case(torch, mu, cu, hu, lr),
    }
    # the encoder of path 1's model on a 64-row service bucket of test rows
    enc = model.enc
    proj, ebias, ecenter = (enc[k].contiguous()
                            for k in ("proj", "bias", "center"))
    x_dev = torch.as_tensor(main["x_te"], device=proj.device)

    def enc_rows(rows: int) -> dict:
        return enc_case(torch, x_dev[:rows].contiguous(), proj, ebias,
                        ecenter)

    cases["hdc_encode"] = enc_rows(MAX_BATCH)
    out = {}
    for name, cs in cases.items():
        t = {}
        for role in ("kernel", "plain", "library"):
            fn = cs[role]
            t[role] = (time_ms(torch, fn), device_ms(torch, fn)) if fn else (
                None, None)
        b_ms, b_by = bound_ms(rates, cs["bytes"], cs["ops"], cs["op_type"])
        out[name] = dict(ms=t["kernel"][0], plain_ms=t["plain"][0],
                         library_ms=t["library"][0],
                         device_ms=t["kernel"][1],
                         plain_device_ms=t["plain"][1],
                         library_device_ms=t["library"][1],
                         bound_ms=b_ms, bound_by=b_by)
        log(f"time {name:<15} bound {b_ms:.5f} ms by {b_by} "
            f"({cs['bytes']} B, {cs['ops']} ops); per call, CUDA events | "
            f"profiler device time: " + "; ".join(
                f"{role} {t[role][0]} | {t[role][1]} ms" for role in t))

    # hdc_encode at each of ENC_TIME_ROWS
    out["hdc_encode"]["shapes"] = [
        shape_row(torch, rates, (rows, proj.shape[0], proj.shape[1]),
                  enc_rows(rows), ("kernel", "plain", "library", "gemm"))
        for rows in ENC_TIME_ROWS]
    # bundle_sim at each of BS_TIME_SHAPES, on random queries and bundles
    g = torch.Generator(device=mu.device).manual_seed(3)
    out["bundle_sim"]["shapes"] = [
        shape_row(torch, rates, shape,
                  bs_case(torch, *bs_inputs(torch, mu.device, g, *shape)),
                  ("kernel", "plain", "library", "library_rsqrt"))
        for shape in BS_TIME_SHAPES]
    # bundle_update at each matched-memory family's minibatch (the (n, B, D)
    # its fit ran most), on random bundles, coefficients and queries
    fam_rows = []
    for fam, r in mm["families"].items():
        shape, _ = r["update_shapes"].most_common(1)[0]
        cs = update_case(torch, *update_inputs(torch, mu.device, g, *shape),
                         lr)
        row = shape_row(torch, rates, shape, cs,
                        ("kernel", "plain", "library"))
        row["family"] = fam
        fam_rows.append(row)
    out["bundle_update"]["shapes"] = fam_rows
    # profile_decode at each of PD_SHAPES, on random activations and
    # profiles, with the span of a call in a graph beside its device time
    pd_rows = []
    for (b, n, c) in PD_SHAPES:
        cs = pd_case(torch, torch.randn((b, n), generator=g, device=mu.device),
                     torch.randn((c, n), generator=g, device=mu.device))
        row = shape_row(torch, rates, (b, n, c), cs,
                        ("kernel", "plain", "library"))
        row["span_ms"] = graph_span_ms(torch, cs["kernel"])
        pd_rows.append(row)
    out["profile_decode"]["shapes"] = pd_rows
    out["profile_decode"]["chains"] = time_chains(torch, main)
    # flip_corrupt at the chunks of the sweeps: LogHD "all" at 1 and 4 bits
    # (bundles and profiles) and conventional "hv" at 1 bit (prototypes),
    # each 6 p x 3 trials = 18 points with the sweeps' seeds
    conv = mm["families"]["conventional"]["clf"].model
    out["flip_corrupt"]["shapes"] = [
        fc_row(torch, rates, "loghd all", model, 1, "all"),
        fc_row(torch, rates, "loghd all", model, 4, "all"),
        fc_row(torch, rates, "conventional hv", conv, 1, "hv")]
    out["loghd_head"] = time_lm_head(torch, lm, rates)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, capability "
        f"{torch.cuda.get_device_capability(0)}")
    build_s = _build.build_all()
    log(f"kernel build: {build_s:.2f} s for {_build.kernel_names()}")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    rates = card_rates(kind)

    errs = phase_kernels(torch, dev)
    errs["moe_slots"], moe_times = phase_moe_slots(torch, dev, rates)
    errs["flash_attn"], fa_times = phase_flash_attn(torch, dev, rates)
    errs["loghd_head"] = phase_lm_kernel(torch, dev)
    arch_head_errs = phase_lm_arch_kernels(torch, dev)
    main_run = phase_main_path(torch, dev)
    mm = phase_matched_memory(torch, dev)
    t0 = time.perf_counter()
    zoo = phase_fault_zoo(torch, dev, mm)
    log(f"fault zoo phase, checks included: {time.perf_counter() - t0:.2f} s")
    extreme = phase_extreme(torch, dev, smi)
    serve = phase_serving(torch, dev, main_run, mm)
    phase_fit_profile(torch, mm)
    lm = phase_lm(torch, dev)
    lm_train = phase_lm_train(torch, dev)
    lm_archs = phase_lm_archs(torch, dev)
    lm_sharded = phase_lm_sharded(torch, dev)
    examples = phase_examples(torch, dev, rates)
    times = phase_times(torch, main_run, mm, lm, rates)
    times["moe_slots"] = moe_times
    times["flash_attn"] = fa_times
    # the kernels at the examples' shapes beside the earlier rows
    for name, rows in examples["times"].items():
        times[name].setdefault("shapes", []).extend(rows)

    # launches of every path's run: slice 1's LogHD path, the shared
    # encoder and each family's fit -> predict -> sweep of the
    # matched-memory phase, the serving phase, and the LM's serving runs
    # under each head
    by_path = {"loghd_refine_off": main_run["launches"],
               "matched_memory_encoder": mm["enc_launches"]}
    by_path.update({f"matched_memory_{name}": r["launches"]
                    for name, r in mm["families"].items()})
    by_path["fault_zoo"] = zoo["launches"]
    by_path["extreme"] = extreme["launches"]
    by_path["serve"] = serve["launches"]
    by_path.update({f"lm_serve_{head}": lm[head]["launches"]
                    for head in ("loghd", "dense")})
    # the LM training runs: LT_STEPS steps under each head, the chunked-CE
    # step, and the entry point's runs (run_training, restart)
    by_path.update({f"lm_train_{head}": lm_train[head]["launches"]
                    for head in ("loghd", "dense")})
    by_path["lm_train_chunked"] = lm_train["chunked"]["launches"]
    by_path["lm_train_run_training"] = dict(collections.Counter(
        lm_train["entry"]["launches"])
        + collections.Counter(lm_train["restart"]["launches"]))
    # slice 12's architectures: serving under each head, granite's training
    for arch, r in lm_archs.items():
        by_path.update({f"lm_serve_{arch}_{head}": r[head]["launches"]
                        for head in ("loghd", "dense") if head in r})
        if "train" in r:
            by_path[f"lm_train_{arch}"] = r["train"]["launches"]
    # slice 13's sharded paths on the debug mesh: the training CLI, the
    # serving traffic, granite-moe's expert-parallel decode, the restored
    # step
    by_path.update({f"lm_sharded_{name}": lm_sharded[name]["launches"]
                    for name in ("train", "serve", "granite", "restore")})
    # the four examples, each run as a user runs it
    ex_names = ("quickstart", "extreme", "train_100m", "lm_loghd_head")
    by_path.update({f"example_{name}": examples[name]["launches"]
                    for name in ex_names})
    # the sweeps' walls (one chunk, and the per-point loop, each twice),
    # device work and idle share
    sweeps = {f"loghd_refine_off_{b}bit": w
              for b, w in main_run["sweep_walls"].items()}
    sweeps.update({f"matched_memory_{name}_1bit": r["sweep_walls"]
                   for name, r in mm["families"].items()})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c.get(n, 0) for c in by_path.values()
                            for n in KERNEL_LAUNCHES.get(name, (name,))),
            "launches_by_path": {p: sum(c.get(n, 0) for n in
                                        KERNEL_LAUNCHES.get(name, (name,)))
                                 for p, c in by_path.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            **({"max_abs_err_by_arch": arch_head_errs}
               if name == "loghd_head" else {}),
            **({"max_rel_err": t["max_rel_err"]}
               if "max_rel_err" in t else {}),
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"],
            **({"sweeps": sweeps} if name == "flip_corrupt" else {}),
            **({"shapes": t["shapes"]} if "shapes" in t else {}),
            **({"chains": t["chains"]} if "chains" in t else {})})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's cells cut to sizes a CPU test holds: the same files,
drivers and checks, with smaller widths, fewer rows and steps, and float32
in place of bfloat16.  ``perfbench/test_perfbench_*.py`` drive whole runs
with them through ``harness.run_cell`` on the CPU, where the program takes
its plain versions."""

from __future__ import annotations

from perfbench import harness

CLASSIFY = "isolet-loghd.classify"
TRAIN = "granite-moe-1b-loghd.train-4k"


def classify_cell(root=harness.ROOT) -> harness.Cell:
    cell = harness.resolve_cell(root, CLASSIFY)
    cell.config = dict(cell.config, dim=256, n_train=400, refine_epochs=2)
    cell.traffic = dict(cell.traffic, batch_rows=64, pool_batches=2)
    return cell


def train_cell(root=harness.ROOT) -> harness.Cell:
    cell = harness.resolve_cell(root, TRAIN)
    small = dict(vocab=256, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                 n_periods=2, n_experts=8, top_k=2, moe_d_ff=32,
                 dtype="float32", loss_chunk=64)
    cell.config = dict(cell.config, model=dict(cell.config["model"], **small),
                       program_smoke=True,
                       program_overrides={"head": "loghd", "loss_chunk": 64,
                                          "remat_policy": "full"})
    cell.traffic = dict(cell.traffic, batch=2, seq_len=128)
    return cell

"""The loss's course over the training CLI's first steps, the port against
the JAX package: both start from the reference's initial weights and read
the reference's batches, at the CLI's defaults (global batch 8, seq 128,
AdamW with float32 moments, peak LR 3e-4, warmup 10, the schedule over
100 steps) in the config's own dtype.

The test runs a narrow qwen3 in bfloat16, under both heads, for 20 steps.
The two packages' bf16 matmuls accumulate in different orders, and a
parameter rounded to bf16 the other way moves later losses, so the losses
are held within 5e-3 absolute of the reference's (measured within 9.2e-4),
and the two courses must agree in direction: the mean of the last five
against the first loss.

Run as a script it makes the same comparison at the full width of
qwen3-1.7b (d_model 2,048, vocab 151,936, n = 20 bundles) with its depth
cut, and prints both courses as one JSON object per head (on the CPU;
about 15 GB and 7-13 minutes a head on 8 cores at one layer):

    PYTHONPATH=src python tests/test_torch_lm_loss_course.py --periods 1
"""

import argparse
import dataclasses
import gc
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data.tokens import TokenPipeline as RPipe
from repro.models import model as R
from repro.optim import adamw as RA
from repro.runtime import train_loop as RT
from repro_torch import configs as pconfigs
from repro_torch.models.convert import from_reference, stacked_layers
from repro_torch.optim import adamw as PA
from repro_torch.runtime import train_loop as PT

ARCH = "qwen3-1.7b"
# the training CLI's defaults (launch/train.py)
GLOBAL_BATCH, SEQ_LEN = 8, 128
LOSS_ATOL = 5e-3
NARROW = dict(vocab=4096, d_model=128, n_heads=2, n_kv_heads=2,
              head_dim=64, d_ff=256, n_periods=2, dtype="bfloat16",
              remat_policy="full")


def courses(head: str, steps: int, *, full: bool, **over) -> dict:
    """`steps` training steps of ``ARCH`` under `head` in each package from
    the reference's init (seed 0) on the reference's batches (seed 0):
    {"reference": losses, "port": losses, "seconds": per package}.  `full`
    starts from the full config (else the smoke config); `over` replaces
    its fields.  The packages run one after the other, so that only one
    model is held at a time."""
    get = "get_config" if full else "get_smoke_config"
    rc = dataclasses.replace(getattr(rconfigs, get)(ARCH), head=head, **over)
    pc = dataclasses.replace(getattr(pconfigs, get)(ARCH), head=head, **over)
    rloop, ploop = RT.TrainLoopConfig(), PT.TrainLoopConfig()
    pipe = RPipe(vocab=rc.vocab, seq_len=SEQ_LEN, global_batch=GLOBAL_BATCH,
                 seed=0)
    batches = [{k: np.array(v) for k, v in pipe.batch(s).items()}
               for s in range(steps)]
    params = R.init_params(jax.random.PRNGKey(0), rc)
    init = jax.tree.map(np.asarray, params)
    out = {"reference": [], "port": [], "seconds": {}}

    t0 = time.perf_counter()
    opt = RA.adamw_init(params, RA.AdamWConfig())
    step_fn = jax.jit(RT.make_train_step(rc, RA.AdamWConfig(), rloop, None),
                      donate_argnums=(0, 1))
    for s, b in enumerate(batches):
        params, opt, loss = step_fn(params, opt, b, jnp.asarray(s, jnp.int32))
        out["reference"].append(float(loss))
    out["seconds"]["reference"] = time.perf_counter() - t0
    del params, opt, step_fn
    jax.clear_caches()
    gc.collect()

    t0 = time.perf_counter()
    model = from_reference(init, pc, device="cpu")
    del init
    opt = PA.adamw_init(dict(model.named_parameters()), PA.AdamWConfig(),
                        stacked_layers(model))
    step_fn = PT.make_train_step(pc, PA.AdamWConfig(), ploop)
    for s, b in enumerate(batches):
        _, _, loss = step_fn(model, opt, b, s)
        out["port"].append(loss.item())
    out["seconds"]["port"] = time.perf_counter() - t0
    return out


def _direction(losses: list) -> float:
    """The mean of the last five losses less the first."""
    return float(np.mean(losses[-5:]) - losses[0])


@pytest.mark.parametrize("head", ["loghd", "dense"])
def test_bf16_course_matches_reference(head):
    got = courses(head, 20, full=False, **NARROW)
    ref, port = np.array(got["reference"]), np.array(got["port"])
    assert np.isfinite(port).all() and port.shape == (20,)
    np.testing.assert_allclose(port, ref, rtol=0, atol=LOSS_ATOL)
    assert np.sign(_direction(got["port"])) == np.sign(
        _direction(got["reference"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--periods", type=int, default=1,
                    help="layers kept of the config's 28")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--heads", default="loghd,dense")
    args = ap.parse_args()
    torch.set_num_threads(max(1, torch.get_num_threads()))
    for head in args.heads.split(","):
        got = courses(head, args.steps, full=True, n_periods=args.periods)
        ref, port = np.array(got["reference"]), np.array(got["port"])
        print(json.dumps({
            "arch": ARCH, "head": head, "n_periods": args.periods,
            "steps": args.steps, "global_batch": GLOBAL_BATCH,
            "seq_len": SEQ_LEN, "reference": got["reference"],
            "port": got["port"],
            "max_abs_diff": float(np.abs(port - ref).max()),
            "direction": {"reference": _direction(got["reference"]),
                          "port": _direction(got["port"])},
            "seconds": got["seconds"]}), flush=True)


if __name__ == "__main__":
    main()

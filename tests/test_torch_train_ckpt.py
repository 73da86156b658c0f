"""Training checkpoints crossing the packages on the CPU: a run of the
JAX package's ``run_training`` stopped after 4 steps resumes in the
port's, and the other way round, with float32 and int8 AdamW moments (the
checkpoint is the reference's ``{"params", "opt"}`` tree).  Losses rtol
1e-5 (matmul order; see ``tests/test_torch_optim.py`` for AdamW)."""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.data.tokens import TokenPipeline as RPipe
from repro.models import model as R
from repro.optim import adamw as RA
from repro.runtime import train_loop as RT
from repro_torch import configs as pconfigs
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.models.convert import (from_reference, stacked_layers,
                                        train_state)
from repro_torch.optim import adamw as PA
from repro_torch.runtime import train_loop as PT

LOSS_RTOL = 1e-5
# the embedding and the ffn output are int8-eligible AdamW leaves, "wo"
# only by its stack of two layers
INT8 = dict(vocab=512, d_model=256, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=128, n_periods=2)


def _cfgs(arch: str, **over):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(pconfigs.get_smoke_config(arch), **over))


def _ref_batches(cfg, global_batch: int, seq_len: int, seed: int = 0):
    pipe = RPipe(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
                 seed=seed)
    return lambda step: {k: np.array(v) for k, v in pipe.batch(step).items()}


def _ref_init(rc, pc, seed: int = 0):
    return from_reference(jax.tree.map(np.asarray, R.init_params(
        jax.random.PRNGKey(seed), rc)), pc, device="cpu")


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_checkpoints_resume_across_packages(moment_dtype, tmp_path):
    """A run stopped after 4 steps in one package resumes in the other.

    float32 moments: the resumed losses reproduce the other package's
    straight 8-step run.  int8 (the config's embedding and ffn output,
    "wo" only by its stack, carry codes and scales): both packages read a
    checkpoint to the same arrays, and the first resumed loss equals the
    writer's straight run's at that step; later steps are not compared,
    because a code one step off (the counted cases of
    ``tests/test_torch_optim.py``) at a second moment near zero moves its
    parameter by up to lr * |mhat| / eps, and the two packages' straight
    int8 runs part from step 5 on."""
    rc, pc = _cfgs("qwen3-1.7b", head="loghd", **INT8)
    kw = dict(total_steps=8, ckpt_every=100, warmup_steps=2, log_every=100)
    ropt, popt = (RA.AdamWConfig(moment_dtype=moment_dtype),
                  PA.AdamWConfig(moment_dtype=moment_dtype))
    batches = _ref_batches(rc, 2, 16)

    def ref(name, **extra):
        return RT.run_training(rc, loop=RT.TrainLoopConfig(
            ckpt_dir=str(tmp_path / name), **kw), opt_cfg=ropt,
            global_batch=2, seq_len=16, **extra)

    def port(name, **extra):
        return PT.run_training(pc, loop=PT.TrainLoopConfig(
            ckpt_dir=str(tmp_path / name), **kw), opt_cfg=popt,
            params=_ref_init(rc, pc), batches=batches, **extra)
    straight = ref("straight")["losses"]
    # reference -> port
    ref("r2p", stop_after=4)
    resumed = port("r2p")
    assert resumed["resumed"] and resumed["first_step"] == 4
    # port -> reference
    first = port("p2r", stop_after=4)
    np.testing.assert_allclose(first["losses"], straight[:4], rtol=LOSS_RTOL)
    written = jax.tree.map(np.asarray, RT.restore_checkpoint(
        str(tmp_path / "p2r"), 4, {"params": R.init_params(
            jax.random.PRNGKey(0), rc), "opt": RA.adamw_init(
            R.init_params(jax.random.PRNGKey(0), rc), ropt)}))
    back = ref("p2r")
    assert back["resumed"] and back["first_step"] == 4
    if moment_dtype == "float32":
        np.testing.assert_allclose(resumed["losses"], straight[4:],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(back["losses"], straight[4:],
                                   rtol=LOSS_RTOL)
        return
    np.testing.assert_allclose(resumed["losses"][0], straight[4],
                               rtol=LOSS_RTOL)
    own = port("own")["losses"]
    np.testing.assert_allclose(back["losses"][0], own[4], rtol=LOSS_RTOL)
    assert isinstance(written["opt"]["mu"]["embed"]["table"], dict)
    assert isinstance(written["opt"]["nu"]["body"][0]["mlp"]["wo"], dict)
    model = _ref_init(rc, pc)
    state = PA.adamw_init(dict(model.named_parameters()), popt,
                          stacked_layers(model))
    mine = jax.tree.map(lambda t: t.numpy(), restore_checkpoint(
        str(tmp_path / "p2r"), 4, train_state(model, state, spec=True),
        device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(written)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(written)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

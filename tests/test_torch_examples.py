"""The port's four examples (``examples/*_torch.py``) against the JAX
package's on the CPU: each ``main()`` at a small size returns the fields
the reference example prints, and each example's calls, with the
reference's random draws injected, give the reference's results.

  * quickstart: isolet 400 / 200 rows, D = 512, 5 refine and 3 retrain
    epochs, the reference's encoder draws and refinement orders injected:
    labels and accuracies equal; the two 1-bit sweeps, with the reference's
    per-leaf seeds of ``PRNGKey(0)``, give the counts of correct labels of
    a loop over the reference's kernel-path corruption
    (``tests/test_torch_slice.py``'s rule);
  * extreme classification at C = 64, D = 512: conventional and
    LogHD-stratified labels equal;
  * the 100M-word stream at 2 shards x 256 rows, D = 256: the prototypes
    against the reference's ``fused_onlinehd_fit_dp`` at the int8 bound of
    ``tests/test_torch_distributed.py``;
  * the LM head example at its own widths: 10 steps under each head from
    the reference's weights and batches, losses within LM_RTOL; 60 steps
    of the port's own, the loghd head's last five losses below loss[0].
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401 (a fixture)

import repro.api.dispatch as jdispatch
import repro.hdc.conventional as jconv
from repro.api import fit_engine as jfit
from repro.api import make_classifier as jax_make_classifier
from repro.core.evaluate import trial_keys
from repro.data.synth import load_dataset as jax_load_dataset
from repro.hdc import encoders as jenc
from repro_torch.api import dispatch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SRC = ROOT / "src"
NAMES = ("quickstart_torch", "extreme_classification_torch",
         "train_100m_torch", "lm_loghd_head_torch")
QS = dict(max_train=400, max_test=200, dim=512, refine_epochs=5,
          retrain_epochs=3)
QS_ARGS = ["--device", "cpu", "--max-train", "400", "--max-test", "200",
           "--dim", "512", "--refine-epochs", "5", "--retrain-epochs", "3"]
XC_ARGS = ["--device", "cpu", "--classes", "64", "--dim", "512"]
T100_ARGS = ["--device", "cpu", "--shards", "2", "--shard-size", "256",
             "--dim", "256"]
# the LM's losses over 10 steps from the same weights and batches: the
# packages sum their matmuls in other orders and AdamW's square root
# differs by ulps (tests/test_torch_optim.py), so a parameter moves by an
# ulp a step; measured within 4.4e-7 relative under both heads, held at
# tests/test_torch_lm_train.py's loss bound
LM_RTOL = 1e-5
LM_STEPS = 10

pytestmark = pytest.mark.usefixtures("one_thread")


def _load(name: str):
    """An example file as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.array(x))


def _enc_draws(f: int, d: int):
    """The reference encoder's (proj, bias) for EncoderConfig(f, d)."""
    p = jenc.init_encoder(jenc.EncoderConfig(f, d, "cos"))
    return _t(p["proj"]), _t(p["bias"])


def _ref_perms(seed: int, epochs: int, n: int) -> np.ndarray:
    keys = jax.random.split(jax.random.PRNGKey(seed), epochs)
    return np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])


def _leaf_seeds(key, n_leaves: int) -> list:
    keys = jax.random.split(key, n_leaves)
    return [int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max))
            for k in keys]


def _count(acc, n: int):
    return np.rint(np.asarray(acc, np.float64) * n)


# ------------------------------------------------- the entry points ------

def test_examples_import_neither_jax_nor_repro():
    code = (
        "import importlib.util, sys\n"
        f"for name in {NAMES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, "
        f"{str(EXAMPLES)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", QS_ARGS[2:]),
    ("extreme_classification_torch", XC_ARGS[2:]),
    ("train_100m_torch", T100_ARGS[2:]),
    ("lm_loghd_head_torch", ["--steps", "1"])])
def test_examples_run_on_the_card_by_default(monkeypatch, name, argv):
    """Without --device each example asks for the card, and raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)


def test_quickstart_main_prints_the_reference_fields(capsys):
    out = _load("quickstart_torch").main(QS_ARGS)
    text = capsys.readouterr().out
    assert "dataset: isolet  F=617 C=26 N=400/200  D=512" in text
    assert "  p     LogHD  SparseHD" in text
    assert (out["n_bundles"], out["dim"]) == (10, 512)
    for k in ("acc_conventional", "acc_loghd", "acc_sparsehd"):
        assert 0.5 < out[k] <= 1.0, (k, out[k])
    assert out["memory_fraction"] == pytest.approx(
        (10 * 512 + 26 * 10) / (26 * 512), rel=1e-12)
    assert out["sparsity"] == pytest.approx(1 - 10 / 26)
    for k in ("sweep_loghd", "sweep_sparsehd"):
        assert out[k].shape == (5, 2)
        assert out[k][0, 0] == out[k][0, 1]      # p = 0: no flip
    assert out["sweep_mean_loghd"][-1] < out["sweep_mean_loghd"][0]


def test_extreme_main_prints_the_reference_fields(capsys):
    out = _load("extreme_classification_torch").main(XC_ARGS)
    text = capsys.readouterr().out
    assert "extreme classification: C=64, D=512, train=1536" in text
    assert "LogHD k=2 n=8 (min 6)" in text
    assert out["conventional_bytes"] == 64 * 512 * 4
    assert out["loghd_bytes"] == (8 * 512 + 64 * 8) * 4
    assert out["acc_conventional"] > 0.9 and out["acc_loghd"] > 0.9
    assert out["qps_conventional"] > 0 and out["qps_loghd"] > 0


def test_train_100m_main_prints_the_reference_fields(capsys):
    import torch.distributed as dist
    out = _load("train_100m_torch").main(T100_ARGS)
    text = capsys.readouterr().out
    assert "streaming 2 shards x 256 examples x D=256" in text
    assert "over 1 rank(s), compress=int8" in text
    assert not dist.is_initialized()             # the example's group ended
    assert [r["shard"] for r in out["log"]] == [1]
    assert out["examples"] == 512 and out["words"] == 2 * 256 * 256
    assert out["final_acc"] > 0.5 and out["words_per_s"] > 0


def test_lm_main_loghd_loss_falls_over_60_steps(capsys):
    """The example's 60 steps, the port's own weights and batches: both
    losses fall, the loghd head's last five below its loss[0] (the
    reference on the CPU: 7.718 -> 6.428 on average)."""
    out = _load("lm_loghd_head_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "head=loghd  params=    32.6k" in text
    assert out["dense"]["head_words"] == 128 * 2048
    assert out["loghd"]["head_words"] == 15 * 128 + 2048 * 15
    for head in ("dense", "loghd"):
        losses = out[head]["losses"]
        assert len(losses) == 60 and np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < losses[0] - 0.5, (head, losses)


# ---------------------------------------------------- against the JAX ----

def test_quickstart_matches_reference():
    qs = _load("quickstart_torch")
    x_tr, y_tr, x_te, y_te, spec = jax_load_dataset(
        "isolet", max_train=QS["max_train"], max_test=QS["max_test"])
    c, d = spec.n_classes, QS["dim"]
    # the reference example's calls at this size
    enc_cfg = jenc.EncoderConfig(spec.n_features, d, "cos")
    enc, h_tr = jenc.fit_encoder(enc_cfg, jnp.asarray(x_tr))
    h_te = jenc.encode_batched(enc, jnp.asarray(x_te), "cos")
    protos = jconv.class_prototypes(h_tr, jnp.asarray(y_tr), c)
    shared = dict(prototypes=protos, enc=enc, encoded=h_tr)
    xj, yj = jnp.asarray(x_tr), jnp.asarray(y_tr)
    conv = jax_make_classifier("conventional", c, enc_cfg=enc_cfg).fit(
        xj, yj, **shared)
    log = jax_make_classifier("loghd", c, enc_cfg=enc_cfg, k=2,
                              extra_bundles=5,
                              refine_epochs=QS["refine_epochs"],
                              codebook_method="distance").fit(xj, yj,
                                                              **shared)
    n = log.model.n_bundles
    sp = jax_make_classifier("sparsehd", c, enc_cfg=enc_cfg,
                             sparsity=1 - n / c,
                             retrain_epochs=QS["retrain_epochs"]).fit(
        xj, yj, **shared)
    ref = {"conventional": conv, "loghd": log, "sparsehd": sp}

    # the port's calls, the reference's draws injected
    n_te = len(y_te)
    key = jax.random.PRNGKey(0)
    subs = trial_keys(key, qs.N_TRIALS)
    n_leaves = {name: len(ref[name].model.to_dict()) - 1
                for name in ("loghd", "sparsehd")}
    seeds = {name: [_leaf_seeds(subs[t], n_leaves[name])
                    for t in range(qs.N_TRIALS)] for name in n_leaves}
    proj, bias = _enc_draws(spec.n_features, d)
    got = qs.run(x_tr, y_tr, x_te, y_te, spec, dim=d, device="cpu",
                 refine_epochs=QS["refine_epochs"],
                 retrain_epochs=QS["retrain_epochs"], proj=proj, bias=bias,
                 perms=_ref_perms(0, QS["refine_epochs"], len(y_tr)),
                 seeds=seeds)
    assert got["n_bundles"] == n
    assert got["memory_fraction"] == log.model_bits(32) / conv.model_bits(32)
    assert got["sparsity"] == sp.cfg.sparsity
    for name, clf in ref.items():
        want = np.asarray(clf.predict_encoded(h_te))
        labels = got["classifiers"][name].predict_encoded(got["h_te"])
        np.testing.assert_array_equal(labels.numpy(), want, err_msg=name)
        assert got[f"acc_{name}"] == pytest.approx(
            clf.accuracy(h_te, y_te), abs=0.5 / n_te), name

    # the sweeps: a loop over the reference's kernel-path corruption
    for name in ("loghd", "sparsehd"):
        model = ref[name].model
        jq = model.quantized(1)
        want = np.zeros((len(qs.P_GRID), qs.N_TRIALS))
        for i, p in enumerate(qs.P_GRID):
            for t in range(qs.N_TRIALS):
                noisy = jdispatch.corrupt_materialize(jq, p, subs[t], "hv",
                                                      use_kernel=True)
                labels = type(model).predict_encoded(noisy, h_te)
                want[i, t] = float(jnp.mean(labels == jnp.asarray(y_te)))
        np.testing.assert_array_equal(_count(got[f"sweep_{name}"], n_te),
                                      _count(want, n_te), err_msg=name)


def test_extreme_matches_reference():
    xc = _load("extreme_classification_torch")
    c, d = 64, 512
    x_tr, y_tr, x_te, y_te = xc.make_data(c=c)
    ref_example = _load("extreme_classification")
    for a, b in zip(ref_example.make_data(c=c), (x_tr, y_tr, x_te, y_te)):
        np.testing.assert_array_equal(a, b)
    enc_cfg = jenc.EncoderConfig(x_tr.shape[1], d, "cos")
    enc, h_tr = jenc.fit_encoder(enc_cfg, jnp.asarray(x_tr))
    h_te = jenc.encode_batched(enc, jnp.asarray(x_te), "cos")
    protos = jconv.class_prototypes(h_tr, jnp.asarray(y_tr), c)
    kw = dict(prototypes=protos, enc=enc, encoded=h_tr)
    xj, yj = jnp.asarray(x_tr), jnp.asarray(y_tr)
    ref = {"conventional": jax_make_classifier(
               "conventional", c, enc_cfg=enc_cfg).fit(xj, yj, **kw),
           "loghd": jax_make_classifier(
               "loghd", c, enc_cfg=enc_cfg, k=2, extra_bundles=2,
               refine_epochs=0, codebook_method="stratified").fit(xj, yj,
                                                                  **kw)}
    proj, bias = _enc_draws(x_tr.shape[1], d)
    got = xc.run(x_tr, y_tr, x_te, y_te, c, d, device="cpu", reps=1,
                 proj=proj, bias=bias)
    assert got["n_bundles"] == ref["loghd"].model.n_bundles == 8
    assert got["loghd_bytes"] == ref["loghd"].model.stored_bytes()
    assert got["conventional_bytes"] == ref["conventional"].model.stored_bytes()
    for name, clf in ref.items():
        model = got["classifiers"][name].model
        want = np.asarray(clf.predict_encoded(h_te))
        for use_kernels in (None, False):
            labels = dispatch.predict_encoded(model, got["h_te"], use_kernels)
            np.testing.assert_array_equal(labels.numpy(), want,
                                          err_msg=name)
    np.testing.assert_array_equal(
        got["classifiers"]["loghd"].model.codebook.numpy(),
        np.asarray(ref["loghd"].model.codebook))


def test_train_100m_matches_reference():
    """The stream's prototypes against the reference example's loop
    (``fused_onlinehd_fit_dp`` on one device, int8) on the same shards:
    mean gap at most 1e-6, at most 2 elements beyond 1e-6."""
    from repro.data.synth import DATASETS, _make_split
    from repro.launch.mesh import make_debug_mesh
    t100 = _load("train_100m_torch")
    shards, size, d = 2, 256, 256
    spec = DATASETS["isolet"]
    means = t100.class_means(spec)

    def shard(i, n):
        x, y = _make_split(spec, n, np.random.default_rng(1000 + i), means)
        return jnp.asarray(x), jnp.asarray(y)

    enc_cfg = jenc.EncoderConfig(spec.n_features, d, "cos")
    x0, y0 = shard(0, size)
    enc, h0 = jenc.fit_encoder(enc_cfg, x0)
    protos = jconv.class_prototypes(h0, y0, spec.n_classes)
    x_te, y_te = shard(10_000, 2048)
    h_te = jenc.encode_batched(enc, x_te, "cos")
    acc0 = float(jnp.mean(jnp.argmax(h_te @ protos.T, axis=-1) == y_te))
    mesh = make_debug_mesh()
    for i in range(shards):
        x, y = (x0, y0) if i == 0 else shard(i, size)
        h = h0 if i == 0 else jenc.encode_batched(enc, x, "cos")
        protos = jfit.fused_onlinehd_fit_dp(protos, h, y, lr=3e-3,
                                            batch_size=256, epochs=1,
                                            mesh=mesh, compress="int8")
    want = np.asarray(protos)

    proj, bias = _enc_draws(spec.n_features, d)
    got = t100.main(T100_ARGS, proj=proj, bias=bias)
    assert got["acc_superposition"] == pytest.approx(acc0, abs=0.5 / 2048)
    gap = np.abs(got["protos"].numpy() - want)
    assert gap.mean() <= 1e-6, gap.mean()
    assert int((gap > 1e-6).sum()) <= 2, np.sort(gap.ravel())[-5:]


@pytest.mark.parametrize("head", ["dense", "loghd"])
def test_lm_example_matches_reference(head):
    """10 steps of each package's example loop from the reference's
    initial weights and token batches."""
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.data.tokens import TokenPipeline as RefPipe
    from repro.models.model import init_params as ref_init_params
    from repro_torch.models.convert import from_reference
    lm = _load("lm_loghd_head_torch")
    ref_example = _load("lm_loghd_head")
    pc = lm.example_config(head)
    rc = dataclasses.replace(ref_smoke_config("qwen3-1.7b"), vocab=2048,
                             d_model=128, n_periods=2, head=head,
                             loghd_extra=4)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    want, _ = ref_example.train(rc, LM_STEPS)
    params = ref_init_params(jax.random.PRNGKey(0), rc)
    model = from_reference(jax.tree.map(np.asarray, params), pc,
                           device="cpu")
    pipe = RefPipe(vocab=rc.vocab, seq_len=128, global_batch=8, seed=0)
    got, _ = lm.train(pc, LM_STEPS, device="cpu", params=model,
                      batches=lambda i: {k: np.array(v) for k, v in
                                         pipe.batch(i).items()})
    np.testing.assert_allclose(got, want, rtol=LM_RTOL)
    assert lm.head_words(pc) == ref_example.head_words(rc)


# --------------------------------------------------------------- repairs --

@pytest.mark.parametrize("kind", ["cos", "rp", "rp_sign"])
@pytest.mark.parametrize("bits", [1, 32])
def test_encoder_memory_bits_equal_reference(kind, bits):
    from repro_torch.hdc.encoders import EncoderConfig
    for f, d in ((617, 10_000), (10, 256)):
        want = jenc.EncoderConfig(f, d, kind).memory_bits(bits)
        assert EncoderConfig(f, d, kind).memory_bits(bits) == want
    assert EncoderConfig(617, 10_000, kind).memory_bits() == \
        jenc.EncoderConfig(617, 10_000, kind).memory_bits()

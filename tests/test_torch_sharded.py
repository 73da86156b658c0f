"""The port's class-sharded LogHD estimator (``repro_torch.api.sharded``)
against the JAX package's, in one process on the CPU at F = 24, N = 260,
D = 128.

The reference's fits at S > 1 need 8 devices: they run once, in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(the main process keeps seeing 1 device), and write an ``.npz`` and a
checkpoint.  The port is given the reference's encoder, encodings and
refinement permutations; codebooks are the numpy-seeded "distance" ones,
equal in both packages.
"""

import filecmp
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import load_model as jax_load_model
from repro.api.sharded import ShardedLogHDModel as JaxSharded
from repro.core import codebook as jcb
from repro_torch.api import (ShardedLogHDModel, dispatch, from_reference,
                             load_model, make_classifier, save_model,
                             shard_loghd_model, to_reference)
from repro_torch.api.sharded import (fit_loghd_sharded, sharded_decode,
                                     sharded_estimate_profiles,
                                     streaming_build_bundles)
from repro_torch.checkpoint.ckpt import AsyncCheckpointer, save_checkpoint
from repro_torch.core import codebook as cb
from repro_torch.core.bundling import build_bundles
from repro_torch.core.profiles import estimate_profiles
from repro_torch.hdc.conventional import class_prototypes, l2_normalize
from repro_torch.hdc.encoders import EncoderConfig

SRC = Path(__file__).resolve().parents[1] / "src"
F, N, D, EPOCHS = 24, 260, 128, 3
CASES = [(c, m) for c in (13, 16) for m in ("l2", "cos")]
SHARDS = (1, 2, 8)
SWEEP_PS = [0.0, 0.1, 0.3]
KW = dict(dim=D, refine_epochs=EPOCHS, codebook_method="distance")

_REFERENCE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.api import save_model
from repro.api import dispatch as jdispatch
from repro.api._impl import fit_loghd_model
from repro.api.sharded import fit_loghd_sharded, shard_loghd_model
from repro.core.evaluate import trial_keys
from repro.core.loghd import LogHDConfig
from repro.hdc.encoders import EncoderConfig, fit_encoder
out_path, ckpt_dir = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0)
F, N, D, EPOCHS = {F}, {N}, {D}, {EPOCHS}
out = {{}}
for C in (13, 16):
    x = rng.normal(size=(N, F)).astype(np.float32)
    y = rng.integers(0, C, size=N).astype(np.int32)
    ht = rng.normal(size=(37, D)).astype(np.float32)
    enc_cfg = EncoderConfig(F, D, "cos")
    enc, h = fit_encoder(enc_cfg, jnp.asarray(x))
    out[f"x_{{C}}"], out[f"y_{{C}}"], out[f"ht_{{C}}"] = x, y, ht
    out[f"h_{{C}}"] = np.asarray(h)
    for k, v in enc.items():
        out[f"enc_{{C}}_{{k}}"] = np.asarray(v)
    for metric in ("l2", "cos"):
        base = LogHDConfig(n_classes=C, refine_epochs=EPOCHS, metric=metric,
                           codebook_method="distance")
        ref = fit_loghd_model(base, enc_cfg, x, y, enc=enc, encoded=h)
        tag = f"{{C}}_{{metric}}"
        out[f"ref_bundles_{{tag}}"] = np.asarray(ref.bundles)
        out[f"ref_profiles_{{tag}}"] = np.asarray(ref.profiles)
        out[f"ref_codebook_{{tag}}"] = np.asarray(ref.codebook)
        out[f"ref_labels_{{tag}}"] = np.asarray(
            ref.predict_encoded(jnp.asarray(ht)))
        for S in {SHARDS}:
            cfg = dataclasses.replace(base, class_sharding=S)
            sh = fit_loghd_sharded(cfg, enc_cfg, x, y, enc=enc, encoded=h)
            t = f"{{tag}}_{{S}}"
            out[f"bundles_{{t}}"] = np.asarray(sh.bundles)
            out[f"profiles_{{t}}"] = np.asarray(sh.profiles)
            out[f"codebook_{{t}}"] = np.asarray(sh.codebook)
            out[f"labels_{{t}}"] = np.asarray(
                sh.predict_encoded(jnp.asarray(ht)))
            out[f"relaid_{{t}}"] = np.asarray(
                shard_loghd_model(ref, S).predict_encoded(jnp.asarray(ht)))
            out[f"bits_{{t}}"] = np.asarray(
                [sh.model_bits(b) for b in (1, 4, 8)])
            if (C, metric, S) != (13, "l2", 8):
                continue
            save_model(ckpt_dir, 0, sh)
            # the 1-bit sweep, each trial's corruption on the kernel route
            # (the counter hash); on host copies of the leaves, since the
            # interpret-mode kernel rejects class-sharded operands
            q = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                             sh).quantized(1)
            subs = trial_keys(jax.random.PRNGKey(5), 2)
            n_leaves = len(q.to_dict()) - 1
            seeds = [[int(jax.random.randint(k, (), 0,
                                             jnp.iinfo(jnp.int32).max))
                      for k in jax.random.split(subs[t], n_leaves)]
                     for t in range(2)]
            clean = out[f"ref_labels_{{tag}}"]
            counts = np.zeros(({N_PS}, 2), np.int64)
            for i, p in enumerate({SWEEP_PS}):
                for t in range(2):
                    noisy = jdispatch.corrupt_materialize(
                        q, p, subs[t], "all", use_kernel=True)
                    labels = np.asarray(
                        noisy.predict_encoded(jnp.asarray(ht)))
                    counts[i, t] = int((labels == clean).sum())
            out["sweep_counts"] = counts
            out["sweep_seeds"] = np.asarray(seeds)
            out["sweep_codes"] = np.asarray(q.profiles.codes)
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ref")
    script = ("import os\n"
              "os.environ['XLA_FLAGS'] = "
              "'--xla_force_host_platform_device_count=8'\n"
              f"import sys; sys.path.insert(0, {str(SRC)!r})\n"
              + textwrap.dedent(_REFERENCE.format(
                  F=F, N=N, D=D, EPOCHS=EPOCHS, SHARDS=SHARDS,
                  SWEEP_PS=SWEEP_PS, N_PS=len(SWEEP_PS))))
    out = subprocess.run(
        [sys.executable, "-c", script, str(d / "ref.npz"), str(d / "ckpt")],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
    data = dict(np.load(d / "ref.npz"))
    data["ckpt"] = d / "ckpt"
    return data


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ref_perms(seed: int, epochs: int, n: int) -> np.ndarray:
    """The reference's refinement orders (``fused_refine_bundles``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), epochs)
    return np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])


def _enc_arrays(ref, c: int) -> dict:
    pre = f"enc_{c}_"
    return {k[len(pre):]: v for k, v in ref.items()
            if isinstance(k, str) and k.startswith(pre)}


def _enc(ref, c: int) -> dict:
    return {k: _t(v) for k, v in _enc_arrays(ref, c).items()}


def _port_fit(ref, c: int, metric: str, s: int):
    """The port's sharded fit on the reference's encoder and encodings, with
    the reference's refinement orders."""
    clf = make_classifier("loghd", c, F, device="cpu", metric=metric,
                          class_sharding=s, **KW)
    kw = dict(enc=_enc(ref, c), encoded=_t(ref[f"h_{c}"]),
              perms=_ref_perms(0, EPOCHS, N))
    x, y = ref[f"x_{c}"], ref[f"y_{c}"]
    if s == 1:      # the front door shards only above 1; call it directly
        return fit_loghd_sharded(clf.cfg, clf.enc_cfg, x, y, device="cpu",
                                 **kw)
    return clf.fit(x, y, **kw).model


def _ref_unsharded(ref, c: int, metric: str = "l2"):
    tag = f"{c}_{metric}"
    return from_reference(
        {"enc": _enc_arrays(ref, c),
         "bundles": ref[f"ref_bundles_{tag}"],
         "profiles": ref[f"ref_profiles_{tag}"],
         "codebook": ref[f"ref_codebook_{tag}"]}, device="cpu",
        metric=metric)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("c,metric", CASES)
def test_sharded_fit_matches_reference(ref, c, metric, s):
    """Labels bitwise the reference's sharded fit (and its unsharded fit);
    bundles and profiles within the tolerances of the unsharded fit's
    parity tests; the padded codebook and the accounting equal."""
    m = _port_fit(ref, c, metric, s)
    t = f"{c}_{metric}_{s}"
    assert isinstance(m, ShardedLogHDModel)
    assert (m.class_sharding, m.n_classes_real, m.n_classes) == (s, c, c)
    ht = _t(ref[f"ht_{c}"])
    got = dispatch.predict_encoded(m, ht).numpy()
    np.testing.assert_array_equal(got, ref[f"labels_{t}"])
    np.testing.assert_array_equal(got, ref[f"ref_labels_{c}_{metric}"])
    np.testing.assert_allclose(m.bundles.numpy(), ref[f"bundles_{t}"],
                               rtol=1e-5, atol=1e-6)
    assert m.profiles.shape == ref[f"profiles_{t}"].shape
    np.testing.assert_allclose(m.profiles.numpy(), ref[f"profiles_{t}"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(m.codebook.numpy(), ref[f"codebook_{t}"])
    assert [m.model_bits(b) for b in (1, 4, 8)] == ref[f"bits_{t}"].tolist()


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("c,metric", CASES)
def test_shard_loghd_model_matches_reference(ref, c, metric, s):
    """Re-laying the reference's unsharded model gives the reference's
    re-laid labels, which are its unsharded labels."""
    m = shard_loghd_model(_ref_unsharded(ref, c, metric), s)
    assert m.profiles.shape[0] % s == 0 and m.n_classes == c
    got = m.predict_encoded(_t(ref[f"ht_{c}"])).numpy()
    np.testing.assert_array_equal(got, ref[f"relaid_{c}_{metric}_{s}"])


@pytest.mark.parametrize("c", (13, 16))
def test_gathered_matches_unsharded_reference(ref, c):
    """``gathered()`` drops the padding rows (the reference's own
    ``gathered()`` fails on class-sharded arrays under jax 0.9.0, so it is
    held against the unsharded fit, bitwise equal to the sharded one)."""
    m = _port_fit(ref, c, "l2", 8)
    g = m.gathered()
    assert type(g).__name__ == "LogHDModel" and g.n_classes == c
    np.testing.assert_allclose(g.profiles.numpy(), ref[f"ref_profiles_{c}_l2"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(g.codebook.numpy(),
                                  ref[f"ref_codebook_{c}_l2"])
    ht = _t(ref[f"ht_{c}"])
    np.testing.assert_array_equal(dispatch.predict_encoded(g, ht).numpy(),
                                  ref[f"ref_labels_{c}_l2"])
    # accounting over the real C: padding rows are layout, not model
    assert m.model_bits(8) == g.model_bits(8) == (D + c) * m.n_bundles * 8


@pytest.mark.parametrize("method", ["stratified", "distance", "greedy"])
@pytest.mark.parametrize("c,n", [(13, 5), (40, 7)])
def test_build_codebook_rows_every_range(method, c, n):
    """Every row range equals the whole book's rows; for the numpy-seeded
    methods also the reference's rows (greedy's tie-breaks come from a
    torch generator here, from threefry there)."""
    full = cb.build_codebook(c, n, 2, seed=3, method=method)
    for a in range(c + 1):
        for b in range(a, c + 1):
            rows = cb.build_codebook_rows(c, n, 2, a, b, seed=3,
                                          method=method)
            np.testing.assert_array_equal(rows, full[a:b])
            if method != "greedy":
                np.testing.assert_array_equal(
                    rows, jcb.build_codebook_rows(c, n, 2, a, b, seed=3,
                                                  method=method))
    with pytest.raises(ValueError, match="bad row range"):
        cb.build_codebook_rows(c, n, 2, 3, 2, method=method)


def test_build_codebook_rows_extreme_c():
    """At C = 2^16 ("auto" resolves to stratified) each of 8 shards builds
    its own rows, equal to the reference's."""
    c, n = 1 << 16, 18
    step = c // 8
    for s in range(8):
        rows = cb.build_codebook_rows(c, n, 2, s * step, (s + 1) * step)
        np.testing.assert_array_equal(
            rows, jcb.build_codebook_rows(c, n, 2, s * step, (s + 1) * step))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_bundle_loads_matches_reference(alpha):
    book = cb.build_codebook(26, 7, 3, method="distance", seed=1)
    got = cb.bundle_loads(book, 3, alpha)
    want = np.asarray(jcb.bundle_loads(book, 3, alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_checkpoint_reference_to_port(ref, tmp_path):
    """A reference checkpoint of a sharded model loads in the port with its
    layout; the port writes the same files back, byte for byte."""
    m = load_model(str(ref["ckpt"]), device="cpu")
    assert isinstance(m, ShardedLogHDModel)
    assert (m.class_sharding, m.n_classes_real, m.metric) == (8, 13, "l2")
    np.testing.assert_array_equal(m.profiles.numpy(), ref["profiles_13_l2_8"])
    np.testing.assert_array_equal(m.bundles.numpy(), ref["bundles_13_l2_8"])
    np.testing.assert_array_equal(
        m.predict_encoded(_t(ref["ht_13"])).numpy(), ref["labels_13_l2_8"])
    save_model(str(tmp_path), 0, m)
    da, db = ref["ckpt"] / "step_000000000", tmp_path / "step_000000000"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for f in os.listdir(da):
        assert filecmp.cmp(da / f, db / f, shallow=False), f


@pytest.mark.parametrize("bits", [None, 4])
def test_checkpoint_port_to_reference(ref, tmp_path, bits):
    """The port's sharded model, saved, loads in the reference as its
    ``ShardedLogHDModel`` with the padded rows and both aux fields."""
    m = _port_fit(ref, 13, "l2", 8)
    if bits is not None:
        m = m.quantized(bits)
    save_model(str(tmp_path), 3, m)
    jm = jax_load_model(str(tmp_path))
    assert isinstance(jm, JaxSharded)
    assert (jm.class_sharding, jm.n_classes_real, jm.metric) == (8, 13, "l2")
    want = to_reference(m)
    got = {k: v for k, v in jm.to_dict().items() if k != "enc"}
    for k, v in got.items():
        if bits is not None and k in ("bundles", "profiles"):
            np.testing.assert_array_equal(np.asarray(v.codes), want[k][0])
            np.testing.assert_array_equal(np.asarray(v.scale), want[k][1])
        else:
            np.testing.assert_array_equal(np.asarray(v), want[k])
    assert np.asarray(jm.profiles.codes if bits else jm.profiles).shape == (
        16, m.n_bundles)
    back = load_model(str(tmp_path), device="cpu")
    ht = _t(ref["ht_13"])
    np.testing.assert_array_equal(dispatch.predict_encoded(back, ht).numpy(),
                                  dispatch.predict_encoded(m, ht).numpy())


def test_convert_round_trips_sharded(ref):
    arrays = {"enc": _enc_arrays(ref, 13),
              "bundles": ref["bundles_13_l2_8"],
              "profiles": ref["profiles_13_l2_8"],
              "codebook": ref["codebook_13_l2_8"]}
    m = from_reference(arrays, device="cpu", class_sharding=8,
                       n_classes_real=13)
    assert isinstance(m, ShardedLogHDModel) and m.n_classes == 13
    back = to_reference(m)
    for k in ("bundles", "profiles", "codebook"):
        np.testing.assert_array_equal(back[k], arrays[k])
    with pytest.raises(ValueError, match="class_sharding applies to LogHD"):
        from_reference({**arrays, "keep": np.arange(4)}, device="cpu",
                       class_sharding=2)


def test_sharded_sweep_matches_reference(ref):
    """The 1-bit sweep of the sharded model (padded rows among the stored
    leaves, as in the reference), with the reference's per-leaf seeds: the
    same codes and the same counts of correct labels at every point."""
    m = load_model(str(ref["ckpt"]), device="cpu")
    q = m.quantized(1)
    np.testing.assert_array_equal(q.profiles.codes.numpy(), ref["sweep_codes"])
    seeds = [list(map(int, row)) for row in ref["sweep_seeds"]]
    clean = ref["ref_labels_13_l2"]
    accs = m.sweep_under_flips(1, SWEEP_PS, _t(ref["ht_13"]), clean,
                               n_trials=2, seeds=seeds,
                               predict_encoded=dispatch.predict_encoded)
    np.testing.assert_array_equal(np.rint(accs * len(clean)),
                                  ref["sweep_counts"])


# ------------------------------------------------------------ within port --

def _unit(rng, n, d):
    h = rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(h / np.linalg.norm(h, axis=1, keepdims=True))


@pytest.mark.parametrize("bipolar", [False, True])
def test_streaming_bundles_single_block_bitwise(bipolar):
    rng = np.random.default_rng(0)
    h, y = _unit(rng, 200, 64), torch.from_numpy(rng.integers(0, 30, 200))
    book = cb.build_codebook(30, 6, 2, method="distance")
    want = build_bundles(class_prototypes(h, y, 30), book, 2, bipolar=bipolar)
    assert torch.equal(streaming_build_bundles(h, y, book, 2,
                                               bipolar=bipolar), want)


@pytest.mark.parametrize("block", [7, 64, 999])
def test_streaming_bundles_many_blocks_close(block):
    rng = np.random.default_rng(1)
    h, y = _unit(rng, 300, 64), torch.from_numpy(rng.integers(0, 1000, 300))
    book = cb.build_codebook(1000, 12, 2, method="stratified")
    got = streaming_build_bundles(h, y, book, 2, block=block)
    want = build_bundles(class_prototypes(h, y, 1000), book, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 8])
def test_sharded_profiles_bitwise(s):
    rng = np.random.default_rng(2)
    c = 13
    h, y = _unit(rng, 260, 64), torch.from_numpy(rng.integers(0, c, 260))
    m = l2_normalize(torch.from_numpy(
        rng.standard_normal((6, 64)).astype(np.float32)))
    got = sharded_estimate_profiles(m, h, y, c, s)
    want = estimate_profiles(m, h, y, c)
    assert got.shape == (-(-c // s) * s, 6)
    assert torch.equal(got[:c], want)
    assert not got[c:].any()


@pytest.mark.parametrize("s", [2, 4, 8])
def test_exact_ties_resolve_to_lowest_index(s):
    """Rows equal across a block boundary score equal: the lowest global
    row wins, as ``torch.argmax`` over the full scores gives it."""
    c, n = 16, 4
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((c, n)).astype(np.float32))
    c_loc = c // s
    p[c_loc] = p[c_loc - 1]               # last row of block 0, first of 1
    p[c - 1] = p[0]                       # the first and the last rows
    acts = torch.cat([p[[c_loc - 1, 0, c_loc]], torch.from_numpy(
        rng.standard_normal((5, n)).astype(np.float32))])
    for metric in ("l2", "cos"):
        got = sharded_decode(p, acts, n_shards=s, n_classes=c, metric=metric)
        if metric == "l2":
            full = 2.0 * acts @ p.T - torch.sum(p * p, dim=-1)
        else:
            full = l2_normalize(acts) @ l2_normalize(p).T
        assert torch.equal(got, torch.argmax(full, dim=-1))
        assert got[:3].tolist() == [c_loc - 1, 0, c_loc - 1]


def test_padding_rows_never_win():
    p = torch.zeros((8, 2))
    p[:3] = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    acts = torch.tensor([[-5.0, -5.0]])   # a zero padding row would be nearest
    assert sharded_decode(p, acts, n_shards=4, n_classes=3).tolist() == [0]


def test_maha_raises():
    x = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    y = np.arange(20) % 3
    clf = make_classifier("loghd", 3, 6, dim=32, refine_epochs=0,
                          metric="maha", class_sharding=2, device="cpu")
    with pytest.raises(ValueError, match="l2/cos"):
        clf.fit(x, y)
    plain = make_classifier("loghd", 3, 6, dim=32, refine_epochs=0,
                            metric="maha", device="cpu").fit(x, y).model
    with pytest.raises(ValueError, match="l2/cos"):
        shard_loghd_model(plain, 2)
    with pytest.raises(ValueError, match="l2/cos"):
        sharded_decode(torch.zeros((4, 2)), torch.zeros((1, 2)), n_shards=2,
                       n_classes=4, metric="maha")


def test_quantized_sharded_model_decodes_like_gathered(ref):
    m = _port_fit(ref, 16, "l2", 8)
    ht = _t(ref["ht_16"])
    for bits in (1, 4, 8):
        q = m.quantized(bits)
        assert isinstance(q, ShardedLogHDModel)
        g = q.materialized().gathered()
        np.testing.assert_array_equal(
            dispatch.predict_encoded(q, ht).numpy(),
            dispatch.predict_encoded(g, ht).numpy())
    info = m.resident_bytes_per_device()
    assert info["ratio_to_ideal"] == 1.0
    assert info["max_bytes_per_device"] * 8 == info["total_bytes"]
    assert info["bytes_this_rank"] == info["total_bytes"]   # all 8 blocks


def test_async_checkpointer_writes_the_same_files(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16), 7, "x"]}
    save_checkpoint(str(tmp_path / "sync"), 2, tree)
    ac = AsyncCheckpointer(str(tmp_path / "async"))
    ac.save(2, tree)
    tree["a"].add_(100.0)                 # after save(): not in the files
    ac.wait()
    da, db = tmp_path / "sync" / "step_000000002", tmp_path / "async" / \
        "step_000000002"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for f in os.listdir(da):
        assert filecmp.cmp(da / f, db / f, shallow=False), f


def test_async_checkpointer_reraises_writer_error(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ac = AsyncCheckpointer(str(blocker))
    ac.save(0, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                             # the error is raised once


def test_registry_routes_and_encoder_kind():
    x = np.random.default_rng(4).normal(size=(40, 6)).astype(np.float32)
    y = np.arange(40) % 5
    clf = make_classifier("loghd", 5, 6, dim=32, refine_epochs=1,
                          class_sharding=2, data_sharding=2, device="cpu")
    model = clf.fit(x, y, generator=torch.Generator().manual_seed(0)).model
    assert isinstance(model, ShardedLogHDModel)
    assert model.encoder_kind == EncoderConfig(6, 32).kind
    assert clf.with_model(model).predict(x).shape == (40,)

"""Typed-model checkpoints of the port (``repro_torch.api.checkpointing``,
``repro_torch.checkpoint.ckpt``) against the JAX package's: round trips of
all four families at f32 and at 4 and 8 bits, checkpoints written by one
package loading in the other, the on-disk files byte for byte, and the
atomic COMMIT rule.  Models are fitted on a small synthetic set (C=5,
F=12, D=256) from numpy data.
"""

import filecmp
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_classifier as jax_make_classifier
from repro.api.checkpointing import load_model as jax_load_model
from repro.api.checkpointing import save_model as jax_save_model
from repro.checkpoint.ckpt import restore_checkpoint as jax_restore
from repro.core.quantize import QTensor as JaxQTensor
from repro_torch.api import (from_reference, load_model, make_classifier,
                             model_spec, save_model)
from repro_torch.checkpoint import (LeafSpec, latest_step,
                                    read_scalar_leaves, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.quantize import QTensor

C, F, D = 5, 12, 256
METHOD_KW = {
    "conventional": {},
    "sparsehd": dict(sparsity=0.5, retrain_epochs=2),
    "loghd": dict(k=2, extra_bundles=1, refine_epochs=2),
    "hybrid": dict(sparsity=0.5, k=2, extra_bundles=1, refine_epochs=2),
}
BITS = [None, 4, 8]


@functools.lru_cache(maxsize=1)
def _data():
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((C, F)).astype(np.float32)
    y = np.arange(90) % C
    x = (dirs[y] * 2.0
         + rng.standard_normal((len(y), F)).astype(np.float32) * 0.3)
    return x.astype(np.float32), y


@functools.lru_cache(maxsize=None)
def _jax_model(name: str):
    x, y = _data()
    return jax_make_classifier(name, n_classes=C, in_features=F, dim=D,
                               **METHOD_KW[name]).fit(
        jnp.asarray(x), jnp.asarray(y)).model


@functools.lru_cache(maxsize=None)
def _port_model(name: str):
    x, y = _data()
    return make_classifier(name, n_classes=C, in_features=F, dim=D,
                           device="cpu", **METHOD_KW[name]).fit(x, y).model


def _arrays(model) -> dict:
    """A reference model's field dict as numpy (the converter's input)."""
    out = {}
    for k, v in model.to_dict().items():
        if k == "enc":
            out[k] = {a: np.asarray(b) for a, b in v.items()}
        elif isinstance(v, JaxQTensor):
            out[k] = (np.asarray(v.codes), np.asarray(v.scale), v.bits)
        else:
            out[k] = np.asarray(v)
    return out


def _quantized(model, bits):
    return model if bits is None else model.quantized(bits)


def _assert_same_port_models(a, b):
    assert type(a) is type(b) and a.aux() == b.aux()
    da, db = a.to_dict(), b.to_dict()
    assert list(da) == list(db)
    for k, va in da.items():
        vb = db[k]
        if isinstance(va, dict):
            assert list(va) == list(vb)
            for e in va:
                assert torch.equal(va[e], vb[e]) and va[e].dtype == vb[e].dtype
        elif isinstance(va, QTensor):
            assert isinstance(vb, QTensor) and va.bits == vb.bits
            assert torch.equal(va.codes, vb.codes)
            assert va.codes.dtype == vb.codes.dtype == torch.int8
            assert torch.equal(va.scale, vb.scale)
        else:
            assert va.dtype == vb.dtype, k
            assert torch.equal(va, vb), k


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", list(METHOD_KW))
def test_round_trip_each_family(tmp_path, name, bits):
    model = _quantized(_port_model(name), bits)
    path = save_model(str(tmp_path), 7, model)
    assert os.path.basename(path) == "step_000000007"
    back = load_model(str(tmp_path), device="cpu")
    _assert_same_port_models(model, back)
    x, _ = _data()
    assert torch.equal(back.materialized().predict(x),
                       model.materialized().predict(x))


@pytest.mark.parametrize("name", list(METHOD_KW))
def test_reference_checkpoint_loads_in_port(tmp_path, name):
    jm = _jax_model(name)
    jax_save_model(str(tmp_path), 3, jm)
    back = load_model(str(tmp_path), 3, device="cpu")
    want = from_reference(_arrays(jm), device="cpu")
    if hasattr(want, "keep"):        # the port holds keep as int64
        assert back.keep.dtype == torch.int64
        want = want.replace(keep=want.keep.long())
    _assert_same_port_models(back, want)
    x, _ = _data()
    np.testing.assert_array_equal(back.predict(x).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(x))))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", list(METHOD_KW))
def test_port_checkpoint_loads_in_reference(tmp_path, name, bits):
    jm = _quantized(_jax_model(name), bits)
    save_model(str(tmp_path), 5, from_reference(_arrays(jm), device="cpu"))
    back = jax_load_model(str(tmp_path))
    assert type(back) is type(jm)
    want, got = _arrays(jm), _arrays(back)
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, dict):
            for e in v:
                np.testing.assert_array_equal(got[k][e], v[e])
        elif isinstance(v, tuple):
            assert got[k][2] == v[2]
            np.testing.assert_array_equal(got[k][0], v[0])
            np.testing.assert_array_equal(got[k][1], v[1])
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v)
    x, _ = _data()
    np.testing.assert_array_equal(
        np.asarray(back.materialized().predict(jnp.asarray(x))),
        np.asarray(jm.materialized().predict(jnp.asarray(x))))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", list(METHOD_KW))
def test_files_equal_the_references_byte_for_byte(tmp_path, name, bits):
    """The same model written by both packages: the same files, the same
    manifest (leaf order, dtypes, treedef, spec), the same arr_<i>.npy."""
    jm = _quantized(_jax_model(name), bits)
    a, b = tmp_path / "jax", tmp_path / "port"
    jax_save_model(str(a), 1, jm)
    save_model(str(b), 1, from_reference(_arrays(jm), device="cpu"))
    da, db = a / "step_000000001", b / "step_000000001"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for f in os.listdir(da):
        assert filecmp.cmp(da / f, db / f, shallow=False), f


def test_spec_carries_reference_dtypes():
    spec = model_spec(_port_model("hybrid"))
    assert spec["fields"]["keep"]["dtype"] == "int32"
    assert spec["fields"]["codebook"]["dtype"] == "int32"
    assert list(spec["fields"]["enc"]["entries"]) == ["proj", "bias",
                                                       "center"]
    assert spec["aux"] == {"metric": "l2", "encoder_kind": "cos"}
    assert _port_model("hybrid").keep.dtype == torch.int64


def test_uncommitted_checkpoint_is_invisible(tmp_path):
    model = _port_model("conventional")
    save_model(str(tmp_path), 1, model)
    save_model(str(tmp_path), 2, model)
    assert latest_step(str(tmp_path)) == 2
    os.remove(tmp_path / "step_000000002" / "COMMIT")
    os.makedirs(tmp_path / "step_000000009.tmp")      # an interrupted write
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path), 2, device="cpu")
    with pytest.raises(FileNotFoundError):
        read_scalar_leaves(str(tmp_path), 2)
    assert isinstance(load_model(str(tmp_path), device="cpu"),
                      type(model))
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "missing"), device="cpu")


def test_generic_tree_and_bf16_load_in_reference(tmp_path):
    """A plain tree with a bf16 leaf: written as uint16, read back as bf16
    by both packages, bit for bit; leaves numbered in sorted-key order."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    tree = {"w": w.to(torch.bfloat16), "b": torch.arange(3),
            "meta": {"lr": 0.5, "name": "x"}, "none": None}
    save_checkpoint(str(tmp_path), 0, tree)
    target = {"w": LeafSpec((4, 6), "bfloat16"), "b": LeafSpec((3,), "int64"),
              "meta": {"lr": 0.0, "name": ""}, "none": None}
    back = restore_checkpoint(str(tmp_path), 0, target, device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(back["b"], tree["b"]) and back["meta"] == tree["meta"]
    assert read_scalar_leaves(str(tmp_path), 0) == [0.5, "x"]
    jtarget = {"w": jnp.zeros((4, 6), jnp.bfloat16), "b": jnp.zeros(3),
               "meta": {"lr": 0.0, "name": ""}, "none": None}
    jback = jax_restore(str(tmp_path), 0, jtarget)
    assert jback["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jback["w"].astype(jnp.float32)),
        back["w"].float().numpy())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(str(tmp_path), 0, {"w": target["w"]},
                           device="cpu")


def test_load_model_defaults_to_cuda(tmp_path, monkeypatch):
    save_model(str(tmp_path), 0, _port_model("conventional"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(tmp_path))


def test_restore_checkpoint_defaults_to_cuda(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), 0, {"w": LeafSpec((3,), "float32")})

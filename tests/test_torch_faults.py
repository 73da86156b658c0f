"""The port's fault-model zoo and the complete ``core.faults`` against the
JAX package, on the CPU.

Bitwise parity runs with the reference's threefry masks injected through a
draw object (``JaxDraw``): each leaf of the port gets the key the
reference's tree walk gives the leaf of the same name (the reference
splits its key over the leaves in sorted-name order, the port takes its
seeds in ``to_dict()`` order), and each model consumes the key as the
reference does (iid and drift one mask; asymmetric, burst and stuck_at
``split(key)``).  The statistical checks of ``tests/test_fault_models.py``
run on the port's own ``torch.Generator`` draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.dispatch as jdispatch
import repro.core.faults as jfaults
import repro.faults as jzoo
from repro.api import make_classifier as jax_make_classifier
from repro.core.quantize import QTensor as JQ
from repro.hdc.encoders import encode_batched as jax_encode_batched
from repro_torch.api import dispatch, from_reference, make_classifier
from repro_torch.core import evaluate as ev
from repro_torch.core import faults
from repro_torch.core.quantize import QTensor, quantize
from repro_torch.faults import (AsymmetricFlip, BurstFlip, DriftFlip,
                                FaultModel, IIDFlip, StuckAt,
                                available_fault_models,
                                get_fault_model_factory, make_fault_model)
from repro_torch.kernels import common

C, F, D = 5, 12, 256
MODELS = ["iid", "asymmetric", "burst", "stuck_at", "drift"]
# a severity each model bites at: a flip / row-hit / stuck rate, drift reads
SEVERITY = {"iid": 0.13, "asymmetric": 0.2, "burst": 0.3, "stuck_at": 0.2,
            "drift": 150.0}
# chi-squared with 4 degrees of freedom: P[> 23.5] ~ 1e-4
CHI2_DF4 = 23.5


# ------------------------------------------------------------- helpers ----

class JaxDraw:
    """A draw that replays the reference's threefry masks: each call takes
    the next key and draws what the reference draws with it, at the
    probability the port computed."""

    def __init__(self, keys):
        self.keys = list(keys)

    def mask(self, p, shape, nbits):
        udtype = (jnp.uint8 if nbits <= 8 else jnp.uint16 if nbits <= 16
                  else jnp.uint32)
        m = np.asarray(jfaults.packed_flip_mask(
            self.keys.pop(0), np.float32(p), shape, nbits, udtype))
        return torch.from_numpy(m.astype(np.uint32).view(np.int32).copy())

    def bernoulli(self, p, shape):
        return torch.from_numpy(np.asarray(jax.random.bernoulli(
            self.keys.pop(0), np.float32(p), shape)).copy())


def model_draw(name: str, key) -> JaxDraw:
    """The draw of one leaf under fault model `name`, from the reference's
    key for that leaf."""
    return JaxDraw([key] if name in ("iid", "drift")
                   else list(jax.random.split(key)))


def ref_leaf_keys(tree: dict, key) -> dict:
    """Leaf name -> the key the reference's ``corrupt_tree`` / ``flip_tree``
    gives it (one split over the leaves in jax's flatten order)."""
    paths = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JQ))[0]
    keys = jax.random.split(key, max(len(paths), 1))
    return {path[-1].key: keys[i] for i, (path, _) in enumerate(paths)}


def port_draws(port_tree: dict, ref_tree: dict, key, name: str) -> list:
    """The port's seed row: one injected draw per leaf, mapped by name."""
    keys = ref_leaf_keys(ref_tree, key)
    return [model_draw(name, keys[k]) for k in port_tree]


def _arrays(model) -> dict:
    out = {}
    for k, v in model.to_dict().items():
        if k == "enc":
            out[k] = {a: np.asarray(b) for a, b in v.items()}
        elif isinstance(v, JQ):
            out[k] = (np.asarray(v.codes), np.asarray(v.scale), v.bits)
        else:
            out[k] = np.asarray(v)
    return out


def trees(model, bits: int):
    """(reference model dict, port model) with the stored leaves at `bits`
    bits: the reference's own quantization up to 8 bits, int16 codes built
    by hand (the same in both packages) above."""
    arrays = _arrays(model.quantized(bits) if bits <= 8 else model)
    if bits > 8:
        qmax = 2 ** (bits - 1) - 1
        for leaf in model.stored_leaves:
            w = arrays[leaf]
            scale = np.float32(np.abs(w).max() / qmax)
            codes = np.clip(np.round(w / scale), -qmax - 1, qmax)
            arrays[leaf] = (codes.astype(np.int16), scale, bits)
    ref = {k: (JQ(jnp.asarray(v[0]), jnp.asarray(v[1]), v[2])
               if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in arrays.items() if k != "enc"}
    return ref, from_reference(arrays, device="cpu")


def stored(model) -> dict:
    return {k: v for k, v in model.to_dict().items() if k != "enc"}


def assert_leaves_equal(got: dict, want: dict):
    """Every leaf of `got` bitwise equal to the reference's leaf of the
    same name (codes, scale and bits of QTensors; float32 bit patterns)."""
    for name, g in got.items():
        w = want[name]
        if isinstance(g, QTensor):
            wide = np.asarray(w.codes).dtype == np.int16
            assert g.bits == w.bits
            assert g.codes.dtype == (torch.int16 if wide else torch.int8)
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes),
                                          err_msg=name)
            assert float(g.scale) == float(w.scale)
        elif g.is_floating_point():
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w).view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@functools.lru_cache(maxsize=4)
def _fitted(name="loghd"):
    """The reference's fitted model (``tests/test_fault_models.py``'s
    fixture), its encodings and labels."""
    key = jax.random.PRNGKey(0)
    dirs = jax.random.normal(key, (C, F))
    y = jnp.arange(C * 24) % C
    x = dirs[y] * 2.0 + jax.random.normal(key, (len(y), F)) * 0.3
    kw = (dict(k=2, extra_bundles=1, refine_epochs=2) if name == "loghd"
          else {})
    clf = jax_make_classifier(name, n_classes=C, in_features=F, dim=D,
                              **kw).fit(x, y)
    h = jax_encode_batched(clf.model.enc, x, clf.enc_cfg.kind)
    return clf.model, np.array(h), np.array(y)


def _port(name="loghd"):
    model, h, y = _fitted(name)
    return from_reference(_arrays(model), device="cpu"), torch.from_numpy(
        h.copy()), y


def _codes(bits=4, shape=(128, 512), seed=9) -> QTensor:
    rng = np.random.default_rng(seed)
    return quantize(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)), bits)


def _words(q: QTensor) -> np.ndarray:
    return q.codes.numpy().astype(np.int64) & ((1 << q.bits) - 1)


def _chi2_binom(k, n, p):
    return (k - n * p) ** 2 / (n * p * (1 - p) + 1e-12)


# --------------------------------------------------------------- registry --

def test_registry_surface():
    assert available_fault_models() == ("asymmetric", "burst", "drift",
                                        "iid", "stuck_at")
    assert available_fault_models() == jzoo.available_fault_models()
    m = make_fault_model("burst", row_size=32, burst_rate=0.25)
    assert isinstance(m, BurstFlip)
    assert m.row_size == 32 and m.burst_rate == 0.25
    assert isinstance(make_fault_model("iid"), IIDFlip)
    with pytest.raises(KeyError, match="asymmetric") as got:
        make_fault_model("nope")
    with pytest.raises(KeyError) as want:
        jzoo.make_fault_model("nope")
    assert str(got.value) == str(want.value)
    assert get_fault_model_factory("drift") is DriftFlip


def test_models_are_hashable():
    assert make_fault_model("asymmetric") == AsymmetricFlip()
    assert hash(StuckAt(stuck0_frac=0.3)) == hash(StuckAt(stuck0_frac=0.3))
    assert BurstFlip(row_size=64) != BurstFlip(row_size=128)
    assert isinstance(IIDFlip(), FaultModel)
    assert [make_fault_model(n).kernel_eligible for n in MODELS] == [
        jzoo.make_fault_model(n).kernel_eligible for n in MODELS]


def test_parameter_validation():
    with pytest.raises(ValueError):
        AsymmetricFlip(p01_scale=-0.1)
    with pytest.raises(ValueError):
        BurstFlip(row_size=0)
    with pytest.raises(ValueError):
        BurstFlip(burst_rate=1.5)
    with pytest.raises(ValueError):
        StuckAt(stuck0_frac=2.0)
    with pytest.raises(ValueError):
        DriftFlip(per_read_p=0.5)


@pytest.mark.parametrize("name", MODELS)
def test_defaults_match_reference(name):
    import dataclasses
    got, want = make_fault_model(name), jzoo.make_fault_model(name)
    assert got.name == want.name == name
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------------- word helpers --

@pytest.mark.parametrize("bits", list(range(1, 17)))
def test_word_helpers_bitwise(bits):
    """codes_to_words and words_to_codes equal the reference's, bit for bit
    (int8 storage up to 8 bits, int16 above), on every b-bit word."""
    rng = np.random.default_rng(bits)
    sdtype = np.int8 if bits <= 8 else np.int16
    lo, hi = (0, 2) if bits == 1 else (-(1 << (bits - 1)), 1 << (bits - 1))
    codes = rng.integers(lo, hi, (37, 21)).astype(sdtype)
    jq = JQ(jnp.asarray(codes), jnp.float32(0.5), bits)
    q = QTensor(torch.from_numpy(codes), torch.tensor(0.5), bits)
    got = faults.codes_to_words(q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfaults.codes_to_words(jq)))
    words = rng.integers(0, 1 << bits, (37, 21))
    udtype, _ = jfaults.word_dtypes(bits)
    want = jfaults.words_to_codes(jnp.asarray(words, udtype), jq)
    back = faults.words_to_codes(torch.from_numpy(words.astype(np.int32)), q)
    assert back.codes.dtype == (torch.int8 if bits <= 8 else torch.int16)
    assert back.bits == bits and back.scale is q.scale
    np.testing.assert_array_equal(back.codes.numpy(), np.asarray(want.codes))


def test_wide_codes_raise():
    q17 = QTensor(torch.zeros((4, 4), dtype=torch.int32), torch.tensor(1.0),
                  17)
    with pytest.raises(ValueError, match="16-bit"):
        faults.flip_bits_int(q17, 0.1, 0)
    with pytest.raises(ValueError, match="16-bit"):
        faults.word_dtypes(17)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="does not fit"):
        faults.packed_flip_mask(0.1, (4, 4), 33, g)
    assert faults.packed_flip_mask(0.0, (4, 4), 32, g).shape == (4, 4)


def test_packed_mask_endpoints():
    g = torch.Generator().manual_seed(0)
    assert not faults.packed_flip_mask(0.0, (8, 16), 4, g).any()
    assert (faults.packed_flip_mask(1.0, (8, 16), 4, g) == 0xF).all()
    assert (faults.packed_flip_mask(1.0, (3,), 32, g) == -1).all()


@pytest.mark.parametrize("shape", [(26, 10), (100, 100), (300, 300)])
def test_packed_mask_plane_by_plane_keeps_cpu_bits(shape):
    """Drawing the planes in groups (all 32 at (26, 10), 6 at a time at
    (100, 100), one at a time at (300, 300)) consumes the CPU generator's
    stream as the one (nbits, *shape) draw it replaced did:
    flip_bits_f32's bits on the CPU are unchanged."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32))
    for p in (0.0, 0.05, 0.3):
        g = torch.Generator().manual_seed(1234)
        planes = torch.rand((32, *w.shape), generator=g) < p
        weights = torch.ones((), dtype=torch.int64) << torch.arange(
            32).view(32, 1, 1)
        old = (planes.to(torch.int64) * weights).sum(dim=0)
        old = torch.where(old >= (1 << 31), old - (1 << 32), old)
        want = (w.view(torch.int32) ^ old.to(torch.int32)).view(torch.float32)
        got = faults.flip_bits_f32(w, p, 1234)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------ flips, bitwise parity ---

@pytest.mark.parametrize("bits", [1, 4, 8, 12])
def test_flip_bits_int_bitwise(bits):
    rng = np.random.default_rng(30 + bits)
    sdtype = np.int8 if bits <= 8 else np.int16
    lo, hi = (0, 2) if bits == 1 else (-(1 << (bits - 1)), 1 << (bits - 1))
    codes = rng.integers(lo, hi, (37, 21)).astype(sdtype)
    jq = JQ(jnp.asarray(codes), jnp.float32(0.5), bits)
    q = QTensor(torch.from_numpy(codes), torch.tensor(0.5), bits)
    key = jax.random.PRNGKey(31)
    for p in (0.0, 0.2, 1.0):
        want = jfaults.flip_bits_int(jq, p, key)
        got = faults.flip_bits_int(q, p, JaxDraw([key]))
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        assert got.codes.dtype == q.codes.dtype


def test_flip_bits_f32_bitwise():
    w = np.random.default_rng(1).standard_normal((40, 50)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for p in (0.0, 0.1, 1.0):
        want = np.asarray(jfaults.flip_bits_f32(jnp.asarray(w), p, key))
        got = faults.flip_bits_f32(torch.from_numpy(w), p, JaxDraw([key]))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("scope", ["all", "hv"])
@pytest.mark.parametrize("bits", [1, 4, 8, 12])
def test_flip_tree_and_corrupt_model_bitwise(bits, scope):
    """flip_tree and corrupt_model on a fitted LogHD model (sigma_inv's
    IEEE-754 flips included) equal the reference's, the reference's keys
    mapped to the port's leaves by name."""
    model, _, _ = _fitted()
    ref, port = trees(model, bits)
    key = jax.random.PRNGKey(77)
    want = jfaults.corrupt_model(dict(ref), 0.13, key, scope)
    rest = stored(port)
    draws = port_draws(rest, ref, key, "iid")
    got = faults.corrupt_model(port.to_dict(), 0.13, draws, scope)
    assert set(got) == set(rest) | {"enc"} and got["enc"] is port.enc
    assert_leaves_equal({k: v for k, v in got.items() if k != "enc"}, want)
    draws = port_draws(rest, ref, key, "iid")
    tree = faults.flip_tree(rest, 0.13, draws,
                            skip=faults.fault_skip_set(scope))
    assert_leaves_equal(tree, want)


@pytest.mark.parametrize("scope", ["all", "hv"])
def test_hdmodel_corrupted_bitwise(scope):
    """HDModel.corrupted keeps the codes quantized and equals the
    reference's ``corrupted``; ``materialized`` then dequantizes them."""
    model, _, _ = _fitted()
    ref, port = trees(model, 4)
    key = jax.random.PRNGKey(5)
    want = model.quantized(4).corrupted(0.2, key, scope)
    got = port.corrupted(0.2, port_draws(stored(port), ref, key, "iid"),
                         scope)
    assert isinstance(got.bundles, QTensor)
    assert_leaves_equal(stored(got), {k: v for k, v in want.to_dict().items()
                                      if k != "enc"})
    np.testing.assert_array_equal(
        got.materialized().bundles.numpy(),
        np.asarray(want.materialized().bundles))
    clf = make_classifier("loghd", C, F, dim=D, device="cpu").with_model(port)
    via = clf.corrupted(0.2, port_draws(stored(port), ref, key, "iid"),
                        scope).materialized().model
    assert torch.equal(via.bundles, got.materialized().bundles)


@pytest.mark.parametrize("family", ["loghd", "conventional"])
@pytest.mark.parametrize("name", MODELS)
def test_fault_model_corrupt_bitwise(name, family):
    """Each model's ``corrupt`` on a fitted model's 4-bit leaves (scope
    "all": LogHD's profiles and sigma_inv too) equals the reference's, bit
    for bit, with the reference's draws injected."""
    model, _, _ = _fitted(family)
    ref, port = trees(model, 4)
    key = jax.random.PRNGKey(41)
    skip = faults.fault_skip_set("all")
    sev = SEVERITY[name]
    want = jzoo.make_fault_model(name).corrupt(dict(ref), sev, key, skip=skip)
    rest = stored(port)
    got = make_fault_model(name).corrupt(rest, sev,
                                         port_draws(rest, ref, key, name),
                                         skip=skip)
    assert_leaves_equal(got, want)
    # the corruption did something: some code of the bulk memory changed
    leaf = "bundles" if family == "loghd" else "protos"
    assert not torch.equal(got[leaf].codes, rest[leaf].codes)


def test_drift_p_eff_within_one_ulp():
    for p in (0.002, 0.01, 0.2):
        fm, jfm = DriftFlip(per_read_p=p), jzoo.DriftFlip(per_read_p=p)
        for r in (0.0, 1.0, 25.0, 150.0, 800.0, 1e6):
            got, want = np.float32(fm.p_eff(r)), np.float32(jfm.p_eff(r))
            assert abs(got - want) <= np.spacing(want), (p, r, got, want)


@pytest.mark.parametrize("name", MODELS)
def test_corrupt_materialize_labels_match_reference(name):
    """The slice end to end: corrupt_materialize with ``fault_model=`` at a
    few (severity, trial) points, then predict, gives the reference's
    leaves and labels.  iid takes the kernel route in both packages (the
    reference's Pallas kernel in interpret mode, seeds from its key chain);
    the others their torch / jnp route with the reference's draws."""
    model, h, _ = _fitted()
    ref, port = trees(model, 4)
    jq = model.quantized(4)
    sevs = ([0.0, 100.0, 400.0] if name == "drift" else [0.0, 0.05, 0.3])
    for scope in ("all", "hv"):
        for t, sev in enumerate(sevs):
            key = jax.random.PRNGKey(100 + t)
            jfm = jzoo.make_fault_model(name)
            if name == "iid":
                want = jdispatch.corrupt_materialize(
                    jq, sev, key, scope, use_kernel=True, fault_model=jfm)
                keys = jax.random.split(key, len(stored(port)))
                row = [int(jax.random.randint(k, (), 0,
                                              jnp.iinfo(jnp.int32).max))
                       for k in keys]
            else:
                want = jdispatch.corrupt_materialize(jq, sev, key, scope,
                                                     fault_model=jfm)
                row = port_draws(stored(port), ref, key, name)
            common.reset_launches()
            got = dispatch.corrupt_materialize(port, sev, row, scope,
                                               fault_model=name)
            assert sum(common.launches.values()) == 0
            for leaf in ("bundles", "profiles"):
                np.testing.assert_array_equal(
                    getattr(got, leaf).numpy().view(np.int32),
                    np.asarray(getattr(want, leaf)).view(np.int32))
            labels = dispatch.predict_encoded(got, torch.from_numpy(h.copy()))
            np.testing.assert_array_equal(
                labels.numpy(),
                np.asarray(jdispatch.predict_encoded(want, jnp.asarray(h))))


def test_kernel_route_takes_int_seeds():
    port, _, _ = _port()
    q = port.quantized(4)
    draws = [faults.GeneratorDraw.seeded(s, "cpu") for s in range(4)]
    with pytest.raises(TypeError, match="int seeds"):
        q.corrupted_materialized(0.1, draws, fault_model="iid")
    with pytest.raises(ValueError, match="seeds for"):
        q.corrupted_materialized(0.1, [1, 2], fault_model="burst")
    with pytest.raises(TypeError, match="flat dict"):
        faults.flip_tree({"a": {"b": torch.zeros(2)}}, 0.1, [0])


# ------------------------------------------------------ iid vs default ----

@pytest.mark.parametrize("p_chunk", [None, 2])
def test_iid_sweep_equals_default(p_chunk):
    """fault_model="iid" is the default sweep bit for bit: the same
    flip_corrupt route, the same seeds."""
    port, h, y = _port()
    grid = [0.0, 0.05, 0.2]
    kw = dict(n_trials=3, p_chunk=p_chunk,
              predict_encoded=dispatch.predict_encoded)
    legacy = port.sweep_under_flips(
        4, grid, h, y, generator=torch.Generator().manual_seed(5), **kw)
    zoo = port.sweep_under_flips(
        4, grid, h, y, generator=torch.Generator().manual_seed(5),
        fault_model="iid", **kw)
    np.testing.assert_array_equal(legacy, zoo)
    inst = ev.sweep_under_flips(port, 4, grid, h, y,
                                generator=torch.Generator().manual_seed(5),
                                fault_model=IIDFlip(), **kw)
    np.testing.assert_array_equal(legacy, inst)


@pytest.mark.parametrize("scope", ["all", "hv"])
def test_iid_zoo_equals_corrupt_model(scope):
    """IIDFlip.corrupt is core.faults.corrupt_model on the same seeds."""
    port, _, _ = _port()
    rest = stored(port.quantized(3))
    seeds = [11, 12, 13, 14]
    legacy = faults.corrupt_model(rest, 0.13, seeds, scope)
    zoo = IIDFlip().corrupt(rest, 0.13, seeds,
                            skip=faults.fault_skip_set(scope))
    for name, a in legacy.items():
        b = zoo[name]
        if isinstance(a, QTensor):
            assert torch.equal(a.codes, b.codes), name
        else:
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b), name


# -------------------------------------- rates on the port's generator ----

def test_asymmetric_rates_chi_squared():
    bits, sev = 4, 0.2
    fm = AsymmetricFlip(p01_scale=0.25, p10_scale=1.0)
    q = _codes(bits)
    fq = fm.corrupt_qtensor(q, sev, 3)
    u0, u1 = _words(q), _words(fq)
    p01, p10 = sev * fm.p01_scale, sev * fm.p10_scale
    chi2_01 = chi2_10 = 0.0
    for b in range(bits):
        stored_b, read = (u0 >> b) & 1, (u1 >> b) & 1
        n0, n1 = int((stored_b == 0).sum()), int((stored_b == 1).sum())
        chi2_01 += _chi2_binom(int(((stored_b == 0) & (read == 1)).sum()),
                               n0, p01)
        chi2_10 += _chi2_binom(int(((stored_b == 1) & (read == 0)).sum()),
                               n1, p10)
    assert chi2_01 < CHI2_DF4, chi2_01
    assert chi2_10 < CHI2_DF4, chi2_10
    tot01 = int(((u0 ^ u1) & ~u0 & ((1 << bits) - 1) > 0).sum())
    tot10 = int(((u0 ^ u1) & u0 > 0).sum())
    assert tot10 > 2 * tot01, (tot01, tot10)


def test_burst_marginal_and_row_correlation():
    bits, sev, row = 4, 0.3, 128
    fm = BurstFlip(row_size=row, burst_rate=0.5)
    q = _codes(bits, shape=(256, 512))
    x = _words(q) ^ _words(fm.corrupt_qtensor(q, sev, 8))
    n = x.size
    marginal = sev * fm.burst_rate
    for b in range(bits):
        # one gate covers a row: the window is ~4.2 sigma of the gated rate
        assert abs(int(((x >> b) & 1).sum()) / n - marginal) < 0.03, b
    flat = x.reshape(-1)
    nrows = flat.size // row
    per_row = (np.unpackbits(
        flat[:nrows * row].astype(np.uint16).view(np.uint8))
        .reshape(nrows, -1).sum(axis=1))
    hit = per_row > 0
    se = np.sqrt(sev * (1 - sev) / nrows)
    assert abs(hit.mean() - sev) < 4 * se + 1e-9, hit.mean()
    assert per_row[hit].mean() > 0.8 * fm.burst_rate * row * bits
    iid_var = flat.size * bits / nrows * marginal * (1 - marginal)
    assert per_row.var() > 10 * iid_var, (per_row.var(), iid_var)


def test_burst_rows_cross_matrix_rows():
    """The gate runs over the flattened leaf: with rows of 3 words over a
    (4, 5) leaf, gate rows straddle matrix rows."""
    fm = BurstFlip(row_size=3, burst_rate=1.0)

    class Gate:
        def bernoulli(self, p, shape):
            assert shape == (7,)
            return torch.tensor([False, True, False, False, False, False,
                                 True])

        def mask(self, p, shape, nbits):
            return torch.full(shape, (1 << nbits) - 1, dtype=torch.int32)

    u = torch.zeros((4, 5), dtype=torch.int32)
    out = fm.corrupt_words(u, 4, 0.5, Gate())
    want = torch.zeros(20, dtype=torch.int32)
    want[3:6] = 0xF
    want[18:20] = 0xF
    assert torch.equal(out.reshape(-1), want)


def test_stuck_at_marginal_persistence_idempotence():
    bits, sev = 4, 0.2
    fm = StuckAt(stuck0_frac=0.5)
    q = _codes(bits)
    fq = fm.corrupt_qtensor(q, sev, 13)
    u0, u1 = _words(q), _words(fq)
    p0 = sev * fm.stuck0_frac
    p1 = sev * (1.0 - fm.stuck0_frac) * (1.0 - p0)
    chi2 = 0.0
    for b in range(bits):
        stored_b = (u0 >> b) & 1
        flipped = ((u0 ^ u1) >> b) & 1
        n1, n0 = int(stored_b.sum()), int((1 - stored_b).sum())
        expect = n1 * p0 + n0 * p1
        var = n1 * p0 * (1 - p0) + n0 * p1 * (1 - p1)
        chi2 += (int(flipped.sum()) - expect) ** 2 / (var + 1e-12)
    assert chi2 < CHI2_DF4, chi2
    assert torch.equal(fm.corrupt_qtensor(q, sev, 13).codes, fq.codes)
    assert torch.equal(fm.corrupt_qtensor(fq, sev, 13).codes, fq.codes)


def test_drift_identity_closed_form_and_monotonicity():
    bits = 4
    fm = DriftFlip(per_read_p=0.002)
    q = _codes(bits)
    assert torch.equal(fm.corrupt_qtensor(q, 0.0, 21).codes, q.codes)
    for r in (1, 100, 1000):
        expect = (1.0 - (1.0 - 2 * fm.per_read_p) ** r) / 2.0
        assert fm.p_eff(float(r)) == pytest.approx(expect, rel=1e-4)
    assert fm.p_eff(1e6) == pytest.approx(0.5)
    r = 200.0
    x = _words(q) ^ _words(fm.corrupt_qtensor(q, r, 21))
    p = fm.p_eff(r)
    chi2 = sum(_chi2_binom(int(((x >> b) & 1).sum()), x.size, p)
               for b in range(bits))
    assert chi2 < CHI2_DF4, chi2
    rates = [float(np.mean(np.unpackbits(
        (_words(q) ^ _words(fm.corrupt_qtensor(q, rr, 21))).astype(
            np.uint8)))) for rr in (0.0, 50.0, 500.0, 5000.0)]
    assert rates == sorted(rates), rates


def test_iid_rate_chi_squared():
    p, bits = 0.25, 4
    q = _codes(bits)
    x = _words(q) ^ _words(IIDFlip().corrupt_qtensor(q, p, 6))
    chi2 = sum(_chi2_binom(int(((x >> b) & 1).sum()), x.size, p)
               for b in range(bits))
    assert chi2 < CHI2_DF4, chi2


def test_severity_zero_is_identity_for_every_model():
    q = _codes(4)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 64)).astype(np.float32))
    for name in available_fault_models():
        fm = make_fault_model(name)
        assert torch.equal(fm.corrupt_qtensor(q, 0.0, 1).codes, q.codes), name
        assert torch.equal(fm.corrupt_f32(w, 0.0, 1).view(torch.int32),
                           w.view(torch.int32)), name


def test_draws_are_a_pure_function_of_the_seed():
    """The same seed gives the same uniforms at every severity (common
    random numbers): damage only grows with the severity."""
    q = _codes(4, shape=(64, 128))
    for name in ("asymmetric", "burst", "drift"):
        fm = make_fault_model(name)
        grid = (0.0, 50.0, 400.0) if name == "drift" else (0.0, 0.1, 0.4)
        flips = [int(np.unpackbits((_words(q) ^ _words(
            fm.corrupt_qtensor(q, s, 4))).astype(np.uint8)).sum())
            for s in grid]
        assert flips[0] == 0 and flips == sorted(flips), (name, flips)


# ---------------------------------------------------- sweep integration ---

@pytest.mark.parametrize("name", MODELS)
def test_every_model_sweeps(name):
    """Every model goes through sweep_under_flips: a (|grid|, T) matrix
    equal to its per-point loop over corrupted_materialized, severity 0
    equal to the default sweep's clean row, no launch on the CPU."""
    port, h, y = _port()
    grid = [0.0, 100.0, 400.0] if name == "drift" else [0.0, 0.1, 0.3]
    seeds = ev.trial_seeds(torch.Generator().manual_seed(3), 2, 4)
    common.reset_launches()
    accs = port.sweep_under_flips(4, grid, h, y, n_trials=2, seeds=seeds,
                                  scope="hv", fault_model=name,
                                  predict_encoded=dispatch.predict_encoded)
    assert sum(common.launches.values()) == 0
    assert accs.shape == (3, 2)
    assert np.all(accs >= 0) and np.all(accs <= 1)
    q = port.quantized(4)
    yt = torch.as_tensor(y)
    loop = np.array([[float((dispatch.predict_encoded(
        q.corrupted_materialized(s, row, "hv", fault_model=name), h)
        == yt).float().mean()) for row in seeds] for s in grid], np.float32)
    np.testing.assert_array_equal(accs, loop)
    legacy = port.sweep_under_flips(4, [0.0], h, y, n_trials=2, seeds=seeds,
                                    scope="hv")
    np.testing.assert_array_equal(accs[0], legacy[0])


@pytest.mark.parametrize("p_chunk", [1, 2])
def test_zoo_sweep_chunking_invariance(p_chunk):
    port, h, y = _port("conventional")
    grid = [0.0, 0.1, 0.2]
    kw = dict(n_trials=2, generator=None, fault_model=StuckAt(0.3))
    whole = port.sweep_under_flips(4, grid, h, y, **kw)
    chunked = port.sweep_under_flips(4, grid, h, y, p_chunk=p_chunk, **kw)
    np.testing.assert_array_equal(whole, chunked)
    one = ev.evaluate_under_flips(port, 4, 0.2, h, y, n_trials=2,
                                  fault_model=StuckAt(0.3))
    assert one == pytest.approx(float(np.mean(whole[2])))


def test_classifier_sweep_takes_fault_model():
    port, h, y = _port()
    clf = make_classifier("loghd", C, F, dim=D, device="cpu").with_model(port)
    got = clf.sweep_under_flips(4, [0.0, 0.2], h, y, n_trials=2,
                                fault_model="burst")
    want = port.sweep_under_flips(4, [0.0, 0.2], h, y, n_trials=2,
                                  fault_model=BurstFlip())
    np.testing.assert_array_equal(got, want)
    assert ev.resolve_fault_model(None) is None
    assert ev.resolve_fault_model("drift") == DriftFlip()
    fm = BurstFlip(row_size=7)
    assert ev.resolve_fault_model(fm) is fm

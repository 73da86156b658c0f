"""The port's optimizer side on the CPU against the JAX package's:
``cosine_schedule``, ``adamw_init`` / ``adamw_update`` with float32 and
int8 moments (the reference's update called under ``jax.jit``, as the
training step runs it), and the port's versions of ``tests/test_runtime.py``'s
schedule and AdamW tests.

Tolerances, each from what XLA compiles that torch does not reproduce:
  * the schedule: within 8 float32 ulps (XLA's float32 cosine on the
    CPU lands up to 7 ulps from the float64 value, and XLA folds the
    warmup's division into a product by a rounded constant);
  * with the clip scale at 1 (gradient norm below clip_norm), float32
    moments bitwise and parameters within PARAM_ULPS float32 ulps (XLA's
    float32 square root on the CPU is not correctly rounded); an int8
    scale an ulp off (the fusion that takes XLA's absmax contracts the
    other product; its block's next moments then differ by ulps), a code
    at a rounding boundary one step off, counted;
  * with clipping active, the global norm within 4 ulps (summed in another
    order), so everything downstream of the clip scale by tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim.schedule import cosine_schedule as r_cosine
from repro_torch.optim import adamw as PA
from repro_torch.optim.schedule import cosine_schedule

PARAM_ULPS = 4
LR = float(np.float32(3e-3))
LAYERS = 4
# reference leaves: "a" is stacked over LAYERS layers with 16,384 elements
# a layer (int8 only by its 65,536-element stack), "b" int8 on its own,
# "c" a norm-sized float32 leaf, "d" a last axis no block divides
SHAPES = {"a": (LAYERS, 64, 256), "b": (256, 512), "c": (256,),
          "d": (3, 100)}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 ulps of b."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        np.abs(b).astype(np.float32)).astype(np.float64)


def _params_close(got: np.ndarray, want: np.ndarray) -> bool:
    """Within PARAM_ULPS ulps of the parameter plus PARAM_ULPS ulps of a
    step's size (a step lr * x with x near 1 is where a rounding of XLA's
    square root shows)."""
    tol = PARAM_ULPS * (np.spacing(np.abs(want).astype(np.float32))
                        + LR * 2.0 ** -23)
    return bool((np.abs(got.astype(np.float64) - want) <= tol).all())


# ------------------------------------------------------------- schedule ---

@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 100),
                                               (1e-3, 0, 40), (2e-2, 7, 8)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    ref = jax.jit(lambda s: r_cosine(s, peak_lr=peak, warmup_steps=warmup,
                                     total_steps=total))
    steps = range(0, total + 6)
    want = np.array([np.float32(ref(s)) for s in steps])
    got = np.array([cosine_schedule(s, peak_lr=peak, warmup_steps=warmup,
                                    total_steps=total) for s in steps],
                   dtype=np.float32)
    assert got.dtype == want.dtype
    assert (_ulps(got, want) <= 8).all(), (got, want)
    # flat at final_frac * peak after total_steps
    assert got[-1] == got[-5]
    np.testing.assert_allclose(got[-1], 0.1 * peak, rtol=1e-6)


def test_cosine_schedule_shape():
    lrs = [cosine_schedule(s, peak_lr=1e-3, warmup_steps=10,
                           total_steps=100) for s in range(0, 100, 5)]
    assert lrs[0] < lrs[2]            # warmup rising
    assert max(lrs) <= 1e-3 + 1e-9
    assert lrs[-1] < lrs[4]           # decayed


# ---------------------------------------------------------------- AdamW ---

def _port_params(arrays: dict) -> tuple:
    """The reference leaves as the port holds them: "a" one tensor a
    layer, with its layer count."""
    params, layers = {}, {}
    for name, a in arrays.items():
        if name == "a":
            for i in range(LAYERS):
                params[f"a.{i}"] = torch.from_numpy(a[i].copy())
                layers[f"a.{i}"] = LAYERS
        else:
            params[name] = torch.from_numpy(a.copy())
    return params, layers


def _stacked(port: dict, name: str):
    """A port leaf (tensor or int8 moment) in the reference's layout."""
    if name != "a":
        leaf = port[name]
        return ({k: v.numpy() for k, v in leaf.items()}
                if isinstance(leaf, dict) else leaf.numpy())
    parts = [port[f"a.{i}"] for i in range(LAYERS)]
    if isinstance(parts[0], dict):
        return {k: torch.stack([p[k] for p in parts]).numpy()
                for k in parts[0]}
    return torch.stack(parts).numpy()


def _run(moment_dtype: str, grad_scale: float, steps: int = 4, seed: int = 0):
    """`steps` updates of both packages from the same parameters and
    gradients; yields (step, reference state, reference params, port
    state, port params) after each."""
    rng = np.random.default_rng(seed)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    rcfg = RA.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    pcfg = PA.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    rp = {k: jnp.asarray(v) for k, v in arrays.items()}
    rs = RA.adamw_init(rp, rcfg)
    update = jax.jit(lambda s, p, g, lr: RA.adamw_update(s, p, g, rcfg,
                                                         lr=lr))
    pp, layers = _port_params(arrays)
    ps = PA.adamw_init(pp, pcfg, layers)
    for step in range(steps):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        rs, rp = update(rs, rp, {k: jnp.asarray(v) for k, v in grads.items()},
                        jnp.float32(LR))
        pg, _ = _port_params(grads)
        ps, pp = PA.adamw_update(ps, pp, pg, pcfg, lr=LR)
        yield step, rs, rp, ps, pp


def _codes_and_scales(ref, port):
    """(codes differing, scales more than one ulp off, scales differing)."""
    codes = int((np.asarray(ref["codes"]) != port["codes"]).sum())
    want = np.asarray(ref["scale"])
    return (codes, int((_ulps(port["scale"], want) > 1).sum()),
            int((port["scale"] != want).sum()))


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_update_matches_reference(moment_dtype):
    """Gradient norms below clip_norm, so both clip scales are exactly 1.
    float32 moments equal the reference's bit for bit and the parameters
    are within PARAM_ULPS.  int8 (the codec engages on "a" by its stack and
    on "b"): the scales within rtol 1e-6 (one an ulp off moves its block's
    next decoded moment), at most 16 codes off in all (measured: none),
    the float32 leaves bitwise, the parameters within 1e-6 but where a
    moment's block moved (measured: 1 of 65,536, by 2.8e-5)."""
    codes_off = 0
    for step, rs, rp, ps, pp in _run(moment_dtype, grad_scale=2e-4):
        assert ps["step"] == int(rs["step"]) == step + 1
        for name in SHAPES:
            for m in ("mu", "nu"):
                ref, port = rs[m][name], _stacked(ps[m], name)
                int8 = moment_dtype == "int8" and name in ("a", "b")
                assert isinstance(ref, dict) == int8
                assert isinstance(port, dict) == int8, (name, m)
                if int8:
                    c, _, _ = _codes_and_scales(ref, port)
                    codes_off += c
                    np.testing.assert_allclose(port["scale"], ref["scale"],
                                               rtol=1e-6)
                else:
                    np.testing.assert_array_equal(port, np.asarray(ref),
                                                  err_msg=f"{m} {name}")
            got, want = _stacked(pp, name), np.asarray(rp[name])
            if moment_dtype == "float32":
                assert _params_close(got, want), name
            else:
                beyond = np.abs(got - want) > 1e-6
                assert beyond.mean() <= 1e-3, (name, beyond.sum())
    assert codes_off <= 16


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_update_with_clipping_matches_reference(moment_dtype):
    """Gradient norms far above clip_norm: the clip scale follows from a
    norm summed in another order, so the float32 moments are held within
    1e-6 of each leaf's largest, the int8 scales within rtol 1e-6 and at
    most 1 in 10^4 codes off; parameters within 1e-6 absolute (int8: all
    but 1 in 10^3, where a code differs)."""
    for step, rs, rp, ps, pp in _run(moment_dtype, grad_scale=0.05, seed=1):
        for name in SHAPES:
            for m in ("mu", "nu"):
                ref, port = rs[m][name], _stacked(ps[m], name)
                if isinstance(ref, dict):
                    codes, _, _ = _codes_and_scales(ref, port)
                    assert codes <= ref["codes"].size * 1e-4, (name, m, codes)
                    np.testing.assert_allclose(port["scale"], ref["scale"],
                                               rtol=1e-6)
                else:
                    ref = np.asarray(ref)
                    np.testing.assert_allclose(
                        port, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
            got, want = _stacked(pp, name), np.asarray(rp[name])
            beyond = np.abs(got - want) > 1e-6
            assert beyond.mean() <= (1e-3 if moment_dtype == "int8" else 0), \
                (name, beyond.sum())


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
    want = jax.jit(RA._global_norm)({k: jnp.asarray(v)
                                      for k, v in grads.items()})
    got = PA.global_norm([torch.from_numpy(v) for v in grads.values()])
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), np.asarray(want)) <= 4


def test_int8_eligibility_follows_the_stacked_leaf():
    assert not PA.int8_eligible((64, 256), 256)
    assert PA.int8_eligible((64, 256), 256, layers=4)
    assert PA.int8_eligible((256, 512), 256)
    assert not PA.int8_eligible((256,), 256, layers=28)
    assert not PA.int8_eligible((2048, 100), 256, layers=28)
    for shape, layers in (((64, 256), 4), ((64, 256), 1), ((28, 2048), 1),
                          ((2048,), 28)):
        stacked = (layers, *shape) if layers > 1 else shape
        assert PA.int8_eligible(shape, 256, layers) == RA._int8_eligible(
            stacked, 256)


def test_int8_codec_matches_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 64, 512)) * 1e-3).astype(np.float32)
    x[0, 0, :256] = 0.0                       # an all-zero block: scale 1
    cfg = PA.AdamWConfig(moment_dtype="int8")
    want = jax.jit(lambda a: RA._encode_moment(
        a, RA.AdamWConfig(moment_dtype="int8")))(jnp.asarray(x))
    got = PA.encode_moment(torch.from_numpy(x), cfg, True)
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert got["scale"][0, 0, 0] == 1.0
    back = jax.jit(lambda m: RA._decode_moment(m, x.shape, None))(want)
    np.testing.assert_array_equal(
        PA.decode_moment(got, x.shape).numpy(), np.asarray(back))


def test_adamw_keeps_bf16_params_and_casts_back():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((256, 512)).astype(
        np.float32)).bfloat16()
    params = {"w": w.clone()}
    cfg = PA.AdamWConfig(lr=1e-2, moment_dtype="int8")
    state = PA.adamw_init(params, cfg)
    g = {"w": torch.full_like(w, 0.01)}
    PA.adamw_update(state, params, g, cfg)
    assert params["w"].dtype == torch.bfloat16
    assert state["mu"]["w"]["codes"].dtype == torch.int8
    # the same step in float32, rounded to bf16 once
    p32 = {"w": w.float()}
    s32 = PA.adamw_init(p32, cfg)
    PA.adamw_update(s32, p32, g, cfg)
    assert torch.equal(params["w"], p32["w"].bfloat16())


# ------------------------------- the port's versions of test_runtime.py ---

def _params(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    # "w" is large enough (>= 2^16 elements, block-divisible last axis) for
    # the int8 moment codec to engage; "b" stays on the f32 fallback
    return {"w": torch.randn((256, 512), generator=g),
            "b": torch.zeros((256,))}


def test_adamw_int8_matches_f32_closely():
    p32, p8 = _params(), _params()
    grads = {k: torch.full_like(v, 0.01) for k, v in p32.items()}
    cfg32 = PA.AdamWConfig(lr=1e-2, moment_dtype="float32", weight_decay=0.0)
    cfg8 = PA.AdamWConfig(lr=1e-2, moment_dtype="int8", weight_decay=0.0)
    s32, s8 = PA.adamw_init(p32, cfg32), PA.adamw_init(p8, cfg8)
    for _ in range(5):
        PA.adamw_update(s32, p32, grads, cfg32)
        PA.adamw_update(s8, p8, grads, cfg8)
    # int8 moments track f32 within quantization noise
    np.testing.assert_allclose(p8["w"].numpy(), p32["w"].numpy(), atol=5e-3)
    # and the int8 codec actually engaged for the big leaf
    assert isinstance(s8["mu"]["w"], dict) and "codes" in s8["mu"]["w"]
    assert not isinstance(s8["mu"]["b"], dict)


def test_adamw_descends():
    params = _params(1)
    target = torch.randn((256, 512), generator=torch.Generator().manual_seed(9))

    def loss(p):
        return ((p["w"] - target) ** 2).mean() + (p["b"] ** 2).mean()
    cfg = PA.AdamWConfig(lr=3e-2, weight_decay=0.0)
    state = PA.adamw_init(params, cfg)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    l0 = float(loss(leaves))
    for _ in range(20):
        g = torch.autograd.grad(loss(leaves), list(leaves.values()))
        PA.adamw_update(state, leaves, dict(zip(leaves, g)), cfg)
    assert float(loss(leaves)) < 0.5 * l0
    assert math.isfinite(float(loss(leaves)))

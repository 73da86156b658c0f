"""The port's distributed classifier paths across processes: gloo on the
CPU at 2 and 4 ranks, started with ``torch.multiprocessing`` (spawn) and a
``file://`` store in the test's directory.

Each test joins its ranks within its own timeout, so a hang fails that test
alone.  A rank writes its results to ``rank<r>.npz``; the test compares
them with the same task on one rank, also in a fresh process (this one may
have run other tests first).
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SRC = Path(__file__).resolve().parents[1] / "src"
JOIN_TIMEOUT_S = 120
C, F, N, D = 13, 24, 260, 128


def _worker(rank, world, store, out_dir, task, kwargs):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        out = TASKS[task](**kwargs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world: int, task: str, **kwargs) -> list:
    """Run TASKS[task] on `world` gloo ranks, each a fresh process; their
    results, by rank."""
    out_dir = tmp_path / f"{task}_w{world}"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _worker, args=(world, str(tmp_path / f"store_{task}_{world}"),
                       str(out_dir), task, kwargs),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{task} at {world} ranks did not finish in "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


# ------------------------------------------------------------------ tasks --

def _data(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    y = rng.integers(0, C, size=N)
    ht = rng.normal(size=(37, D)).astype(np.float32)
    return x, y, torch.from_numpy(ht / np.linalg.norm(ht, axis=1,
                                                      keepdims=True))


def task_sharded(s: int, ckpt: str, save_dir: str = "") -> dict:
    """Fit, predict, quantize, gather, save and load at S class shards."""
    from repro_torch.api import load_model, make_classifier, save_model
    x, y, ht = _data()
    clf = make_classifier("loghd", C, F, dim=D, refine_epochs=2,
                          class_sharding=s, codebook_method="distance",
                          device="cpu")
    m = clf.fit(x, y, generator=torch.Generator().manual_seed(0)).model
    g = m.gathered()
    q1 = m.quantized(1)
    seeds = [101, 202, 303, 404][:len(q1.to_dict()) - 1]
    out = {"labels": m.predict_encoded(ht).numpy(),
           "labels_q4": m.quantized(4).materialized().predict_encoded(
               ht).numpy(),
           "q4_scale": m.quantized(4).profiles.scale.numpy(),
           "bundles": m.bundles.numpy(), "profiles": g.profiles.numpy(),
           "local_rows": np.asarray(m.profiles.shape[0]),
           "sweep": m.sweep_under_flips(
               1, [0.0, 0.1, 0.3], ht, m.predict_encoded(ht), n_trials=2,
               generator=torch.Generator().manual_seed(0)),
           "flipped": q1.corrupted_materialized(0.2, seeds).full_rows(
           ).profiles.numpy(),
           "burst": m.quantized(4).corrupted(
               0.2, seeds, fault_model="burst").full_rows().profiles.codes
           .numpy(),
           "loaded": load_model(ckpt, device="cpu").predict_encoded(
               ht).numpy()}
    if save_dir:
        save_model(save_dir, 0, m)
    return out


def task_dp(dp: int) -> dict:
    """The data-parallel fits at Dp data shards over the ranks."""
    from repro_torch.api import fit_engine
    from repro_torch.launch.mesh import make_class_mesh
    h, y, protos, book, m0 = _dp_inputs()
    mesh = make_class_mesh(1, dp)
    kw = dict(lr=3e-3, batch_size=64, epochs=3, mesh=mesh)
    rkw = dict(epochs=4, lr=1e-2, batch_size=64, mesh=mesh)
    return {
        "exact": fit_engine.fused_onlinehd_fit_dp(protos, h, y, compress=None,
                                                  **kw).numpy(),
        "int8": fit_engine.fused_onlinehd_fit_dp(protos, h, y, compress="int8",
                                                 **kw).numpy(),
        "refine": fit_engine.fused_refine_bundles_dp(m0, h, y, book, 2,
                                                     **rkw).numpy(),
        "refine_exact": fit_engine.fused_refine_bundles_dp(
            m0, h, y, book, 2, compress=None, **rkw).numpy(),
        "grid": np.asarray([mesh.grid["data"], mesh.grid["class"]])}


def task_psum(block: int) -> dict:
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum
    g = torch.from_numpy(_psum_grads(dist.get_world_size())[dist.get_rank()])
    err = torch.zeros_like(g)
    mean, err = compressed_psum(g, None, err, block=block)
    mean2, err2 = compressed_psum(g, None, err, block=block)
    return {"mean": mean.numpy(), "err": err.numpy(), "mean2": mean2.numpy(),
            "err2": err2.numpy()}


TASKS = {"sharded": task_sharded, "dp": task_dp, "psum": task_psum}


def _dp_inputs():
    from repro_torch.core.codebook import build_codebook
    from repro_torch.hdc.conventional import class_prototypes, l2_normalize
    rng = np.random.default_rng(1)
    h = l2_normalize(torch.from_numpy(
        rng.standard_normal((512, 128)).astype(np.float32)))
    y = torch.from_numpy(rng.integers(0, 7, 512))
    book = build_codebook(7, 3, 2, seed=0)
    m0 = l2_normalize(torch.from_numpy(
        rng.standard_normal((3, 128)).astype(np.float32)))
    return h, y, class_prototypes(h, y, 7), book, m0


def _psum_grads(world: int) -> np.ndarray:
    return np.random.default_rng(5).standard_normal(
        (world, 64, 33)).astype(np.float32)


# ------------------------------------------------------------------ tests --

@pytest.mark.parametrize("world,s", [(2, 8), (4, 8), (4, 2)])
def test_sharded_fit_and_decode_equal_one_rank(tmp_path, world, s):
    """At W ranks the fit, the decode, the 4-bit quantization, the gathered
    rows and the faults (a 1-bit sweep, an iid and a burst corruption, each
    leaf corrupted whole by its global index) are bitwise those of one rank
    at the same S (both runs in fresh processes); a model saved at S = 8 without a process group loads
    on every rank with its own rows, and a save at W ranks writes the
    one-rank files byte for byte."""
    import filecmp
    from repro_torch.api import save_model
    ckpt = tmp_path / "saved_s8"
    save_model(str(ckpt), 0, _refit(8))
    want = _spawn(tmp_path, 1, "sharded", s=s, ckpt=str(ckpt),
                  save_dir=str(tmp_path / "saved_one"))[0]
    got = _spawn(tmp_path, world, "sharded", s=s, ckpt=str(ckpt),
                 save_dir=str(tmp_path / "saved_w"))
    w_c = np.gcd(s, world)
    for r, res in enumerate(got):
        for k in ("labels", "labels_q4", "q4_scale", "bundles", "profiles",
                  "loaded", "sweep", "flipped", "burst"):
            np.testing.assert_array_equal(res[k], want[k], err_msg=f"{k} {r}")
        assert int(res["local_rows"]) == int(want["local_rows"]) // w_c
    da = tmp_path / "saved_one" / "step_000000000"
    db = tmp_path / "saved_w" / "step_000000000"
    assert sorted(os.listdir(da)) == sorted(os.listdir(db))
    for f in os.listdir(da):
        assert filecmp.cmp(da / f, db / f, shallow=False), f


def test_sharded_fit_without_a_process_group(tmp_path):
    """No process group: one process holds all S blocks, no collective is
    called, and the labels are the unsharded fit's."""
    from repro_torch.api import make_classifier
    from repro_torch.launch.mesh import collectives
    x, y, ht = _data()
    collectives.clear()
    m = _refit(8)
    plain = make_classifier("loghd", C, F, dim=D, refine_epochs=2,
                            codebook_method="distance", device="cpu").fit(
        x, y, generator=torch.Generator().manual_seed(0)).model
    assert torch.equal(m.predict_encoded(ht), plain.predict_encoded(ht))
    assert m.profiles.shape[0] == 16 and not collectives


def _refit(s: int):
    from repro_torch.api import make_classifier
    x, y, _ = _data()
    return make_classifier("loghd", C, F, dim=D, refine_epochs=2,
                           class_sharding=s, codebook_method="distance",
                           device="cpu").fit(
        x, y, generator=torch.Generator().manual_seed(0)).model


@pytest.mark.parametrize("world", [2, 4])
def test_dp_fits_match_one_rank_and_the_serial_fit(tmp_path, world):
    """Dp = 4 data shards over W ranks against one rank holding all four:
    allclose (the all-reduce adds the ranks' sums in another order); the
    exact OnlineHD fit equals the serial fit on the interleaved global
    batches within the reference's bound, and int8 stays within 1e-3."""
    from repro_torch.api import fit_engine
    dp = 4
    want = _spawn(tmp_path, 1, "dp", dp=dp)[0]
    got = _spawn(tmp_path, world, "dp", dp=dp)
    for r, res in enumerate(got):
        assert res["grid"].tolist() == [world, 1]
        for k in ("exact", "refine_exact"):
            np.testing.assert_allclose(res[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} {r}")
        # an ulp of another summation order can move an int8 code by one
        # step at a rounding boundary: the int8 fits at the int8 bound
        for k in ("int8", "refine"):
            np.testing.assert_allclose(res[k], want[k], rtol=1e-3, atol=1e-3,
                                       err_msg=f"{k} {r}")
        np.testing.assert_array_equal(res["exact"], got[0]["exact"])
    h, y, protos, _, _ = _dp_inputs()
    local_bs, n_local = 64 // dp, 512 // dp
    order = np.concatenate([
        np.concatenate([np.arange(local_bs) + b * local_bs + s * n_local
                        for s in range(dp)])
        for b in range(n_local // local_bs)])
    serial = fit_engine.fused_onlinehd_fit(
        protos, h[order], y[order], lr=3e-3, batch_size=64, epochs=3,
        use_kernel=False)
    np.testing.assert_allclose(got[0]["exact"], serial.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0]["int8"], got[0]["exact"], rtol=1e-3,
                               atol=1e-3)


def test_refine_dp_lowers_the_target_error_and_repeats():
    from repro_torch.api import fit_engine
    from repro_torch.core.bundling import symbol_targets
    from repro_torch.launch.mesh import make_class_mesh
    h, y, _, book, m0 = _dp_inputs()
    ty = symbol_targets(book, 2)[y]

    def err(m):
        return float(torch.mean((h @ m.T - ty) ** 2))

    kw = dict(epochs=10, lr=1e-2, batch_size=64, mesh=make_class_mesh(1, 8),
              compress="int8")
    m = fit_engine.fused_refine_bundles_dp(m0, h, y, book, 2, **kw)
    assert m.shape == m0.shape and err(m) < err(m0), (err(m), err(m0))
    assert torch.equal(m, fit_engine.fused_refine_bundles_dp(m0, h, y, book,
                                                             2, **kw))
    other = fit_engine.fused_refine_bundles_dp(m0, h, y, book, 2, seed=1,
                                               **kw)
    assert not torch.equal(m, other)
    ragged = fit_engine.fused_onlinehd_fit_dp(
        m0, h[:500], y[:500] % 3, lr=3e-3, batch_size=64, epochs=1,
        mesh=make_class_mesh(1, 8), compress=None)
    assert ragged.shape == m0.shape
    with pytest.raises(ValueError, match="compress"):
        fit_engine.fused_onlinehd_fit_dp(m0, h, y % 3, lr=3e-3, batch_size=64,
                                         epochs=1, compress="int4")


def test_refine_dp_injected_permutations():
    """Injected (epochs, shards, rows a shard) orders: at one shard the dp
    refinement with exact sums is the serial refinement under those orders,
    and a wrong shape raises."""
    from repro_torch.api import fit_engine
    from repro_torch.launch.mesh import make_class_mesh
    h, y, _, book, m0 = _dp_inputs()
    perms = np.stack([np.random.default_rng(e).permutation(512)
                      for e in range(2)])
    dp = fit_engine.fused_refine_bundles_dp(
        m0, h, y, book, 2, epochs=2, lr=1e-2, batch_size=64,
        mesh=make_class_mesh(1, 1), compress=None, perms=perms[:, None])
    serial = fit_engine.fused_refine_bundles(
        m0, h, y, book, 2, epochs=2, lr=1e-2, batch_size=64, perms=perms,
        use_kernel=False)
    np.testing.assert_allclose(dp.numpy(), serial.numpy(), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="permutations of shape"):
        fit_engine.fused_refine_bundles_dp(
            m0, h, y, book, 2, epochs=2, lr=1e-2, batch_size=64,
            mesh=make_class_mesh(1, 2), perms=perms[:, None])


_REFERENCE_DP = """
import numpy as np, jax, jax.numpy as jnp
from repro.api import fit_engine
inp = dict(np.load(sys.argv[1]))
h, y, protos, book, m0 = (inp[k] for k in ("h", "y", "protos", "book", "m0"))
out = {}
for dp in (2, 4):
    mesh = jax.make_mesh((dp,), ("data",), devices=jax.devices()[:dp])
    for compress in (None, "int8"):
        tag = f"{dp}_{compress}"
        out["online_" + tag] = np.asarray(fit_engine.fused_onlinehd_fit_dp(
            protos, h, y, lr=3e-3, batch_size=64, epochs=3, mesh=mesh,
            compress=compress))
        out["refine_" + tag] = np.asarray(fit_engine.fused_refine_bundles_dp(
            m0, h, y, book, 2, epochs=4, lr=1e-2, batch_size=64, mesh=mesh,
            compress=compress, seed=0))
    # the reference's per-shard orders: permutation(fold_in(k_epoch, shard))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    out[f"perms_{dp}"] = np.stack([np.stack([np.asarray(
        jax.random.permutation(jax.random.fold_in(keys[e], s), 512 // dp))
        for s in range(dp)]) for e in range(4)])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _run_reference(tmp_path, body: str, *args) -> None:
    """`body` in a fresh interpreter that sees 8 forced host devices."""
    script = ("import os, sys\n"
              "os.environ['XLA_FLAGS'] = "
              "'--xla_force_host_platform_device_count=8'\n"
              f"sys.path.insert(0, {str(SRC)!r})\n"
              + textwrap.dedent(body))
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]


@pytest.fixture(scope="module")
def ref_dp(tmp_path_factory):
    """The reference's data-parallel fits at Dp = 2 and 4 on forced host
    devices, exact and int8, on ``_dp_inputs()``, with its refine orders."""
    tmp = tmp_path_factory.mktemp("ref_dp")
    h, y, protos, book, m0 = _dp_inputs()
    np.savez(tmp / "in.npz", h=h.numpy(), y=y.numpy(), protos=protos.numpy(),
             book=np.asarray(book), m0=m0.numpy())
    _run_reference(tmp, _REFERENCE_DP, tmp / "in.npz", tmp / "out.npz")
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("compress", [None, "int8"])
def test_dp_fits_match_reference(ref_dp, dp, compress):
    """The port's data-parallel fits, Dp shards in one process, against the
    reference's ``fused_*_dp`` over Dp forced host devices on the same
    inputs, the refinement under the reference's per-shard orders
    (``permutation(fold_in(k_epoch, shard))``, passed in as ``perms``).

    Exact sums: the reference's own bound, rtol 1e-5 / atol 1e-6.  int8:
    an ulp of another summation order can move a code across a rounding
    boundary, and a move in the last steps is not fed back before the fit
    ends, so the bound is on the mean absolute gap (measured at most
    2.8e-7 over the four fits) and on the count of elements beyond 1e-6
    (at most 1 of 384 to 896 measured).  The int8 fit differs from the
    exact one by a mean of 3.8e-6 or more in 373 elements or more, and
    a fit without the error feedback from the reference's int8 fit by a
    mean of 2.5e-5 or more: either fails both bounds."""
    from repro_torch.api import fit_engine
    from repro_torch.launch.mesh import make_class_mesh
    h, y, protos, book, m0 = _dp_inputs()
    mesh = make_class_mesh(1, dp)
    got = {
        "online": fit_engine.fused_onlinehd_fit_dp(
            protos, h, y, lr=3e-3, batch_size=64, epochs=3, mesh=mesh,
            compress=compress).numpy(),
        "refine": fit_engine.fused_refine_bundles_dp(
            m0, h, y, book, 2, epochs=4, lr=1e-2, batch_size=64, mesh=mesh,
            compress=compress, perms=ref_dp[f"perms_{dp}"]).numpy()}
    for kind, res in got.items():
        want = ref_dp[f"{kind}_{dp}_{compress}"]
        if compress is None:
            np.testing.assert_allclose(res, want, rtol=1e-5, atol=1e-6,
                                       err_msg=kind)
            continue
        gap = np.abs(res - want)
        assert gap.mean() <= 1e-6, (kind, gap.mean())
        assert int((gap > 1e-6).sum()) <= 2, (kind, np.sort(gap.ravel())[-5:])
        exact = ref_dp[f"{kind}_{dp}_None"]
        assert np.abs(want - exact).mean() > 3e-6, kind   # int8 is lossy


_REFERENCE_PSUM = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_checked
from repro.optim.grad_compress import compressed_psum
g = np.load(sys.argv[1])
world, block = g.shape[0], int(sys.argv[3])
mesh = jax.make_mesh((world,), ("pod",), devices=jax.devices()[:world])

def body(g, err):
    mean, err = compressed_psum(g[0], "pod", err[0], block=block)
    mean2, err2 = compressed_psum(g[0], "pod", err, block=block)
    return mean[None], err[None], mean2[None], err2[None]
out = jax.jit(shard_map_checked(
    body, mesh=mesh, in_specs=(P("pod"), P("pod")),
    out_specs=(P("pod"),) * 4, check=False))(g, np.zeros_like(g))
np.savez(sys.argv[2], **dict(zip(("mean", "err", "mean2", "err2"),
                                 (np.asarray(o) for o in out))))
print("OK")
"""


@pytest.mark.parametrize("world,block", [(2, 256), (4, 100)])
def test_compressed_psum_matches_reference(tmp_path, world, block):
    """``compressed_psum`` over W gloo ranks against the reference's over W
    of 8 forced host devices, two steps with the error carried; the whole
    (W, ...) outputs are read with ``np.asarray``.  The errors are the
    reference's bit for bit, the means too but for the order in which the
    ranks' values are added.  The same holds for the W shards held by one
    process as a list, the form the data-parallel fits call."""
    grads = _psum_grads(world)
    np.save(tmp_path / "g.npy", grads)
    _run_reference(tmp_path, _REFERENCE_PSUM, tmp_path / "g.npy",
                   tmp_path / "ref.npz", block)
    want = dict(np.load(tmp_path / "ref.npz"))
    got = _spawn(tmp_path, world, "psum", block=block)
    for r, res in enumerate(got):
        for k in ("err", "err2"):
            np.testing.assert_array_equal(res[k], want[k][r],
                                          err_msg=f"{k} {r}")
        for k in ("mean", "mean2"):
            if world == 2:          # a sum of two is one order
                np.testing.assert_array_equal(res[k], want[k][r])
            else:                   # gloo and XLA may add four in other orders
                ulp = float(np.spacing(np.abs(want[k]).max()))
                np.testing.assert_allclose(res[k], want[k][r], rtol=0,
                                           atol=world * ulp)
    # the same W shards held by one process (the form the dp fits call):
    # the shards' sum in list order, each shard's error its own
    from repro_torch.optim import compressed_psum
    gs = [torch.from_numpy(g) for g in grads]
    mean, errs = compressed_psum(gs, None, [torch.zeros_like(g) for g in gs],
                                 block=block)
    mean2, errs2 = compressed_psum(gs, None, errs, block=block)
    for r in range(world):
        np.testing.assert_array_equal(errs[r].numpy(), want["err"][r])
        np.testing.assert_array_equal(errs2[r].numpy(), want["err2"][r])
    for k, res in (("mean", mean), ("mean2", mean2)):
        if world == 2:
            np.testing.assert_array_equal(res.numpy(), want[k][0])
        else:
            ulp = float(np.spacing(np.abs(want[k]).max()))
            np.testing.assert_allclose(res.numpy(), want[k][0], rtol=0,
                                       atol=world * ulp)
    scale = np.abs(grads).max() / 127.0
    np.testing.assert_allclose(got[0]["mean"], grads.mean(0), atol=3 * scale)
    assert np.abs(got[0]["err"]).mean() > 0


def test_compressed_psum_without_a_process_group():
    from repro_torch.optim import compressed_psum, init_error_buffers
    from repro_torch.optim.grad_compress import _quantize_block
    g = torch.from_numpy(_psum_grads(1)[0])
    err = init_error_buffers({"w": g})["w"]
    mean, new_err = compressed_psum(g, None, err)
    codes, scale, deq = _quantize_block(g, 256)
    assert codes.dtype == torch.int8 and scale.shape == (9, 1)
    assert torch.equal(mean, deq)
    # the error is g - deq rounded once: within half an ulp of deq of it
    bound = torch.abs(deq).max() * 2.0 ** -24
    assert float(torch.abs(new_err - (g - deq)).max()) <= bound
    assert init_error_buffers([g, (g,)])[1][0].shape == g.shape

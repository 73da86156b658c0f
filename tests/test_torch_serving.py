"""The port's serving layer (``repro_torch.serving``) on the CPU: one test
for each behaviour ``tests/test_serving.py`` pins on the JAX package —
admission, fairness, the future lifecycle and cancel, error binding, submit
validation, backpressure, buckets and padding, int8 residency,
``clear_cache``, warmup, several models side by side, load generation — and
two parity tests: the port's served labels against the JAX package's
service on the same model, carried across, and against the port's own
``predict_encoded``.

Every wait on a future, a thread or ``serve_forever`` has its own timeout,
so no test can hang.
"""

import functools
import sys
import threading
from concurrent.futures import CancelledError

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_classifier as jax_make_classifier
from repro.core.quantize import QTensor as JaxQTensor
from repro.serving import ClassifierService as JaxClassifierService
from repro_torch.api import dispatch, from_reference, make_classifier
from repro_torch.api.dispatch import predict_encoded
from repro_torch.hdc.encoders import encode_batched
from repro_torch.kernels import common
from repro_torch.serving import (BatchLabels, BucketedPredict,
                                 ClassifierService, PredictFuture,
                                 PredictRequest, QueueFullError, RequestQueue,
                                 bucket_sizes, closed_loop, open_loop_poisson)

C, F, D = 5, 12, 256
T = 60.0          # seconds any wait in this file may take

METHOD_KW = {
    "conventional": {},
    "sparsehd": dict(sparsity=0.5, retrain_epochs=2),
    "loghd": dict(k=2, extra_bundles=1, refine_epochs=2),
    "hybrid": dict(sparsity=0.5, k=2, extra_bundles=1, refine_epochs=2),
}


@functools.lru_cache(maxsize=1)
def _data():
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((C, F)).astype(np.float32)
    y = np.arange(90) % C
    x = (dirs[y] * 2.0
         + rng.standard_normal((len(y), F)).astype(np.float32) * 0.3)
    return x.astype(np.float32), y


@functools.lru_cache(maxsize=8)
def _fitted(name: str):
    x, y = _data()
    return make_classifier(name, n_classes=C, in_features=F, dim=D,
                           device="cpu", **METHOD_KW[name]).fit(x, y)


def _labels(clf, x) -> list:
    return [int(v) for v in clf.predict(x)]


def _svc(models=None, **kw) -> ClassifierService:
    return ClassifierService(models, device="cpu", **kw)


def _res(fut):
    return fut.result(timeout=T)


# ------------------------------------------------------------------ queue --

def _req(q, name, x=None, encoded=False):
    return PredictRequest(uid=q.next_uid(), model_name=name,
                          x=np.zeros(3) if x is None else x, encoded=encoded)


def test_admission_fifo_grouped_by_model():
    q = RequestQueue()
    for name in ["a", "b", "a", "b", "a"]:
        q.push(_req(q, name))
    first = q.admit(max_batch=8)
    assert [r.model_name for r in first] == ["a", "a", "a"]
    assert [r.uid for r in first] == [0, 2, 4]
    second = q.admit(max_batch=8)
    assert [r.uid for r in second] == [1, 3]
    assert q.admit(max_batch=8) == []
    assert q.admitted == 5 and q.cycles == 2


def test_admission_respects_max_batch():
    q = RequestQueue()
    for _ in range(7):
        q.push(_req(q, "m"))
    assert [r.uid for r in q.admit(max_batch=4)] == [0, 1, 2, 3]
    assert [r.uid for r in q.admit(max_batch=4)] == [4, 5, 6]


def test_admission_groups_on_input_form():
    q = RequestQueue()
    q.push(_req(q, "m", x=np.zeros(3), encoded=False))
    q.push(_req(q, "m", x=np.zeros(9), encoded=True))
    q.push(_req(q, "m", x=np.zeros(3), encoded=False))
    assert [r.uid for r in q.admit(8)] == [0, 2]
    assert [r.uid for r in q.admit(8)] == [1]


def test_future_requires_dispatch():
    fut = PredictFuture()
    assert not fut.done()
    with pytest.raises(RuntimeError):
        fut.result()                 # fails fast: nothing drives a service


# ----------------------------------------------------- fairness (no HoL) --

def test_no_cross_model_starvation_under_hot_load():
    q = RequestQueue()
    for _ in range(50):
        q.push(_req(q, "hot"))
    cold = q.push(_req(q, "cold"))
    served_cold_at = None
    for cycle in range(6):
        batch = q.admit(max_batch=8)
        for _ in range(8):
            q.push(_req(q, "hot"))
        if any(r.model_name == "cold" for r in batch):
            served_cold_at = cycle
            break
    assert served_cold_at is not None, "cold model starved"
    assert served_cold_at < 2
    assert q.max_group_wait_cycles < 2
    assert not cold.dispatched()


def test_round_robin_cycles_all_groups():
    q = RequestQueue()
    for name in ["a"] * 5 + ["b"] * 5 + ["c"] * 5:
        q.push(_req(q, name))
    order = []
    while len(q):
        batch = q.admit(max_batch=2)
        order.append(batch[0].model_name)
        assert len({r.group for r in batch}) == 1
    assert order == ["a", "b", "c"] * 3
    assert q.max_group_wait_cycles <= 3


def test_service_fairness_bounded_wait_under_saturation():
    conv, log = _fitted("conventional"), _fitted("loghd")
    x, _ = _data()
    svc = _svc({"hot": conv.model, "cold": log.model}, max_batch=4,
               buckets=(1, 2, 4))
    for i in range(24):
        svc.submit("hot", x[i % len(x)])
    cold_fut = svc.submit("cold", x[0])
    svc.step()
    svc.step()
    assert cold_fut.dispatched()
    svc.run_until_drained()
    assert _res(cold_fut) == _labels(log, x[:1])[0]
    assert svc.stats()["max_group_wait_cycles"] <= 2


# ------------------------------------------------------- future lifecycle --

def test_future_timeout_and_cancel():
    fut = PredictFuture()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    with pytest.raises(TimeoutError):
        fut.exception(timeout=0.01)
    assert fut.cancel() and fut.cancelled() and fut.done()
    assert fut.cancel()
    with pytest.raises(CancelledError):
        fut.result(timeout=T)
    with pytest.raises(CancelledError):
        fut.exception(timeout=T)
    fut2 = PredictFuture()
    fut2._bind(np.asarray([7]), 0)
    assert not fut2.cancel() and not fut2.cancelled()
    assert fut2.result(timeout=1.0) == 7 and fut2.exception(timeout=T) is None


def test_done_reflects_readiness_not_dispatch():
    class FakeBatch:
        ready = False

        def is_ready(self):
            return self.ready

        def __array__(self, dtype=None, copy=None):
            return np.asarray([3], dtype)

    fut = PredictFuture()
    batch = FakeBatch()
    fut._bind(batch, 0)
    assert fut.dispatched() and not fut.done()
    batch.ready = True
    assert fut.done()
    assert _res(fut) == 3 and fut.done()


def test_batch_labels_on_the_cpu_are_ready_at_once():
    labels = BatchLabels(torch.tensor([4, 1, 2]))
    assert labels.is_ready()
    labels.wait()
    np.testing.assert_array_equal(np.asarray(labels), [4, 1, 2])
    fut = PredictFuture()
    fut._bind(labels, 1)
    assert fut.done() and _res(fut) == 1


def test_cancelled_request_never_dispatches():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=8)
    futs = [svc.submit("m", x[i]) for i in range(3)]
    assert futs[1].cancel()
    assert svc.run_until_drained() == 2
    want = _labels(clf, x[:3])
    assert _res(futs[0]) == want[0]
    with pytest.raises(CancelledError):
        _res(futs[1])
    assert _res(futs[2]) == want[2]


# ------------------------------------------------------ error propagation --

def test_cycle_error_binds_into_exactly_affected_futures():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=4)
    first = [svc.submit("m", x[i]) for i in range(4)]
    poisoned = [svc.submit("m", x[4])]
    bad = PredictRequest(uid=svc.queue.next_uid(), model_name="m",
                         x=np.zeros(5, np.float32))   # wrong feature width
    svc.queue.push(bad)
    poisoned.append(bad.future)
    poisoned += [svc.submit("m", x[i]) for i in (5, 6)]
    last = [svc.submit("m", x[i]) for i in range(7, 11)]
    svc.run_until_drained()

    want = _labels(clf, x[:11])
    assert [_res(f) for f in first] == want[:4]
    for f in poisoned:
        assert isinstance(f.exception(timeout=T), ValueError)
        with pytest.raises(ValueError):
            _res(f)
    assert [_res(f) for f in last] == want[7:11]
    assert svc.errors == 1 and len(svc.queue) == 0


def test_submit_validates_shape():
    clf = _fitted("conventional")
    svc = _svc({"m": clf.model}, max_batch=4)
    with pytest.raises(ValueError, match="feature vector"):
        svc.submit("m", np.zeros(F + 1))
    with pytest.raises(ValueError, match="hypervector"):
        svc.submit("m", np.zeros(F), encoded=True)
    with pytest.raises(ValueError):
        svc.submit("m", np.zeros((2, F)))
    assert len(svc.queue) == 0


def test_submit_normalizes_dtype_no_new_buckets():
    """int and float64 submissions (raw and encoded) are cast to float32
    and land in the buckets warmup visited: no miss after warmup."""
    clf = _fitted("conventional")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos").numpy()
    svc = _svc({"m": clf.model}, max_batch=4, buckets=(1, 2, 4))
    svc.warmup()
    misses = svc.bucket_cache.stats.misses
    futs = [svc.submit("m", np.asarray(x[i], np.float64)) for i in range(3)]
    futs += [svc.submit("m", np.asarray(h[i], np.float64), encoded=True)
             for i in range(3)]
    futs += [svc.submit("m", np.asarray(x[3]).astype(np.int32) * 0 + 1)]
    assert all(r.x.dtype == np.float32 for r in svc.queue)
    svc.run_until_drained()
    [_res(f) for f in futs]
    assert svc.bucket_cache.stats.misses == misses
    assert [_res(f) for f in futs[:3]] == _labels(clf, x[:3])


# ------------------------------------------------------ background thread --

def test_serve_forever_background_dispatch():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=8, buckets=(1, 2, 4, 8))
    svc.warmup()
    svc.serve_forever()
    try:
        assert svc.serving()
        with pytest.raises(RuntimeError):
            svc.serve_forever()
        futs = [svc.submit("m", x[i]) for i in range(20)]
        got = [_res(f) for f in futs]
    finally:
        svc.shutdown(timeout=T)
    assert not svc.serving()
    assert got == _labels(clf, x[:20])


def test_concurrent_submitters_lose_no_request():
    """More submitting threads than cores against the dispatch thread, with
    a short switch interval: every request is admitted once and resolves
    to its own label."""
    conv, log = _fitted("conventional"), _fitted("loghd")
    x, _ = _data()
    want = {"conv": _labels(conv, x), "loghd": _labels(log, x)}
    svc = _svc({"conv": conv.model, "loghd": log.model}, max_batch=8)
    n_threads, per_thread = 16, 20
    got, errors = [], []
    lock = threading.Lock()

    def client(t):
        try:
            name = "conv" if t % 2 else "loghd"
            rows = [(t * per_thread + i) % len(x) for i in range(per_thread)]
            futs = [(i, svc.submit(name, x[i])) for i in rows]
            out = [(name, i, f.result(timeout=T)) for i, f in futs]
            with lock:
                got.extend(out)
        except Exception as exc:      # noqa: BLE001 — reported below
            with lock:
                errors.append(exc)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    svc.serve_forever()
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=T)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
        svc.shutdown(timeout=T)
    assert not errors and not svc.serving()
    assert len(got) == n_threads * per_thread
    assert all(label == want[name][i] for name, i, label in got)
    st = svc.stats()
    assert st["admitted"] == n_threads * per_thread and st["errors"] == 0
    assert st["queued"] == 0


def test_shutdown_drains_pending():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=4)
    futs = [svc.submit("m", x[i]) for i in range(6)]
    svc.shutdown(timeout=T)
    assert [_res(f) for f in futs] == _labels(clf, x[:6])


# ---------------------------------------------------- quantized residency --

def test_quantized_residency_serves_quantized_labels():
    clf = _fitted("loghd")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")
    svc = _svc(max_batch=8, buckets=(1, 2, 4, 8))
    svc.register("f32", clf.model)
    svc.register("int8", clf.model, quantize_bits=8)
    assert svc.model_bytes("int8") <= 0.5 * svc.model_bytes("f32")
    assert svc.model("int8").bundles.codes.dtype == torch.int8

    futs = [svc.submit("int8", h[i].numpy(), encoded=True) for i in range(11)]
    svc.run_until_drained()
    got = np.asarray([_res(f) for f in futs])
    want = predict_encoded(clf.model.quantized(8).materialized(), h[:11])
    np.testing.assert_array_equal(got, want.numpy())


def test_quantized_and_f32_residency_are_distinct_bucket_entries():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc(max_batch=4, buckets=(2, 4))
    svc.register("f32", clf.model)
    svc.register("int8", clf.model, quantize_bits=8)
    assert svc.warmup() == 4
    assert svc.bucket_cache.executables() == 4
    misses = svc.bucket_cache.stats.misses
    for name in ("f32", "int8"):
        futs = [svc.submit(name, x[i]) for i in range(3)]
        svc.run_until_drained()
        [_res(f) for f in futs]
    assert svc.bucket_cache.stats.misses == misses


# ---------------------------------------------------------------- buckets --

def test_bucket_ladder_and_selection():
    assert bucket_sizes(8) == (1, 2, 4, 8)
    assert bucket_sizes(12) == (1, 2, 4, 8, 12)
    assert bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
    cache = BucketedPredict(buckets=(1, 2, 4, 8))
    assert [cache.bucket_for(n) for n in (1, 2, 3, 5, 8, 100)] \
        == [1, 2, 4, 8, 8, 8]
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_padding_never_leaks_into_outputs():
    clf = _fitted("loghd")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")
    cache = BucketedPredict(buckets=(4, 16, 64))
    direct = predict_encoded(clf.model, h).numpy()
    for n in (1, 3, 4, 5, 17, 64):
        got = cache.predict(clf.model, h[:n]).numpy()
        assert got.shape == (n,)
        np.testing.assert_array_equal(got, direct[:n], err_msg=f"n={n}")
    assert cache.predict(clf.model, h[:0]).shape == (0,)


def test_oversized_batches_chunk_through_the_top_bucket():
    clf = _fitted("conventional")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")       # 90 rows > top bucket
    cache = BucketedPredict(buckets=(8, 32))
    got = cache.predict(clf.model, h).numpy()
    np.testing.assert_array_equal(got, predict_encoded(clf.model, h).numpy())
    assert cache.executables() == 1                   # 32, 32, 32


def test_mixed_batch_sizes_one_entry_per_bucket():
    clf = _fitted("conventional")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")
    cache = BucketedPredict(buckets=(1, 2, 4, 8))
    sizes = [1, 3, 5, 7, 2, 8, 3, 5, 1, 6, 4, 7]
    for n in sizes:
        cache.predict(clf.model, h[:n])
    used = {cache.bucket_for(n) for n in sizes}
    assert cache.executables() == len(used)
    assert cache.stats.misses == len(used)
    assert cache.stats.hits == len(sizes) - len(used)
    assert cache.stats.padded_rows == sum(cache.bucket_for(n) - n
                                          for n in sizes)


def test_service_counts_the_rows_it_pads_before_encode():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=8)
    sizes = [5, 8, 3, 1]
    for n in sizes:
        futs = [svc.submit("m", r) for r in x[:n]]
        assert svc.run_until_drained() == n
        assert [f.result(timeout=T) for f in futs] == _labels(clf, x[:n])
    assert svc.stats()["padded_rows"] == sum(
        svc.bucket_cache.bucket_for(n) - n for n in sizes)      # 3 + 1
    assert svc.bucket_cache.stats.padded_rows == 0  # encoded at bucket size


def test_clear_cache_resets_bucket_caches():
    from repro_torch.api import clear_cache
    clf = _fitted("conventional")
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")
    cache = BucketedPredict(buckets=(4,))
    cache.predict(clf.model, h[:2])
    assert cache.executables() == 1
    dispatch.clear_cache()
    assert cache.executables() == 0
    assert cache.stats.misses == 0 and cache.stats.hits == 0
    cache.predict(clf.model, h[:2])
    clear_cache()                        # the api export is the same entry
    assert cache.executables() == 0


# ---------------------------------------------------------------- service --

@pytest.mark.parametrize("name", list(METHOD_KW))
def test_service_byte_identical_to_predict_encoded(name):
    clf = _fitted(name)
    x, _ = _data()
    h = encode_batched(clf.model.enc, x, "cos")
    svc = _svc({name: clf.model}, max_batch=8, buckets=(1, 2, 4, 8))
    futs = [svc.submit(name, h[i].numpy(), encoded=True) for i in range(11)]
    svc.run_until_drained()
    got = np.asarray([_res(f) for f in futs])
    np.testing.assert_array_equal(
        got, predict_encoded(clf.model, h[:11]).numpy(),
        err_msg=f"{name}: served labels diverge from dispatch path")


def _jax_arrays(model) -> dict:
    out = {}
    for k, v in model.to_dict().items():
        if k == "enc":
            out[k] = {a: np.asarray(b) for a, b in v.items()}
        elif isinstance(v, JaxQTensor):
            out[k] = (np.asarray(v.codes), np.asarray(v.scale), v.bits)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", list(METHOD_KW))
@pytest.mark.parametrize("encoded", [False, True])
def test_service_labels_equal_reference_service(name, encoded):
    """The same model, fitted by the JAX package and carried across, served
    by both services: the same labels for the same requests."""
    x, y = _data()
    jm = jax_make_classifier(name, n_classes=C, in_features=F, dim=D,
                             **METHOD_KW[name]).fit(jnp.asarray(x),
                                                    jnp.asarray(y)).model
    pm = from_reference(_jax_arrays(jm), device="cpu")
    rows = (encode_batched(pm.enc, x, "cos").numpy() if encoded else x)[:23]
    jsvc = JaxClassifierService({name: jm}, max_batch=8)
    psvc = _svc({name: pm}, max_batch=8)
    jfuts = [jsvc.submit(name, r, encoded=encoded) for r in rows]
    pfuts = [psvc.submit(name, r, encoded=encoded) for r in rows]
    jsvc.run_until_drained()
    psvc.run_until_drained()
    assert [_res(f) for f in pfuts] == [f.result(timeout=T) for f in jfuts]


def test_service_raw_features_match_full_pipeline():
    clf = _fitted("loghd")
    x, _ = _data()
    svc = _svc({"loghd": clf.model}, max_batch=16)
    futs = [svc.submit("loghd", x[i]) for i in range(9)]
    assert svc.run_until_drained() == 9
    assert [_res(f) for f in futs] == _labels(clf, x[:9])


def test_service_multi_model_side_by_side():
    conv, log = _fitted("conventional"), _fitted("loghd")
    x, _ = _data()
    svc = _svc({"conv": conv.model, "loghd": log.model}, max_batch=8)
    futs = {}
    for i in range(10):
        name = "conv" if i % 2 else "loghd"
        futs[i] = (name, svc.submit(name, x[i]))
    svc.run_until_drained()
    conv_labels, log_labels = _labels(conv, x[:10]), _labels(log, x[:10])
    for i, (name, fut) in futs.items():
        want = conv_labels[i] if name == "conv" else log_labels[i]
        assert _res(fut) == want, (i, name)


def test_warmup_visits_every_bucket():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=8, buckets=(1, 2, 4, 8))
    assert svc.warmup() == 4
    assert svc.bucket_cache.executables() == 4
    misses = svc.bucket_cache.stats.misses
    for n in (1, 3, 8, 5):
        futs = [svc.submit("m", x[i]) for i in range(n)]
        svc.run_until_drained()
        [_res(f) for f in futs]
    assert svc.bucket_cache.stats.misses == misses
    assert svc.bucket_cache.executables() == 4


def test_service_validation(monkeypatch):
    svc = _svc(max_batch=4)
    with pytest.raises(KeyError):
        svc.submit("nope", np.zeros(3))
    with pytest.raises(TypeError):
        svc.register("bad", {"protos": np.zeros((2, 3))})
    assert svc.stats()["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierService(max_batch=4)          # device=None means "cuda"


def test_served_rows_do_not_depend_on_the_batch():
    """Each request's label is the same whether it is served alone, in a
    full bucket or in a padded one; the CPU route counts no launch."""
    clf = _fitted("loghd")
    x, _ = _data()
    common.reset_launches()
    want = _labels(clf, x[:13])
    for max_batch in (1, 4, 16):
        svc = _svc({"m": clf.model}, max_batch=max_batch)
        futs = [svc.submit("m", x[i]) for i in range(13)]
        svc.run_until_drained(block=True)
        assert [_res(f) for f in futs] == want, max_batch
    assert sum(common.launches.values()) == 0


def test_bounded_queue_backpressure():
    q = RequestQueue(max_depth=3)
    futs = [q.push(_req(q, "m")) for _ in range(3)]
    with pytest.raises(QueueFullError):
        q.push(_req(q, "m"))
    with pytest.raises(QueueFullError):
        q.push(_req(q, "other"))
    assert q.rejected == 2 and len(q) == 3
    assert q.admit(2) and len(q) == 1
    q.push(_req(q, "m"))
    assert len(q) == 2 and q.rejected == 2
    for f in futs:
        assert not f.cancelled()
    with pytest.raises(ValueError):
        RequestQueue(max_depth=0)


def test_service_backpressure_counted_in_stats():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=4, max_depth=2)
    svc.submit("m", x[0])
    svc.submit("m", x[1])
    with pytest.raises(QueueFullError):
        svc.submit("m", x[2])
    st = svc.stats()
    assert st["rejected"] == 1 and st["max_depth"] == 2 and st["queued"] == 2
    svc.run_until_drained()
    fut = svc.submit("m", x[2])
    svc.run_until_drained()
    assert _res(fut) == _labels(clf, x[2:3])[0]


# ---------------------------------------------------------------- loadgen --

def test_closed_loop_stats_sane():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=16)
    res = closed_loop(svc, "m", x[:40])
    assert res.n_requests == 40
    assert res.rps > 0 and res.wall_s > 0
    assert res.p50_ms <= res.p99_ms <= res.max_ms + 1e-9
    assert svc.stats()["cycles"] == 3


def test_open_loop_poisson_completes_all_requests():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=16)
    res = open_loop_poisson(svc, "m", x[:16], rate_rps=2000.0,
                            n_requests=25, seed=1)
    assert res.n_requests == 25
    assert res.n_rejected == 0
    assert res.p50_ms <= res.p99_ms
    assert len(svc.queue) == 0


def test_open_loop_counts_rejections_under_bounded_queue():
    clf = _fitted("conventional")
    x, _ = _data()
    svc = _svc({"m": clf.model}, max_batch=1, max_depth=1)
    n = 30
    res = open_loop_poisson(svc, "m", x[:8], rate_rps=50_000.0,
                            n_requests=n, seed=3)
    assert res.n_requests + res.n_rejected == n
    assert res.n_rejected > 0
    assert res.n_rejected == svc.stats()["rejected"]
    assert len(svc.queue) == 0
    assert "n_rejected" in res.to_record()

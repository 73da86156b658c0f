"""decode_roofline.classify: the activations and decode layer's share of
its roofline.

Device time of the kernels and copies launched inside the harness range
``perfbench.predict_encoded`` (``api/dispatch.predict_encoded`` ->
``kernels/bundle_sim``, ``kernels/profile_decode``, the argmax), against
each call's max(2 B D n + 3 B C n operations at the dense TF32 peak, its
bytes at the HBM rate), the bytes being h (B, D), the bundles (n, D) and
the profiles (C, n) read once, float32, and the int64 labels (B,) written
once.
"""

from perfbench.frozen import peaks

PEAK = "H100 dense TF32 tensor-core flop/s and HBM bytes/s (SXM: 495e12, 3.35e12)"


def ops_bytes(cfg: dict, traffic: dict) -> tuple:
    b, d = traffic["batch_rows"], cfg["dim"]
    n, c = cfg["n_bundles"], cfg["n_classes"]
    return (2.0 * b * d * n + 3.0 * b * c * n,
            4.0 * (b * d + n * d + c * n) + 8.0 * b)


def read(ctx):
    calls = ctx.traced.span_count("perfbench.predict_encoded")
    busy = ctx.traced.device_s("perfbench.predict_encoded")
    if not calls or busy <= 0:
        return None
    ops, n_bytes = ops_bytes(ctx.config, ctx.traffic)
    return 100.0 * calls * peaks.bound_s(ctx.card, ops, n_bytes, "tf32") / busy

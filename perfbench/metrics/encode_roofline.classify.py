"""encode_roofline.classify: the encode layer's share of its roofline.

Device time of the kernels and copies launched inside the harness range
``perfbench.encode`` (``HDClassifier.encode`` -> ``hdc/encoders`` ->
``kernels/hdc_encode``), against the least time the card could take for
those calls: each call's max(2 B F D operations at the dense TF32 peak,
its bytes at the HBM rate), the bytes being x (B, F), W (F, D), the bias
and the centre (D,) read once and h (B, D) written once, all float32.
"""

from perfbench.frozen import peaks

PEAK = "H100 dense TF32 tensor-core flop/s and HBM bytes/s (SXM: 495e12, 3.35e12)"


def ops_bytes(cfg: dict, traffic: dict) -> tuple:
    b, f, d = traffic["batch_rows"], cfg["n_features"], cfg["dim"]
    return 2.0 * b * f * d, 4.0 * (b * f + f * d + 2 * d + b * d)


def read(ctx):
    calls = ctx.traced.span_count("perfbench.encode")
    busy = ctx.traced.device_s("perfbench.encode")
    if not calls or busy <= 0:
        return None
    ops, n_bytes = ops_bytes(ctx.config, ctx.traffic)
    return 100.0 * calls * peaks.bound_s(ctx.card, ops, n_bytes, "tf32") / busy

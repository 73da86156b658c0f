"""classify_mfu: the predict step's share of the card's peak.

(2 B F D + 2 B D n + 3 B C n) operations a call (encode, activations,
profile decode: the same work whatever implements it) times the calls of
the traced window, over the window's seconds, against the dense TF32
peak.
"""

from perfbench.frozen import peaks

PEAK = "H100 dense TF32 tensor-core flop/s (SXM: 495e12)"


def ops(cfg: dict, traffic: dict) -> float:
    b, f, d = traffic["batch_rows"], cfg["n_features"], cfg["dim"]
    n, c = cfg["n_bundles"], cfg["n_classes"]
    return 2.0 * b * f * d + 2.0 * b * d * n + 3.0 * b * c * n


def read(ctx):
    calls = ctx.counts.get("calls", 0)
    if not calls:
        return None
    rate = calls * ops(ctx.config, ctx.traffic) / ctx.traced.window_s
    return 100.0 * rate / peaks.rates(ctx.card)["tf32"]

"""Offline batched classification from raw features (family "classifier").

Set-up makes the rows from the seed (the frozen surrogate: the training
split and ``pool_batches`` distinct batches of ``batch_rows`` rows, on the
card), draws the encoder's projection and bias on the card and the
refinement orders on the host, fits the classifier through the program's
public entry, and runs two warm calls.  The window is a closed loop of at
most ``in_flight`` calls: each call encodes one pool batch
(``HDClassifier.encode``) and predicts it (``predict_encoded``), and its
labels are copied to pinned host memory; the host waits only to collect
the oldest call's labels.

The check: the calls whose index the seed samples (one in
``sample_every``, and the first pass over the pool) keep their labels,
and the first ``h_calls`` of them their encodings.  The reference
(``perfbench/reference/classifier.py``) fits again from the same draws
and encodes the pool; compared are the codebook (rows that differ), the
fitted state (bundles, profiles, centre: the largest difference over the
largest value of each), the kept encodings (largest difference) and the
kept labels (``label_gap``: by how much a label's reference score lies
below the reference's best score, at most).
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from perfbench.frozen import synth
from perfbench.reference import classifier as ref
from perfbench.reference.precision import TF32


def draws(cfg: dict, seed: int, device, n_train: int):
    """The fit's random inputs: projection (F, D) and bias (D,) from a
    generator on `device`, and the (epochs, N) refinement orders from a
    host generator, all from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f, d = cfg["n_features"], cfg["dim"]
    proj = torch.randn((f, d), generator=gen, device=device)
    proj /= math.sqrt(f) * cfg["bandwidth"]
    bias = torch.rand((d,), generator=gen, device=device) * (2.0 * math.pi)
    host = torch.Generator().manual_seed(seed)
    perms = torch.stack([torch.randperm(n_train, generator=host)
                         for _ in range(cfg["refine_epochs"])])
    return proj, bias, perms


class Port:
    """The program: ``repro_torch``'s classifier entry points."""

    name = "repro_torch"

    def __init__(self, device):
        self.device = device
        self.clf = None

    def fit(self, cfg: dict, x, y, proj, bias, perms, seed: int) -> None:
        from repro_torch.api import make_classifier
        from repro_torch.hdc.encoders import EncoderConfig, fit_encoder
        enc_cfg = EncoderConfig(cfg["n_features"], cfg["dim"], cfg["encoder"],
                                bandwidth=cfg["bandwidth"])
        clf = make_classifier(
            cfg["method"], cfg["n_classes"], enc_cfg=enc_cfg,
            device=self.device, k=cfg["k"],
            extra_bundles=cfg["extra_bundles"], alpha=cfg["alpha"],
            refine_epochs=cfg["refine_epochs"], lr=cfg["lr"],
            refine_batch=cfg["refine_batch"], metric=cfg["metric"],
            codebook_method=cfg["codebook"], bipolar_init=cfg["bipolar_init"],
            seed=seed)
        if clf.cfg.n_bundles != cfg["n_bundles"]:
            raise ValueError(f"the program makes {clf.cfg.n_bundles} bundles, "
                             f"the configuration states {cfg['n_bundles']}")
        enc, h = fit_encoder(enc_cfg, x, device=self.device, proj=proj,
                             bias=bias)
        self.clf = clf.fit(x, y, enc=enc, encoded=h, perms=perms)

    def encode(self, x):
        return self.clf.encode(x)

    def predict_encoded(self, h):
        return self.clf.predict_encoded(h)

    def state(self) -> dict:
        m = self.clf.model
        return {"center": m.enc["center"], "bundles": m.bundles,
                "profiles": m.profiles,
                "codebook": np.asarray(torch.as_tensor(m.codebook).cpu())}

    def release(self) -> None:
        self.clf = None


class Control:
    """The reference in the program's place, its products in TF32: the
    control that the check has to fail."""

    name = "reference at tf32"

    def __init__(self, cfg: dict, device):
        self.st = None

    def fit(self, cfg, x, y, proj, bias, perms, seed) -> None:
        self.st = ref.fit(x, y, proj, bias, perms, cfg, seed, TF32)

    def encode(self, x):
        return ref.encode(self.st, x, TF32)

    def predict_encoded(self, h):
        return ref.predict(self.st, h, TF32)

    def state(self) -> dict:
        return {"center": self.st.center, "bundles": self.st.bundles,
                "profiles": self.st.profiles, "codebook": self.st.codebook}

    def release(self) -> None:
        self.st = None


CONTROL = Control


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


class Classify:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, system):
        if cfg["family"] != "classifier":
            raise ValueError(f"{cfg['name']} is no classifier configuration")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.system = system if system is not None else Port(device)
        self.rows = traffic["batch_rows"]
        self.kept: dict = {}
        self.kept_h: dict = {}

    # ----------------------------------------------------------- set-up

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        x_tr, y_tr, x_pool, y_pool, spec = synth.load_pool(
            cfg["dataset"], self.traffic["pool_batches"], seed=self.seed,
            max_train=cfg["n_train"], batch_rows=self.rows)
        if (spec.n_features, spec.n_classes) != (cfg["n_features"],
                                                 cfg["n_classes"]):
            raise ValueError(f"the {cfg['dataset']} surrogate is "
                             f"({spec.n_features}, {spec.n_classes}), the "
                             f"configuration states ({cfg['n_features']}, "
                             f"{cfg['n_classes']})")
        self.x_tr = torch.from_numpy(x_tr).to(dev)
        self.y_tr = torch.from_numpy(y_tr).to(dev)
        self.pool = torch.from_numpy(x_pool).to(dev)
        self.proj, self.bias, self.perms = draws(cfg, self.seed, dev,
                                                 x_tr.shape[0])
        self.system.fit(cfg, self.x_tr, self.y_tr, self.proj, self.bias,
                        self.perms, self.seed)
        on_card = dev.type == "cuda"
        n = self.traffic["in_flight"]
        self.host = [torch.empty(self.rows, dtype=torch.int64,
                                 pin_memory=on_card) for _ in range(n)]
        for i in range(2):          # warm calls: the window's one shape
            self.system.predict_encoded(self.system.encode(self.pool[i]))

    # ----------------------------------------------------------- window

    def _sampled(self, i: int) -> bool:
        every = self.traffic["sample_every"]
        return (i < self.pool.shape[0]
                or (i * 2654435761 + self.seed) % every == 0)

    def window(self, seconds: float, span) -> dict:
        on_card = self.device.type == "cuda"
        n_flight, pool = self.traffic["in_flight"], self.pool
        pending: collections.deque = collections.deque()
        self.kept, self.kept_h = {}, {}
        h_calls = self.traffic["h_calls"]
        done = issued = 0

        def collect():
            nonlocal done
            i, buf, ev = pending.popleft()
            with span("perfbench.collect"):
                if ev is not None:
                    ev.synchronize()
                if self._sampled(i):
                    self.kept[i] = buf.numpy().copy()
            done += 1

        with span("perfbench.window"):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                if len(pending) == n_flight:
                    collect()
                i = issued
                with span("perfbench.encode"):
                    h = self.system.encode(pool[i % pool.shape[0]])
                with span("perfbench.predict_encoded"):
                    labels = self.system.predict_encoded(h)
                buf = self.host[i % n_flight]
                buf.copy_(labels, non_blocking=on_card)
                ev = None
                if on_card:
                    ev = torch.cuda.Event()
                    ev.record()
                if self._sampled(i) and len(self.kept_h) < h_calls:
                    self.kept_h[i] = h
                pending.append((i, buf, ev))
                issued += 1
            while pending:
                collect()
            elapsed = time.perf_counter() - t0
        return {"attempted": issued * self.rows, "failed": 0,
                "elapsed": elapsed, "done_rows": done * self.rows,
                "counts": {"calls": issued, "rows": self.rows}}

    def end_to_end(self, stats: dict) -> dict:
        return {"classify_rows_s": stats["done_rows"] / stats["elapsed"]}

    # ------------------------------------------------------------ check

    def release(self) -> None:
        """Keep the fitted state the check compares and free the rest."""
        self.prog_state = self.system.state()
        self.system.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        cfg, lim = self.cfg, self.cfg["limits"]
        want = ref.fit(self.x_tr, self.y_tr, self.proj, self.bias,
                       self.perms, cfg, self.seed)
        got = self.prog_state
        code_diff = int((np.asarray(got["codebook"])
                         != want.codebook).any(axis=1).sum())
        state_err = max(_max_rel(got[k], getattr(want, k))
                        for k in ("bundles", "profiles", "center"))
        n_pool = self.pool.shape[0]
        enc_err = 0.0
        gap = 0.0
        for b in sorted({i % n_pool for i in self.kept}):
            h_ref = ref.encode(want, self.pool[b])
            for i, h in self.kept_h.items():
                if i % n_pool == b:
                    enc_err = max(enc_err, float((h - h_ref).abs().max()))
            s = ref.scores(want, h_ref)
            best = s.max(dim=-1).values
            for i, labels in self.kept.items():
                if i % n_pool == b:
                    lab = torch.as_tensor(labels, device=s.device)
                    picked = s.gather(1, lab[:, None].long())[:, 0]
                    gap = max(gap, float((best - picked).max()))
        return {"codebook_differ": {"value": code_diff,
                                    "limit": lim["codebook_differ"]},
                "state_err": {"value": state_err, "limit": lim["state_err"]},
                "enc_err": {"value": enc_err, "limit": lim["enc_err"]},
                "label_gap": {"value": gap, "limit": lim["label_gap"]}}


def build(cfg: dict, traffic: dict, seed: int, device, system=None):
    return Classify(cfg, traffic, seed, device, system)

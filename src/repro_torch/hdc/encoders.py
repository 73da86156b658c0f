"""HDC encoders: feature vector -> D-dimensional hypervector (port of
``repro.hdc.encoders``).

  * "cos"     phi(x) = cos(x W + b) * sin(x W)
  * "rp"      phi(x) = x W
  * "rp_sign" phi(x) = sign(x W)

Outputs are L2-normalised, the train-calibrated DC component ``center`` is
removed, and the result is normalised again, as in the JAX package.

``encode`` goes through ``kernels.hdc_encode``: on a CUDA device the
hand-written kernel computes the product, the nonlinearity and both
normalisations; on the CPU its plain version computes what the JAX
package's ``encode`` does, in full float32 (``precision.full_f32``).  The
kernel encodes each row the same way whatever the batch, so a row's bits
do not depend on how many rows it was encoded with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import torch

from repro_torch.hdc.conventional import l2_normalize
from repro_torch.kernels.hdc_encode.ops import hdc_encode
from repro_torch.precision import full_f32

EncoderKind = Literal["cos", "rp", "rp_sign"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    in_features: int
    dim: int = 10_000            # D; paper default D = 10,000
    kind: EncoderKind = "cos"
    bandwidth: float = 2.0       # z = xW / bandwidth
    seed: int = 0

    def memory_bits(self, bits: int = 32) -> int:
        """Bits of the shared encoder: the projection, and the bias of
        "cos".  The paper does not count it against a model's budget."""
        n_bias = self.dim if self.kind == "cos" else 0
        return (self.in_features * self.dim + n_bias) * bits


def init_encoder(cfg: EncoderConfig, *, device,
                 generator: Optional[torch.Generator] = None,
                 proj: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> dict:
    """W ~ N(0, 1) / (sqrt(F) * bandwidth), b ~ U[0, 2*pi), center = 0.

    Draws from `generator` (default: a generator on `device` seeded with
    ``cfg.seed``).  ``proj``/``bias`` may be injected instead — the JAX
    package draws them from threefry, which no torch generator reproduces —
    and are then taken as they are (bandwidth already folded in)."""
    device = torch.device(device)
    if generator is None and (proj is None or bias is None):
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    if proj is None:
        proj = torch.randn((cfg.in_features, cfg.dim), generator=generator,
                           device=device)
        proj = proj / (math.sqrt(cfg.in_features) * cfg.bandwidth)
    if bias is None:
        bias = torch.rand((cfg.dim,), generator=generator,
                          device=device) * (2.0 * math.pi)
    return {"proj": torch.as_tensor(proj, dtype=torch.float32, device=device),
            "bias": torch.as_tensor(bias, dtype=torch.float32, device=device),
            "center": torch.zeros((cfg.dim,), device=device)}


@full_f32()
def encode(params: dict, x: torch.Tensor, kind: EncoderKind = "cos"
           ) -> torch.Tensor:
    """phi(x): (..., F) -> (..., D), L2-normalized float32."""
    proj = params["proj"]
    x = torch.as_tensor(x, dtype=torch.float32, device=proj.device)
    h = hdc_encode(x.reshape(-1, x.shape[-1]).contiguous(), proj.contiguous(),
                   params["bias"].contiguous(), params["center"].contiguous(),
                   kind)
    return h.reshape(*x.shape[:-1], proj.shape[1])


def encode_batched(params: dict, x: torch.Tensor, kind: EncoderKind,
                   batch_size: int = 4096) -> torch.Tensor:
    """Streaming encode for large N (bounds peak memory at batch_size * D)."""
    n = x.shape[0]
    if n <= batch_size:
        return encode(params, x, kind)
    return torch.cat([encode(params, x[i:i + batch_size], kind)
                      for i in range(0, n, batch_size)])


def fit_encoder(cfg: EncoderConfig, x_train, *, device,
                generator: Optional[torch.Generator] = None,
                proj: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None):
    """Initialise the encoder and calibrate its DC-removal ``center`` on the
    training set.  Returns (params, h_train), h_train centered and
    re-normalized."""
    params = init_encoder(cfg, device=device, generator=generator, proj=proj,
                          bias=bias)
    h = encode_batched(params, x_train, cfg.kind)   # center = 0: l2n(phi)
    center = h.mean(dim=0)
    return {**params, "center": center}, l2_normalize(h - center)

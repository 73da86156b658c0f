"""Published peaks of the NVIDIA H100 (Tensor Core GPU data sheet, dense
rates without sparsity), frozen for the benchmark's rooflines and MFUs.

Float32 products are held to the dense TF32 peak: no product of float32
inputs on this card runs faster than that, whatever method a kernel uses
(3xTF32 does three TF32 products per float32 one), so a share against it
cannot pass 100% by a change of method.  These peaks assume the full power
limit of 700 W; every share is reported beside the card's own limit.
"""

from __future__ import annotations

# bytes: HBM bytes/s; float32: flop/s outside the tensor cores; tf32 and
# bf16: dense tensor-core flop/s
RATES = {
    # H100 SXM5 80 GB (HBM3): 3.35 TB/s, FP32 67 TF, TF32 495 TF, BF16 989 TF
    "SXM": {"bytes": 3.35e12, "float32": 67e12, "tf32": 495e12,
            "bf16": 989e12},
    # H100 PCIe 80 GB (HBM2e): 2.0 TB/s, FP32 51 TF, TF32 378 TF, BF16 756 TF
    "PCIe": {"bytes": 2.0e12, "float32": 51e12, "tf32": 378e12,
             "bf16": 756e12},
}


def part(card: str) -> str:
    """The data sheet's part for a card name: "PCIe" by name, else "SXM"."""
    return "PCIe" if "PCIe" in card else "SXM"


def rates(card: str) -> dict:
    """The peaks of the card named `card` (``torch.cuda.get_device_name``)."""
    return RATES[part(card)]


def bound_s(card: str, ops: float, n_bytes: float, unit: str) -> float:
    """The least seconds the card could take: the larger of `ops` at the
    `unit` peak ("tf32", "bf16", "float32") and `n_bytes` at the HBM rate."""
    r = rates(card)
    return max(ops / r[unit], n_bytes / r["bytes"])

"""Routing and bookkeeping shared by the port's kernel wrappers.

The rule that replaces ``repro.api.dispatch.kernels_qualify``: a tensor on
the CPU goes to the kernel's plain PyTorch version, a tensor on a CUDA
device of compute capability 9.0 or above goes to the hand-written kernel,
and anything else raises.  Nothing falls back: a CUDA tensor reaches the
kernel or the call fails.  The predict path adds the metric: only "l2" has
kernels, so "cos" and "maha" stay plain torch on both devices, as the JAX
package sends them to jnp on a TPU.

The TPU padding rules of the JAX package (sublane multiples, (8, 128)
tiles) have no counterpart: the CUDA kernels mask their ragged edges.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

# Launches per kernel name, counted by each wrapper where it launches its
# kernel and nowhere else; the plain versions never count.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


# Programmatic dependent launch (PDL, Hopper): loghd_head's score stage, and
# profile_decode where its caller asks, start under the tail of the kernel
# before them and wait for it (griddepcontrol.wait) before they read its
# output.  On by default; off only to measure what it saves.
_pdl = [True]


def pdl_enabled() -> bool:
    return _pdl[0]


@contextlib.contextmanager
def pdl(enabled: bool):
    """Launch the chained kernels with (True) or without (False) the PDL
    attribute inside the block; the results are the same bits."""
    before = _pdl[0]
    _pdl[0] = bool(enabled)
    try:
        yield
    finally:
        _pdl[0] = before


def resolve_device(device=None) -> torch.device:
    """An entry point's device: None means "cuda", and a CUDA device that is
    not there raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the card "
            "unless the caller asks for the CPU with device='cpu'")
    return dev


@functools.cache
def _capability(index: int) -> tuple:
    return torch.cuda.get_device_capability(index)


def kernel_device(dev: torch.device) -> bool:
    """True when work on `dev` goes to the CUDA kernels, False for the plain
    versions (CPU).  Raises for devices other than CPU and CUDA, and for
    CUDA devices below compute capability 9.0."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {dev}")
    cap = _capability(dev.index if dev.index is not None
                      else torch.cuda.current_device())
    if cap < (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}")
    return True


def on_card(*tensors: torch.Tensor) -> bool:
    """A wrapper's route: the kernel for CUDA tensors, the plain version for
    CPU tensors; tensors on different devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on different devices: {sorted(map(str, devices))}")
    return kernel_device(devices.pop())


def use_kernels(device, metric: str = "l2") -> bool:
    """The predict path's rule: the l2 metric on a CUDA device goes to the
    kernels; cos and maha stay plain torch on every device."""
    return metric == "l2" and kernel_device(torch.device(device))


def require(t: torch.Tensor, name: str, dtypes: tuple, ndim: int) -> None:
    """Raise unless `t` is a contiguous tensor the kernel takes."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")

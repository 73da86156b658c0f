"""Optimiser-side helpers of the port (``repro.optim``'s counterpart): the
int8 error-feedback all-reduce."""

from repro_torch.optim.grad_compress import (compressed_psum,
                                             init_error_buffers)

__all__ = ["compressed_psum", "init_error_buffers"]

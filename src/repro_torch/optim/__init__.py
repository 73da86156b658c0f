"""The optimizer side of the port (``repro.optim``'s counterpart): AdamW
with float32 or int8 moments, the cosine LR schedule, and the int8
error-feedback all-reduce."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (compressed_psum,
                                             init_error_buffers)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compressed_psum", "init_error_buffers"]

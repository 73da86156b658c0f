from repro_torch.kernels.flash_attn.ops import PAIRS, flash_attn, takes
from repro_torch.kernels.flash_attn.ref import (flash_attn_bwd_ref,
                                                flash_attn_ref)

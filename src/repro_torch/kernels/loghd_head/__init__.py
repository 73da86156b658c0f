from repro_torch.kernels.loghd_head.ops import (MAX_N, loghd_head_autograd,
                                                loghd_head_logits)
from repro_torch.kernels.loghd_head.ref import (loghd_head_logits_ref,
                                                loghd_head_parts_ref)

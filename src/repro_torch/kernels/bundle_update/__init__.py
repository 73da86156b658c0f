from repro_torch.kernels.bundle_update.ops import bundle_update
from repro_torch.kernels.bundle_update.ref import bundle_update_ref

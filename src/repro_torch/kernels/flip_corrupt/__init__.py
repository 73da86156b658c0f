from repro_torch.kernels.flip_corrupt.ops import flip_corrupt
from repro_torch.kernels.flip_corrupt.ref import flip_corrupt_ref

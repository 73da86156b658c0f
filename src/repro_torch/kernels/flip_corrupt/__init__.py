from repro_torch.kernels.flip_corrupt.ops import flip_corrupt, flip_corrupt_grid
from repro_torch.kernels.flip_corrupt.ref import (flip_corrupt_grid_ref,
                                                  flip_corrupt_ref)

from repro_torch.kernels.bundle_sim.ops import bundle_similarity
from repro_torch.kernels.bundle_sim.ref import bundle_similarity_ref

"""LogHD core math (port of ``repro.core``): codebook, bundling, profiles,
quantization, stored-bit faults and the fault-sweep harness.

Submodules:
  codebook   -- capacity-aware k-ary codebook (Eq. 2-3)
  bundling   -- weighted superposition + perceptron refinement (Eq. 4, 8-9)
  profiles   -- activation vectors + per-class profiles + decode (Eq. 5-7)
  loghd      -- LogHD configuration + memory/budget accounting
  sparsehd   -- feature-axis baseline (SparseHD) config + pruning math
  hybrid     -- class-axis + feature-axis composition config
  quantize   -- QuantHD-style post-training quantization (1/2/4/8 bit)
  faults     -- stored-bit flip injection (exact integer-code semantics)
  evaluate   -- the fault-sweep engine

The package exports the reference's names; training and prediction go
through ``repro_torch.api``.
"""

from repro_torch.core.codebook import build_codebook, bundle_loads, min_bundles
from repro_torch.core.bundling import (build_bundles, refine_bundles,
                                       symbol_targets)
from repro_torch.core.profiles import (activations, decode_profiles,
                                       estimate_profiles, profile_scores)
from repro_torch.core.loghd import (LogHDConfig, conventional_memory_bits,
                                    max_bundles_for_budget, memory_bits)
from repro_torch.core.sparsehd import (SparseHDConfig, dimension_saliency,
                                       keep_indices, sparsity_for_budget)
from repro_torch.core.hybrid import HybridConfig
from repro_torch.core.quantize import QTensor, dequantize, quantize
from repro_torch.core.faults import (corrupt_model, flip_bits_f32,
                                     flip_bits_int)

__all__ = ["build_codebook", "bundle_loads", "min_bundles", "build_bundles",
           "refine_bundles", "symbol_targets", "activations",
           "decode_profiles", "estimate_profiles", "profile_scores",
           "LogHDConfig", "conventional_memory_bits",
           "max_bundles_for_budget", "memory_bits", "SparseHDConfig",
           "dimension_saliency", "keep_indices", "sparsity_for_budget",
           "HybridConfig", "QTensor", "dequantize", "quantize",
           "corrupt_model", "flip_bits_f32", "flip_bits_int"]

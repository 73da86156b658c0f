"""LogHD core math (port of ``repro.core``): codebook, bundling, profiles,
quantization, stored-bit faults and the fault-sweep harness."""

"""repro_torch — the PyTorch / CUDA port of the LogHD reproduction.

Mirrors ``repro``'s subpackages (``data``, ``hdc``, ``core``, ``api``,
``kernels``) module for module.  It imports torch and numpy, never jax and
never ``repro``; entry points run on the CUDA card unless the caller asks
for the CPU with ``device="cpu"``.
"""

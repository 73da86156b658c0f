"""Plain PyTorch and NumPy references of what the benchmark's cells run.

Nothing here imports the program (``repro_torch``) or the JAX package:
each reference takes the benchmark's own inputs and derives everything
else (encoder centre, codebook, bundles, profiles; activations, gradients,
optimizer state) itself, in float32 with the card's TF32 switched off.
``precision.py`` holds the rounding of the controls: the same references
computed one precision below the one a configuration states.
"""

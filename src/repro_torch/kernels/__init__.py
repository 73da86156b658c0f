"""Hand-written CUDA kernels of the port, one per Pallas TPU kernel on the
main path, each with a plain PyTorch version beside it:

  bundle_sim       query x bundle cosine similarity   (predict)
  profile_decode   -||A - P_c||^2 decode scores        (predict)
  flip_corrupt     PRNG -> XOR -> sign-extend -> f32   (fault sweep)
  bundle_update    l2n(M + lr C^T H) minibatch step    (training)
  hdc_encode       l2n(l2n(nonlin(x W)) - center)      (every encode)
  loghd_head       -||h M^T - P_v||^2 vocab logits     (LM head)

and one that replaces no Pallas kernel but the routing's ``jnp.cumsum``
over the one-hot of the chosen experts:

  moe_slots        each choice's capacity slot         (MoE routing)

Sources are ``csrc/*.cu``, built for sm_90a at first use (``_build``).
Wrappers route by device (``common``): CPU tensors take the plain version,
CUDA tensors the kernel.  ``common.launches`` counts kernel launches.
"""

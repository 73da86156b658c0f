"""The decoder LM of the port (``repro.models`` for the attn / attn_local
mixers and the dense ffn): ``layers``, ``attention``, ``model``, and
``convert``, the weight exchange with the JAX package."""

from repro_torch.models.model import (DecoderLM, Model, decode_step, forward,
                                      init_decode_state, init_params, loss_fn,
                                      prefill)

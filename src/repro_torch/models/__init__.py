"""The decoder LM of the port (``repro.models``): ``layers``, the mixers
``attention`` (attn / attn_local), ``mla``, ``mamba`` and ``xlstm``
(mlstm / slstm), the ``moe`` ffn, ``model``, ``sharding`` (the layouts over
an LM mesh), and ``convert``, the weight exchange with the JAX
package."""

from repro_torch.models.model import (DecoderLM, Model, decode_step, forward,
                                      init_decode_state, init_params, loss_fn,
                                      param_specs, prefill)

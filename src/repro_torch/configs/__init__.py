"""Architecture registry: one config per assigned architecture.

A copy of ``repro.configs`` (pure data, no JAX), kept in the port because
the port imports nothing of the JAX package; ``get_config`` and
``get_smoke_config`` return values equal field for field to the
reference's (``tests/test_torch_lm.py`` checks every architecture).
``PORT_ONLY_NAMES`` are configs the reference has no counterpart of
(``deepseek-v3-ep32``: one chip's share of DeepSeek-V3, with settings on
the ``PortModelConfig`` subclass); ``get_config`` and ``get_smoke_config``
find them too, and ``ARCH_NAMES`` lists the shared ones alone.

Usage: ``from repro_torch.configs import get_config; cfg = get_config("qwen3-1.7b")``
"""

from repro_torch.configs.base import ModelConfig, BlockSpec, SHAPES, ShapeSpec

from repro_torch.configs import (qwen3_1p7b, gemma3_4b, mistral_nemo_12b,
                                 qwen15_4b, chameleon_34b, xlstm_125m,
                                 deepseek_v3_671b, granite_moe_1b,
                                 musicgen_large, jamba_52b,
                                 deepseek_v3_ep32)
from repro_torch.configs.deepseek_v3_ep32 import PortModelConfig

_REGISTRY = {}
for _m in (qwen3_1p7b, gemma3_4b, mistral_nemo_12b, qwen15_4b, chameleon_34b,
           xlstm_125m, deepseek_v3_671b, granite_moe_1b, musicgen_large,
           jamba_52b):
    _REGISTRY[_m.CONFIG.name] = _m

ARCH_NAMES = sorted(_REGISTRY)

_PORT_ONLY = {deepseek_v3_ep32.CONFIG.name: deepseek_v3_ep32}
PORT_ONLY_NAMES = sorted(_PORT_ONLY)


def _module(name: str):
    return _REGISTRY[name] if name in _REGISTRY else _PORT_ONLY[name]


def get_config(name: str, **overrides) -> ModelConfig:
    import dataclasses
    cfg = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()

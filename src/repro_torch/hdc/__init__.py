"""Hypervector encoders and conventional-HDC math (port of ``repro.hdc``)."""

from repro_torch.hdc.id_level import (IDLevelConfig, encode_id_level,
                                      fit_id_level, init_id_level,
                                      quantize_features)

__all__ = ["IDLevelConfig", "init_id_level", "quantize_features",
           "encode_id_level", "fit_id_level"]

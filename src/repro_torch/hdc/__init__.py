"""Hypervector encoders and conventional-HDC math (port of ``repro.hdc``)."""

from repro_torch.hdc.encoders import (EncoderConfig, encode, fit_encoder,
                                      init_encoder)
from repro_torch.hdc.id_level import (IDLevelConfig, encode_id_level,
                                      fit_id_level, init_id_level,
                                      quantize_features)
from repro_torch.hdc.conventional import (ConventionalConfig,
                                          class_prototypes, l2_normalize,
                                          onlinehd_epoch,
                                          predict_from_encoded)

__all__ = ["EncoderConfig", "init_encoder", "encode", "fit_encoder",
           "IDLevelConfig", "init_id_level", "quantize_features",
           "encode_id_level", "fit_id_level", "ConventionalConfig",
           "class_prototypes", "l2_normalize", "onlinehd_epoch",
           "predict_from_encoded"]

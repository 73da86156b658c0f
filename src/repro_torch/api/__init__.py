"""repro_torch.api — the typed-estimator surface of the port: the
"conventional", "sparsehd", "loghd" and "hybrid" classifier families.

    from repro_torch.api import make_classifier, dispatch
    clf = make_classifier("loghd", 26, 617, dim=10_000, k=2,
                          extra_bundles=5, refine_epochs=50)  # on "cuda"
    clf = clf.fit(x_train, y_train)
    labels = clf.predict(x_test)                # bundle_sim + profile_decode
    accs = clf.sweep_under_flips(4, [0.0, 0.1], h_test, y_test,
                                 predict_encoded=dispatch.predict_encoded)
    save_model("ckpt", 0, clf.model)            # the JAX package's layout
    model = load_model("ckpt")                  # newest step, on "cuda"

``make_classifier("loghd", ..., class_sharding=S, data_sharding=Dp)``
fits the class-sharded ``ShardedLogHDModel`` (``api/sharded.py``): profile
and codebook rows split into S blocks over the ranks of the process group
(all on one rank without one), the Eq. 9 refinement data-parallel over Dp
example shards.

The reference's ``corrupt_dequant`` and ``kernels_qualify`` have no
counterpart by design: ``corrupt_materialize`` (one batched
``flip_corrupt`` launch on the card) corrupts and dequantizes, and
``kernels/common.py`` routes by the tensors' device (the plain versions
for CPU tensors, the kernels for CUDA tensors, anything else raises).
"""

from repro_torch.api import dispatch
from repro_torch.api.checkpointing import load_model, model_spec, save_model
from repro_torch.api.convert import from_reference, to_reference
from repro_torch.api.dispatch import (clear_cache, corrupt_materialize,
                                     loghd_head_scores, predict_encoded,
                                     predict_fn, register_cache_clearer)
from repro_torch.api.models import (MODEL_CLASSES, ConventionalModel,
                                    HDModel, HybridModel, LogHDModel,
                                    SparseHDModel)
from repro_torch.api.registry import (HDClassifier, MethodSpec,
                                      available_methods, get_method,
                                      make_classifier, register_method)
from repro_torch.api.sharded import ShardedLogHDModel, shard_loghd_model
from repro_torch.core.evaluate import sweep_under_flips

__all__ = ["dispatch", "from_reference", "to_reference", "save_model",
           "load_model", "model_spec", "register_cache_clearer",
           "clear_cache", "HDModel",
           "ConventionalModel", "SparseHDModel", "LogHDModel", "HybridModel",
           "ShardedLogHDModel", "shard_loghd_model", "MODEL_CLASSES",
           "predict_fn", "predict_encoded", "loghd_head_scores",
           "corrupt_materialize",
           "HDClassifier", "MethodSpec", "available_methods",
           "get_method", "make_classifier", "register_method",
           "sweep_under_flips"]

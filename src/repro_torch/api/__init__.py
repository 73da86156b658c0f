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
"""

from repro_torch.api import dispatch
from repro_torch.api.checkpointing import load_model, model_spec, save_model
from repro_torch.api.convert import from_reference, to_reference
from repro_torch.api.dispatch import clear_cache, register_cache_clearer
from repro_torch.api.models import (ConventionalModel, HDModel, HybridModel,
                                    LogHDModel, SparseHDModel)
from repro_torch.api.registry import (HDClassifier, MethodSpec,
                                      available_methods, get_method,
                                      make_classifier, register_method)
from repro_torch.core.evaluate import sweep_under_flips

__all__ = ["dispatch", "from_reference", "to_reference", "save_model",
           "load_model", "model_spec", "register_cache_clearer",
           "clear_cache", "HDModel",
           "ConventionalModel", "SparseHDModel", "LogHDModel", "HybridModel",
           "HDClassifier", "MethodSpec", "available_methods",
           "get_method", "make_classifier", "register_method",
           "sweep_under_flips"]

"""``test_torch_lm_archs.py``'s forward, loss and gradient parity under the
LogHD vocab head (bundles and profiles through ``loghd_head_scores``'s
plain route on the CPU, its autograd backward), for granite-moe,
deepseek-v3, jamba and xlstm at float32 smoke size; the tolerances of that
module.
"""

import pytest

import test_torch_lm_archs as A


@pytest.mark.parametrize("arch", A.ARCHS)
def test_forward_loss_and_grads_match_reference_loghd(arch):
    A.check_forward_loss_and_grads(arch, "loghd")

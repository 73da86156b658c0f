from repro_torch.kernels.hdc_encode.ops import hdc_encode
from repro_torch.kernels.hdc_encode.ref import hdc_encode_plain, hdc_encode_ref

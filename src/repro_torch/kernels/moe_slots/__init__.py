from repro_torch.kernels.moe_slots.ops import MAX_EXPERTS, moe_slots
from repro_torch.kernels.moe_slots.ref import moe_slots_ref

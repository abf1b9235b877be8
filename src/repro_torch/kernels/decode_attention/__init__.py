from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_flops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_slots_ref, written_slots)

__all__ = ["decode_attention", "decode_attention_kernel", "decode_attention_flops",
           "decode_attention_ref", "decode_attention_slots_ref", "written_slots"]

from repro_torch.kernels.mla_decode.kernel import mla_decode_kernel
from repro_torch.kernels.mla_decode.ops import mla_decode_attention, mla_decode_flops
from repro_torch.kernels.mla_decode.ref import mla_decode_attention_ref

__all__ = ["mla_decode_attention", "mla_decode_kernel", "mla_decode_flops",
           "mla_decode_attention_ref"]

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                        flash_attention_kernel)
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_vjp
from repro_torch.kernels.flash_attention.ref import (attention_chunked, attention_ref,
                                                     flash_bwd_ref)

__all__ = ["flash_attention", "flash_attention_kernel", "flash_attention_bwd_kernel",
           "flash_vjp", "attention_ref", "attention_chunked", "flash_bwd_ref"]

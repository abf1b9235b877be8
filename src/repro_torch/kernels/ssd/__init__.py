from repro_torch.kernels.ssd.kernel import ssd_kernel
from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step, ssd_vjp, ssd_with_state
from repro_torch.kernels.ssd.ref import ssd_ref

__all__ = ["ssd", "ssd_decode_step", "ssd_kernel", "ssd_ref", "ssd_vjp", "ssd_with_state"]

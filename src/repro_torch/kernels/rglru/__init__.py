from repro_torch.kernels.rglru.kernel import lru_scan_kernel
from repro_torch.kernels.rglru.ops import lru_scan, lru_scan_vjp
from repro_torch.kernels.rglru.ref import lru_decode_step_ref, lru_scan_ref

__all__ = ["lru_scan", "lru_scan_kernel", "lru_scan_vjp", "lru_scan_ref",
           "lru_decode_step_ref"]

"""Public RG-LRU scan entry point (port of the reference's ``ops.py``).

A CUDA tensor goes to the hand-written kernel; a CPU tensor to the plain
version. There is no other path: the kernel raises on what it does not
take. The one-token decode step is plain PyTorch
(:func:`repro_torch.kernels.rglru.ref.lru_decode_step_ref`), as it is plain
jnp in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import lru_scan_kernel
from repro_torch.kernels.rglru.ref import lru_scan_ref

__all__ = ["lru_scan"]


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gated linear recurrence h_t = a_t h_{t-1} + b_t over (B, S, W)."""
    if a.device.type == "cuda":
        return lru_scan_kernel(a, b)
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    raise ValueError(f"lru_scan: unsupported device {a.device}")

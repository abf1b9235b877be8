"""Public flash-attention entry point (port of the reference's ``ops.py``).

Model code calls :func:`flash_attention` with (B, S, H, D) tensors, the
model's native layout, which the CUDA kernel reads directly. A CUDA tensor
goes to the hand-written kernel; a CPU tensor to the plain version. There
is no other path: the kernel raises on what it does not take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention. q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D)."""
    if q.device.type == "cuda":
        return flash_attention_kernel(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")

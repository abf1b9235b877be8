"""Plain PyTorch version of the RG-LRU linear recurrence (port of the
reference's ``kernels/rglru/ref.py``).

    h_t = a_t ⊙ h_{t-1} + b_t,   h_0 = 0

The gates live in the model (:mod:`repro_torch.models.rglru`); the scan
takes the per-step coefficients (a, b) already formed. This is the CPU path
of :func:`repro_torch.kernels.rglru.lru_scan` and the oracle the CUDA kernel
is held against on the card. It walks the sequence in order with an f32
carry, the same arithmetic as the kernel (one product, one sum per step);
the reference composes the steps with an associative scan, which rounds in
another order.
"""

from __future__ import annotations

import torch

__all__ = ["lru_scan_ref", "lru_decode_step_ref"]


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W); returns h: (B, S, W) in a's dtype, carried in f32."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(a.dtype)
    return out


def lru_decode_step_ref(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-token step. h, a, b: (B, W); returns the new h in h's dtype."""
    return (a.float() * h.float() + b.float()).to(h.dtype)

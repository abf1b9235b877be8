"""Public RG-LRU scan entry point (port of the reference's ``ops.py``).

A CUDA tensor goes to :class:`_LRUScanKernel`, whose forward is the
hand-written kernel; a CPU tensor goes to the plain version. There is no
other path: the kernel raises on what it does not take. The one-token
decode step is plain PyTorch
(:func:`repro_torch.kernels.rglru.ref.lru_decode_step_ref`), as it is plain
jnp in the reference.

The reference trains through autodiff of its plain scan (it has no backward
kernel). The adjoint of a linear recurrence is the same recurrence run
backwards, so the port's gradient rule, :func:`lru_scan_vjp`, is one more
scan: through :func:`lru_scan` itself, so on the card it launches the
kernel once more (on flipped inputs) and never walks S steps in Python.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru.kernel import lru_scan_kernel
from repro_torch.kernels.rglru.ref import lru_scan_ref

__all__ = ["lru_scan", "lru_scan_vjp"]


def lru_scan_vjp(grad_h: torch.Tensor, a: torch.Tensor, h: torch.Tensor):
    """The gradient rule of the scan h_t = a_t h_{t-1} + b_t (h_{-1} = 0),
    given a and the forward's output h, with cotangent ``grad_h`` = g:

        λ_t = g_t + a_{t+1} λ_{t+1},  λ_{S-1} = g_{S-1};
        db_t = λ_t;  da_t = λ_t h_{t-1},  h_{-1} = 0.

    λ is the forward scan of flip(g) with coefficients flip(a shifted left by
    one, a zero at the end), flipped back, taken by :func:`lru_scan` (the
    kernel on the card, the plain walk on the CPU). The product for da is
    taken in f32. Returns (da, db) in a's dtype."""
    a_next = F.pad(a[:, 1:], (0, 0, 0, 1))
    lam = lru_scan(a_next.flip(1), grad_h.flip(1)).flip(1)
    h_prev = F.pad(h[:, :-1], (0, 0, 1, 0))
    da = (lam.float() * h_prev.float()).to(a.dtype)
    return da, lam


class _LRUScanKernel(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: :func:`lru_scan_vjp`, a reversed
    scan that launches the kernel again."""

    @staticmethod
    def forward(ctx, a, b):
        h = lru_scan_kernel(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        return lru_scan_vjp(grad_h, *ctx.saved_tensors)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gated linear recurrence h_t = a_t h_{t-1} + b_t over (B, S, W)."""
    if a.device.type == "cuda":
        return _LRUScanKernel.apply(a, b)
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    raise ValueError(f"lru_scan: unsupported device {a.device}")

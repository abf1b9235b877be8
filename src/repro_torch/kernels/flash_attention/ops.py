"""Public flash-attention entry point (port of the reference's ``ops.py``).

Model code calls :func:`flash_attention` with (B, S, H, D) tensors, the
model's native layout, which the CUDA kernel reads directly. A CUDA tensor
goes to :class:`_FlashKernel`, whose forward is the hand-written kernel; a
CPU tensor goes to the plain version. There is no other path: the kernel
raises on what it does not take. The reference trains through autodiff of
its plain attention (it has no backward kernel), and the port's gradient is
the same thing written out: :func:`flash_vjp` recomputes the plain version
from the saved q, k and v and takes its vector-Jacobian product. That is
the gradient rule, not a fallback: the forward never runs the plain version
on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_vjp"]


def flash_vjp(grad_o: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *, causal: bool, window: int | None):
    """The gradient rule of the flash kernel: the vector-Jacobian product of
    :func:`attention_ref` at (q, k, v) with cotangent ``grad_o``, under the
    same causal, window and GQA masks as the forward (q head h reads kv head
    h // G). It recomputes the plain attention with autograd on, on the
    inputs' device, which is what ``jax.grad`` does through the reference's
    ``attention_ref``, and launches no kernel. Returns the gradients of
    (q, k, v), each in its input's dtype."""
    inputs = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = attention_ref(*inputs, causal=causal, window=window)
    return torch.autograd.grad(o, inputs, grad_o)


class _FlashKernel(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: :func:`flash_vjp`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_kernel(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_o):
        return (*flash_vjp(grad_o, *ctx.saved_tensors, causal=ctx.causal,
                           window=ctx.window), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention. q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D)."""
    if q.device.type == "cuda":
        return _FlashKernel.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")

"""Public SSD scan entry point (port of the reference's ``ops.py``).

A CUDA tensor goes to :class:`_SSDKernel`, whose forward is the
hand-written kernel; a CPU tensor goes to the plain version. There is no
other path: the kernel raises on what it does not take. The reference's
gradient through the scan is autodiff of plain jnp (it has no backward
kernel), and the port's is the same thing written out: :func:`ssd_vjp`
recomputes the plain chunked function from the saved inputs and takes its
vector-Jacobian product. That is the gradient rule, not a fallback: the
forward never runs the plain version on the card. The one-token decode
step is plain PyTorch (:func:`ssd_decode_step`), as it is plain jnp in the
reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_kernel
from repro_torch.kernels.ssd.ref import ssd_decode_step_ref, ssd_ref

__all__ = ["ssd", "ssd_vjp", "ssd_decode_step"]

ssd_decode_step = ssd_decode_step_ref


def ssd_vjp(grad_y: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """The gradient rule of the SSD kernel: the vector-Jacobian product of
    :func:`ssd_ref` at (x, dt, A, Bm, Cm) with cotangent ``grad_y``.

    The kernel is forward-only, as the reference's Pallas kernel is; this
    recomputes the plain chunked scan with autograd on (in PyTorch ops, on
    the inputs' device) and differentiates it, which is what ``jax.grad``
    does through the reference's ``ssd_ref``. It launches no kernel. Returns
    the gradients of (x, dt, A, Bm, Cm), each in its input's dtype."""
    inputs = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        y = ssd_ref(*inputs, chunk=chunk)
    return torch.autograd.grad(y, inputs, grad_y)


class _SSDKernel(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: :func:`ssd_vjp`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_kernel(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y):
        return (*ssd_vjp(grad_y, *ctx.saved_tensors, chunk=ctx.chunk), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """Mamba-2 SSD scan. x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,N)."""
    if x.device.type == "cuda":
        return _SSDKernel.apply(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd: unsupported device {x.device}")

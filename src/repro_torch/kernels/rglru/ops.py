"""Public RG-LRU scan entry point (port of the reference's ``ops.py``).

:func:`lru_scan` is the custom op ``repro_torch::lru_scan``, with one
implementation per device and no other path:

  cuda       the hand-written kernel (:func:`lru_scan_kernel`), which raises
             on what it does not take;
  cpu        the plain walk (:func:`lru_scan_ref`);
  fake/meta  shapes only (the dry-run on the ``meta`` device).

It carries a DTensor sharding rule (batch, or width; never the sequence;
or replicate) and a FLOP formula. The one-token decode step is plain
PyTorch (:func:`repro_torch.kernels.rglru.ref.lru_decode_step_ref`), as it
is plain jnp in the reference.

The reference trains through autodiff of its plain scan (it has no backward
kernel). The adjoint of a linear recurrence is the same recurrence run
backwards, so the port's gradient rule, :func:`lru_scan_vjp`, is one more
scan: through :func:`lru_scan` itself, so on the card it launches the
kernel once more (on flipped inputs) and never walks S steps in Python.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.rglru.kernel import lru_scan_kernel
from repro_torch.kernels.rglru.ref import lru_scan_ref
from repro_torch.kernels.sharded import layout_of, on_shards

__all__ = ["lru_scan", "lru_scan_vjp", "lru_flops"]


def lru_flops(B: int, S: int, W: int) -> int:
    """One product and one sum per element (in f32)."""
    return 2 * B * S * W


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


@torch.library.custom_op("repro_torch::lru_scan", mutates_args=())
def _lru_op(a: Tensor, b: Tensor) -> Tensor:
    raise ValueError(f"lru_scan: unsupported device {a.device}")


@_lru_op.register_kernel("cuda")
def _on_cuda(a, b):
    return lru_scan_kernel(a.contiguous(), b.contiguous())


@_lru_op.register_kernel("cpu")
def _on_cpu(a, b):
    return lru_scan_ref(a, b).contiguous()


@_lru_op.register_fake
def _(a, b):
    return torch.empty_like(a, memory_format=torch.contiguous_format)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)
    ctx.layout = layout_of(output)


def _backward(ctx, grad_h):
    """:func:`lru_scan_vjp` on each rank's shards, in the forward's layout
    (the rule's layouts: every tensor alike)."""
    lay = ctx.layout
    return on_shards(lru_scan_vjp, (lay, lay), (lay, lay, lay), grad_h, *ctx.saved_tensors)


_lru_op.register_autograd(_backward, setup_context=_setup)


@register_sharding(torch.ops.repro_torch.lru_scan.default)
def _(a, b):
    """Replicate, batch or width; never the sequence, which it scans."""
    return [([p], [p, p]) for p in (Replicate(), Shard(0), Shard(2))]


@register_flop_formula(torch.ops.repro_torch.lru_scan)
def _(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return lru_flops(*a_shape)


def lru_scan(a: Tensor, b: Tensor) -> Tensor:
    """Gated linear recurrence h_t = a_t h_{t-1} + b_t over (B, S, W)."""
    return _lru_op(a, b)

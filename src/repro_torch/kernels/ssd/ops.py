"""Public SSD scan entry point (port of the reference's ``ops.py``).

:func:`ssd` is the custom op ``repro_torch::ssd_scan``, with one
implementation per device and no other path:

  cuda       the hand-written kernel (:func:`ssd_kernel`), which raises on
             what it does not take;
  cpu        the plain chunked scan (:func:`ssd_ref`);
  fake/meta  shapes only (the dry-run on the ``meta`` device).

The reference's gradient through the scan is autodiff of plain jnp (it has
no backward kernel), and the port's is the same thing written out:
:func:`ssd_vjp`, on each rank's shards, recomputes the plain chunked
function from the saved inputs and takes its vector-Jacobian product.
That is the gradient rule, not a fallback: the forward never runs the
plain version on the card. The op carries a DTensor sharding rule (batch,
or heads; never the sequence; or replicate) and a FLOP formula. The
prefill's scan, which also returns the final state, is the plain chunked
scan (:func:`ssd_with_state`), as the reference's prefill runs its plain
``ssd_ref``; the one-token decode step is plain PyTorch
(:func:`ssd_decode_step`), as it is plain jnp in the reference.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssd.kernel import ssd_kernel
from repro_torch.kernels.sharded import layout_of, on_shards
from repro_torch.kernels.ssd.ref import ssd_decode_step_ref, ssd_ref

__all__ = ["ssd", "ssd_vjp", "ssd_with_state", "ssd_decode_step", "ssd_flops"]

ssd_decode_step = ssd_decode_step_ref


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of the SSD scan in its chunked form: C B^T once per
    (batch row, chunk) over the causal (i, j) pairs (B and C are shared by
    the heads), then per head the masked scores times u over the same
    pairs, the inter-chunk term C h^T (every chunk after the first) and the
    state update (every chunk before the last)."""
    flops = 0
    starts = range(0, S, min(chunk, S))
    for c, c0 in enumerate(starts):
        q = min(chunk, S - c0)
        pairs = q * (q + 1) // 2
        flops += 2 * B * pairs * N                      # C B^T
        flops += 2 * B * H * pairs * P                  # scores u
        if c > 0:
            flops += 2 * B * H * q * N * P              # C h^T
        if c < len(starts) - 1:
            flops += 2 * B * H * q * P * N              # state update
    return flops


def ssd_vjp(grad_y: Tensor, x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, *,
            chunk: int):
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


# ------------------------------------------------------------------ forward
@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, chunk: int) -> Tensor:
    raise ValueError(f"ssd: unsupported device {x.device}")


def _packed(x, Bm, Cm):
    """The kernel reads x packed over (H, P) and Bm, Cm over N (views of one
    projection are read in place); a shard that is not is copied."""
    P = x.shape[3]
    if x.stride(3) != 1 or x.stride(2) != P:
        x = x.contiguous()
    return x, (Bm if Bm.stride(2) == 1 else Bm.contiguous()), \
        (Cm if Cm.stride(2) == 1 else Cm.contiguous())


@_ssd_op.register_kernel("cuda")
def _on_cuda(x, dt, A, Bm, Cm, chunk):
    x, Bm, Cm = _packed(x, Bm, Cm)
    return ssd_kernel(x, dt.contiguous(), A.contiguous(), Bm, Cm, chunk=chunk)


@_ssd_op.register_kernel("cpu")
def _on_cpu(x, dt, A, Bm, Cm, chunk):
    return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk).contiguous()


@_ssd_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    return x.new_empty(x.shape)


# ------------------------------------------------------------------ sharding
def _heads_divide(x) -> bool:
    return all(x.shape[2] % n == 0 for n in x.mesh.shape)


# Per mesh dim, the layout of (x, dt, A, Bm, Cm) for each output layout
# (the forward's choice), and of their gradients: a gradient summed over
# the sharded dim (dA over the batch, dB and dC over the heads) is partial.
_IN = {Replicate(): (Replicate(),) * 5,
       Shard(0): (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0)),
       Shard(2): (Shard(2), Shard(2), Shard(0), Replicate(), Replicate())}
_GRAD = {Replicate(): (Replicate(),) * 5,
         Shard(0): (Shard(0), Shard(0), Partial(), Shard(0), Shard(0)),
         Shard(2): (Shard(2), Shard(2), Shard(0), Partial(), Partial())}


@register_sharding(torch.ops.repro_torch.ssd_scan.default)
def _(x, dt, A, Bm, Cm, chunk):
    """Replicate; batch (A replicated); heads (x, dt, A over heads; B and C,
    which the heads share, replicated). Never the sequence."""
    layouts = [Replicate(), Shard(0)] + ([Shard(2)] if _heads_divide(x) else [])
    return [([p], [*_IN[p], None]) for p in layouts]


# ----------------------------------------------------------------- backward
def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.chunk = inputs[5]
    ctx.layout = layout_of(output)


def _per_input(table: dict, layout: tuple) -> tuple:
    """Per-tensor placements from a per-mesh-dim layout."""
    return tuple(zip(*(table[p] for p in layout)))


def _backward(ctx, grad_y):
    """:func:`ssd_vjp` on each rank's shards, laid out as the forward's
    sharding rule laid them out."""
    rule = functools.partial(ssd_vjp, chunk=ctx.chunk)
    if ctx.layout is None:
        return (*rule(grad_y, *ctx.saved_tensors), None)
    ins = (ctx.layout, *_per_input(_IN, ctx.layout))
    return (*on_shards(rule, _per_input(_GRAD, ctx.layout), ins, grad_y, *ctx.saved_tensors),
            None)


_ssd_op.register_autograd(_backward, setup_context=_setup)


# --------------------------------------------------------------------- FLOPs
@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args, out_shape=None, **kwargs):
    B, S, H, P = x_shape
    return ssd_flops(B, S, H, P, B_shape[2], chunk)


def ssd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, *,
        chunk: int = 256) -> Tensor:
    """Mamba-2 SSD scan. x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,N)."""
    return _ssd_op(x, dt, A, Bm, Cm, chunk)


# Per mesh dim, the final state's (B, H, P, N) placement for each layout.
_STATE = {Replicate(): Replicate(), Shard(0): Shard(0), Shard(2): Shard(1)}


def ssd_with_state(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, *,
                   chunk: int = 256) -> tuple[Tensor, Tensor]:
    """The prefill's scan: :func:`ssd_ref` with the final state (B, H, P, N)
    in f32, which the kernel does not return. On DTensors it runs on each
    rank's shards, laid out as the op's sharding rule lays them out: per
    mesh dim, the batch or the heads where x is sharded so, else
    replicated."""
    rule = functools.partial(ssd_ref, chunk=chunk, return_state=True)
    if not isinstance(x, DTensor):
        return rule(x, dt, A, Bm, Cm)
    layout = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements)
    outs = (layout, tuple(_STATE[p] for p in layout))
    return on_shards(rule, outs, _per_input(_IN, layout), x, dt, A, Bm, Cm)

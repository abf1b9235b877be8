"""Public flash-attention entry point (port of the reference's ``ops.py``).

Model code calls :func:`flash_attention` with (B, S, H, D) tensors, the
model's native layout, which the CUDA kernel reads directly. It is the
custom op ``repro_torch::flash_attention``, with one implementation per
device and no other path:

  cuda       the hand-written kernel (:func:`flash_attention_kernel`), which
             raises on what it does not take;
  cpu        the plain version (:func:`attention_ref`);
  fake/meta  shapes only (the dry-run on the ``meta`` device).

Its gradient is :func:`flash_vjp`, on each rank's shards: the reference
trains through autodiff of its plain attention (it has no backward
kernel), and the rule recomputes the plain version from the saved q, k and
v and takes its vector-Jacobian product. That is the gradient rule, not a
fallback: the forward never runs the plain version on the card.

The op carries a DTensor sharding rule (batch; q and kv heads together;
never the sequence; or replicate) and a FLOP formula, so a sharded step
runs each rank's shard through the kernel and the dry-run counts it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.sharded import layout_of, on_shards

__all__ = ["flash_attention", "flash_vjp", "attention_pairs", "attention_flops"]


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(q, k) pairs the mask keeps, q and k positions both counted from 0."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(0, hi - lo).sum())


def attention_flops(B: int, Sq: int, Sk: int, H: int, D: int, causal: bool,
                    window: int | None) -> int:
    """QK^T and PV over the (q, k) pairs the mask keeps."""
    return 4 * B * H * D * attention_pairs(Sq, Sk, causal, window)


def flash_vjp(grad_o: Tensor, q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
              window: int | None):
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


def _window(window: int) -> int | None:
    return window or None            # the ops take 0 for "no window"


# ------------------------------------------------------------------ forward
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
    raise ValueError(f"flash_attention: unsupported device {q.device}")


@_flash_op.register_kernel("cuda")
def _on_cuda(q, k, v, causal, window):
    return flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=_window(window))


@_flash_op.register_kernel("cpu")
def _on_cpu(q, k, v, causal, window):
    return attention_ref(q, k, v, causal=causal, window=_window(window)).contiguous()


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ----------------------------------------------------------------- backward
def _setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window
    ctx.layout = layout_of(output)


def _backward(ctx, grad_o):
    """:func:`flash_vjp` on each rank's shards, laid out as the forward's
    sharding rule laid them out (its inputs and output share a layout)."""
    q, k, v = ctx.saved_tensors
    rule = functools.partial(flash_vjp, causal=ctx.causal, window=_window(ctx.window))
    layout = ctx.layout
    return (*on_shards(rule, (layout,) * 3, (layout,) * 4, grad_o, q, k, v), None, None)


_flash_op.register_autograd(_backward, setup_context=_setup)


# ------------------------------------------------------------------ sharding
def _heads_divide(q, k) -> bool:
    """Heads may shard only where q's and kv's head counts both divide every
    mesh dim: then rank r's q heads read exactly its own kv heads (GQA's
    h // G stays local). Otherwise (one kv head, or 8 on a 16-way axis) the
    rule leaves heads out and DTensor gathers q's heads instead."""
    H, K = q.shape[2], k.shape[2]
    return all(H % n == 0 and K % n == 0 for n in q.mesh.shape)


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _(q, k, v, causal, window):
    """Replicate, batch, or q and kv heads together; q, k, v and the output
    share the layout. Never the sequence."""
    layouts = [Replicate(), Shard(0)] + ([Shard(2)] if _heads_divide(q, k) else [])
    return [([p], [p, p, p, None, None]) for p in layouts]


# --------------------------------------------------------------------- FLOPs
@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs):
    B, Sq, H, D = q_shape
    return attention_flops(B, Sq, k_shape[1], H, D, causal, _window(window))


def _gqa_group_slice(q, k):
    """Where q's heads are sharded over a mesh dim that kv's fewer heads
    cannot split (K < n, n % K == 0: 8 kv heads on a 16-way axis), each
    rank's q heads all read one kv head: (mesh dim, its kv head index) for
    :func:`flash_attention` to slice kv to, else None (the sharding rule
    then decides)."""
    if not (isinstance(q, DTensor) and isinstance(k, DTensor)):
        return None
    H, K = q.shape[2], k.shape[2]
    dims = [i for i, p in enumerate(q.placements) if p == Shard(2)]
    if len(dims) != 1 or k.placements[dims[0]] != Replicate():
        return None
    i = dims[0]
    n = q.device_mesh.shape[i]
    if H % n or n % K or n <= K:
        return None
    heads_per_rank, group = H // n, H // K
    return i, q.device_mesh.get_coordinate()[i] * heads_per_rank // group


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None) -> Tensor:
    """GQA attention. q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D).

    On DTensors with q's heads sharded where kv's are not
    (:func:`_gqa_group_slice`), each rank runs the kernel on its q heads and
    the one kv head they share (sliced from its replicated kv), instead of
    letting the rule gather q's heads; kv's gradient is then summed over
    that mesh dim."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    w = 0 if window is None else int(window)
    gqa = _gqa_group_slice(q, k)
    if gqa is None:
        return _flash_op(q, k, v, causal, w)
    i, kv_head = gqa
    q_pl = tuple(q.placements)
    kv_pl = tuple(Replicate() if j == i else p for j, p in enumerate(q_pl))
    kv_grad = tuple(Partial() if j == i else p for j, p in enumerate(q_pl))

    def local(q, k, v):
        return _flash_op(q, k[:, :, kv_head:kv_head + 1], v[:, :, kv_head:kv_head + 1],
                         causal, w)

    return local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     redistribute_inputs=True)(q, k, v)

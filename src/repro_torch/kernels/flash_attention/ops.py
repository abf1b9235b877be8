"""Public flash-attention entry point (port of the reference's ``ops.py``).

Model code calls :func:`flash_attention` with (B, S, H, D) tensors, the
model's native layout, which the CUDA kernel reads directly. It is the
custom op ``repro_torch::flash_attention``, with one implementation per
device and no other path:

  cuda       the hand-written kernel (:func:`flash_attention_kernel`), which
             raises on what it does not take, with ``chunked`` or without;
  cpu        the plain version: :func:`attention_chunked` under ``chunked``
             (the reference's choice off the accelerator), else
             :func:`attention_ref`;
  fake/meta  shapes only (the dry-run on the ``meta`` device).

Its gradient depends on ``chunked`` (``ModelConfig.attn_chunked``):

  off  :func:`flash_vjp`, on each rank's shards: the reference trains
       through autodiff of its plain attention, and the rule recomputes the
       plain version from the saved q, k and v and takes its
       vector-Jacobian product, holding (B, H, Sq, Sk) f32 scores;
  on   the custom op ``repro_torch::flash_attention_backward`` from the
       saved q, k, v and output, on each rank's shards: on ``cuda`` the
       backward kernel (:func:`flash_attention_bwd_kernel`, dQ, dK and dV by
       recomputing P tile by tile), on ``cpu`` :func:`flash_bwd_ref`, the
       VJP of the reference's chunked attention; neither holds an (Sq, Sk)
       tensor, and its fake implementation gives the dry-run the gradients'
       shapes only.

Neither is a fallback: the forward never runs a plain version on the card,
and the backward op on ``cuda`` runs its kernel or raises.

Both ops carry a DTensor sharding rule (batch; q and kv heads together;
never the sequence; or replicate) and a FLOP formula, so a sharded step
runs each rank's shard through the kernels and the dry-run counts them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_kernel,
                                                        flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (attention_chunked, attention_ref,
                                                     flash_bwd_ref)
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
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
              chunked: bool = False, q_block: int = 1024, k_block: int = 1024) -> Tensor:
    raise ValueError(f"flash_attention: unsupported device {q.device}")


@_flash_op.register_kernel("cuda")
def _on_cuda(q, k, v, causal, window, chunked=False, q_block=1024, k_block=1024):
    return flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=_window(window))


@_flash_op.register_kernel("cpu")
def _on_cpu(q, k, v, causal, window, chunked=False, q_block=1024, k_block=1024):
    if chunked:
        return attention_chunked(q, k, v, causal=causal, window=_window(window),
                                 q_block=q_block, k_block=k_block).contiguous()
    return attention_ref(q, k, v, causal=causal, window=_window(window)).contiguous()


@_flash_op.register_fake
def _(q, k, v, causal, window, chunked=False, q_block=1024, k_block=1024):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ------------------------------------------------------- backward (chunked)
@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_bwd_op(grad_o: Tensor, q: Tensor, k: Tensor, v: Tensor, o: Tensor, causal: bool,
                  window: int, q_block: int, k_block: int) -> tuple[Tensor, Tensor, Tensor]:
    raise ValueError(f"flash_attention_backward: unsupported device {q.device}")


@_flash_bwd_op.register_kernel("cuda")
def _bwd_on_cuda(grad_o, q, k, v, o, causal, window, q_block, k_block):
    return flash_attention_bwd_kernel(*(t.contiguous() for t in (grad_o, q, k, v, o)),
                                      causal=causal, window=_window(window))


@_flash_bwd_op.register_kernel("cpu")
def _bwd_on_cpu(grad_o, q, k, v, o, causal, window, q_block, k_block):
    return tuple(g.contiguous() for g in flash_bwd_ref(
        grad_o, q, k, v, causal=causal, window=_window(window), q_block=q_block,
        k_block=k_block))


@_flash_bwd_op.register_fake
def _(grad_o, q, k, v, o, causal, window, q_block, k_block):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))


# ----------------------------------------------------------------- backward
def _setup(ctx, inputs, output):
    q, k, v, causal, window, chunked, q_block, k_block = inputs
    ctx.save_for_backward(q, k, v, *([output] if chunked else []))
    ctx.causal, ctx.window, ctx.chunked = causal, window, chunked
    ctx.blocks = (q_block, k_block)
    ctx.layout = layout_of(output)


def _backward(ctx, grad_o):
    """The gradient on each rank's shards, laid out as the forward's sharding
    rule laid them out (its inputs and output share a layout): the backward
    op under ``chunked``, else :func:`flash_vjp`."""
    layout = ctx.layout
    if ctx.chunked:
        rule = functools.partial(_flash_bwd_op, causal=ctx.causal, window=ctx.window,
                                 q_block=ctx.blocks[0], k_block=ctx.blocks[1])
        grads = on_shards(rule, (layout,) * 3, (layout,) * 5, grad_o, *ctx.saved_tensors)
    else:
        rule = functools.partial(flash_vjp, causal=ctx.causal, window=_window(ctx.window))
        grads = on_shards(rule, (layout,) * 3, (layout,) * 4, grad_o, *ctx.saved_tensors)
    return (*grads, None, None, None, None, None)


_flash_op.register_autograd(_backward, setup_context=_setup)


# ------------------------------------------------------------------ sharding
def _heads_divide(q, k) -> bool:
    """Heads may shard only where q's and kv's head counts both divide every
    mesh dim: then rank r's q heads read exactly its own kv heads (GQA's
    h // G stays local). Otherwise (one kv head, or 8 on a 16-way axis) the
    rule leaves heads out and DTensor gathers q's heads instead."""
    H, K = q.shape[2], k.shape[2]
    return all(H % n == 0 and K % n == 0 for n in q.mesh.shape)


def _layouts(q, k) -> list:
    return [Replicate(), Shard(0)] + ([Shard(2)] if _heads_divide(q, k) else [])


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _(q, k, v, causal, window, chunked=False, q_block=1024, k_block=1024):
    """Replicate, batch, or q and kv heads together; q, k, v and the output
    share the layout. Never the sequence."""
    return [([p], [p, p, p] + [None] * 5) for p in _layouts(q, k)]


@register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
def _(grad_o, q, k, v, o, causal, window, q_block, k_block):
    """The forward's layouts: grad_o, q, k, v, o and dq, dk, dv share one."""
    return [([p] * 3, [p] * 5 + [None] * 4) for p in _layouts(q, k)]


# --------------------------------------------------------------------- FLOPs
@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs):
    B, Sq, H, D = q_shape
    return attention_flops(B, Sq, k_shape[1], H, D, causal, _window(window))


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(g_shape, q_shape, k_shape, v_shape, o_shape, causal, window, *args, out_shape=None,
      **kwargs):
    """The gradient's own work, 2.5x the forward's: QK^T again, dV, dP, dQ
    and dK over the kept pairs (not the kernel's extra recompute)."""
    B, Sq, H, D = q_shape
    return 5 * attention_flops(B, Sq, k_shape[1], H, D, causal, _window(window)) // 2


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
                    window: int | None = None, chunked: bool = False, q_block: int = 1024,
                    k_block: int = 1024) -> Tensor:
    """GQA attention. q: (B, Sq, H, D); k, v: (B, Sk, K, D) → (B, Sq, H, D).

    ``chunked`` (``ModelConfig.attn_chunked``) selects the reference's
    chunked attention on the CPU, with its ``q_block`` and ``k_block``, and
    the backward op as the gradient (the module's docstring). It refuses a
    causal or windowed call with Sq != Sk: the chunked version aligns q at
    the bottom right there, the kernel at the top left, and no model makes
    such a call.

    On DTensors with q's heads sharded where kv's are not
    (:func:`_gqa_group_slice`), each rank runs the kernel on its q heads and
    the one kv head they share (sliced from its replicated kv), instead of
    letting the rule gather q's heads; kv's gradient is then summed over
    that mesh dim."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if chunked and (causal or window is not None) and q.shape[1] != k.shape[1]:
        raise ValueError(f"chunked attention with causal={causal}, window={window} needs "
                         f"Sq == Sk, got {q.shape[1]} and {k.shape[1]}")
    w = 0 if window is None else int(window)
    flags = (bool(chunked), int(q_block), int(k_block))
    gqa = _gqa_group_slice(q, k)
    if gqa is None:
        return _flash_op(q, k, v, causal, w, *flags)
    i, kv_head = gqa
    q_pl = tuple(q.placements)
    kv_pl = tuple(Replicate() if j == i else p for j, p in enumerate(q_pl))
    kv_grad = tuple(Partial() if j == i else p for j, p in enumerate(q_pl))

    def local(q, k, v):
        return _flash_op(q, k[:, :, kv_head:kv_head + 1], v[:, :, kv_head:kv_head + 1],
                         causal, w, *flags)

    return local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     redistribute_inputs=True)(q, k, v)

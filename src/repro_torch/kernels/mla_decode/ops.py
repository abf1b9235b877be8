"""Public latent (MLA) decode-attention entry point.

Model code (``models/mla.py::mla_decode``) calls
:func:`mla_decode_attention` after writing this step's latent slot into the
cache. It is the custom op ``repro_torch::mla_decode_attention(q, cache,
pos, v_dim, scale) -> o``, which reads the cache and writes nothing to it,
with one implementation per device and no other path:

  cuda       the hand-written kernel (:func:`mla_decode_kernel`), which
             raises on what it does not take;
  cpu        :func:`mla_decode_attention_ref`, the plain version;
  fake/meta  shapes only.

Its DTensor sharding rule keeps the cache replicated or split over the
batch (``cache_pspecs`` gives a latent leaf no other split), and it carries
a FLOP formula for the dry-run's counter.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.mla_decode.kernel import mla_decode_kernel
from repro_torch.kernels.mla_decode.ref import mla_decode_attention_ref

__all__ = ["mla_decode_attention", "mla_decode_flops"]


def mla_decode_flops(B: int, H: int, W: int, C: int, slots: int) -> int:
    """q . slot over W values and P V over C, per head and slot."""
    return 2 * B * H * (W + C) * slots


@torch.library.custom_op("repro_torch::mla_decode_attention", mutates_args=())
def _mla_op(q: Tensor, cache: Tensor, pos: Tensor, v_dim: int, scale: float) -> Tensor:
    raise ValueError(f"mla_decode_attention: unsupported device {q.device}")


@_mla_op.register_kernel("cuda")
def _on_cuda(q, cache, pos, v_dim, scale):
    return mla_decode_kernel(q.contiguous(), cache, pos.long().contiguous(), v_dim, scale)


@_mla_op.register_kernel("cpu")
def _on_cpu(q, cache, pos, v_dim, scale):
    return mla_decode_attention_ref(q, cache, pos, v_dim, scale).contiguous()


@_mla_op.register_fake
def _(q, cache, pos, v_dim, scale):
    B, _, H, _ = q.shape
    return q.new_empty((B, 1, H, v_dim))


@register_sharding(torch.ops.repro_torch.mla_decode_attention.default)
def _(q, cache, pos, v_dim, scale):
    """Replicate, or the batch (q, the cache and pos together)."""
    return [([p], [p, p, p, None, None]) for p in (Replicate(), Shard(0))]


@register_flop_formula(torch.ops.repro_torch.mla_decode_attention)
def _(q_shape, cache_shape, pos_shape, v_dim, scale, *args, out_shape=None, **kwargs):
    """Shapes only: every slot counted as written."""
    B, _, H, W = q_shape
    return mla_decode_flops(B, H, W, v_dim, cache_shape[1])


def mla_decode_attention(q: Tensor, cache: Tensor, pos: Tensor, v_dim: int,
                         scale: float) -> Tensor:
    """Attention of one token of H heads per row over the row's latent
    cache. q: (B, 1, H, C + R); cache: (B, S, C + R), a ring indexed ``pos %
    S``, this step's slot already written; pos: (B,) int; ``v_dim`` = C, the
    values a slot gives (its first C); ``scale`` multiplies the scores.
    Only the written slots count. Returns (B, 1, H, C) in q's dtype."""
    return _mla_op(q, cache, pos, int(v_dim), float(scale))

"""Public decode-attention entry point: one token per row against its ring
KV cache.

Model code (``models/attention.py::attn_decode``) calls
:func:`decode_attention` after writing this step's K/V into the cache. It
is the custom op ``repro_torch::decode_attention(q, cache_k, cache_v, pos,
window) -> o``, which reads the cache and writes nothing to it, with one
implementation per device and no other path:

  cuda       the hand-written kernel (:func:`decode_attention_kernel`),
             which raises on what it does not take;
  cpu        :func:`decode_attention_ref`, the reference's plain decode
             attention, so the CPU tests hold the port to the reference;
  fake/meta  shapes only (the dry-run on the ``meta`` device).

Its DTensor sharding rule keeps the cache where ``cache_pspecs`` put it:
replicated, over the batch, or over q and kv heads together (where both
head counts divide the mesh). A cache sharded over its slots (GQA with
fewer kv heads than the model axis) goes instead to the op
``repro_torch::decode_attention_slots`` on each rank's slots, which returns
each (row, head)'s log-sum-exp beside its output; the ranks' outputs are
then combined by their log-sum-exps, so the cache is never gathered there
either. Both ops carry a FLOP formula for the dry-run's counter.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_slots_ref)
from repro_torch.parallel.sharding import local_range

__all__ = ["decode_attention", "decode_attention_flops"]


def _window(window: int) -> int | None:
    return window or None            # the ops take 0 for "no window"


def decode_attention_flops(B: int, H: int, D: int, slots: int) -> int:
    """q.k and P.V of one token against ``slots`` written slots a row."""
    return 4 * B * H * D * slots


# ------------------------------------------------------------- whole ring
@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_op(q: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor,
               window: int) -> Tensor:
    raise ValueError(f"decode_attention: unsupported device {q.device}")


@_decode_op.register_kernel("cuda")
def _on_cuda(q, cache_k, cache_v, pos, window):
    return decode_attention_kernel(q.contiguous(), cache_k, cache_v, pos.long().contiguous(),
                                   _window(window))


@_decode_op.register_kernel("cpu")
def _on_cpu(q, cache_k, cache_v, pos, window):
    return decode_attention_ref(q, cache_k, cache_v, pos, _window(window)).contiguous()


@_decode_op.register_fake
def _(q, cache_k, cache_v, pos, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


# ------------------------------------------------- a shard of the ring's slots
@torch.library.custom_op("repro_torch::decode_attention_slots", mutates_args=())
def _slots_op(q: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor, window: int,
              slot0: int, ring: int) -> tuple[Tensor, Tensor]:
    raise ValueError(f"decode_attention_slots: unsupported device {q.device}")


@_slots_op.register_kernel("cuda")
def _slots_on_cuda(q, cache_k, cache_v, pos, window, slot0, ring):
    # q in f32, so the shard's output stays f32 until the ranks are combined
    return decode_attention_kernel(q.float().contiguous(), cache_k, cache_v,
                                   pos.long().contiguous(), _window(window), slot0=slot0,
                                   ring=ring, with_lse=True)


@_slots_op.register_kernel("cpu")
def _slots_on_cpu(q, cache_k, cache_v, pos, window, slot0, ring):
    o, lse = decode_attention_slots_ref(q, cache_k, cache_v, pos, _window(window), slot0, ring)
    return o.contiguous(), lse.contiguous()


@_slots_op.register_fake
def _(q, cache_k, cache_v, pos, window, slot0, ring):
    B, _, H, _ = q.shape
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty((B, H), dtype=torch.float32, device=q.device))


# ------------------------------------------------------------------ sharding
def _heads_divide(q, cache_k) -> bool:
    """Heads may shard only where q's and kv's head counts both divide every
    mesh dim, so each rank's q heads read its own kv heads."""
    H, K = q.shape[2], cache_k.shape[2]
    return all(H % n == 0 and K % n == 0 for n in q.mesh.shape)


@register_sharding(torch.ops.repro_torch.decode_attention.default)
def _(q, cache_k, cache_v, pos, window):
    """Replicate, the batch (pos with it), or q and kv heads together (pos
    replicated); never the slots (:func:`decode_attention` takes those)."""
    layouts = [(Replicate(), Replicate()), (Shard(0), Shard(0))]
    if _heads_divide(q, cache_k):
        layouts.append((Shard(2), Replicate()))
    return [([p], [p, p, p, p_pos, None]) for p, p_pos in layouts]


# --------------------------------------------------------------------- FLOPs
@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _(q_shape, k_shape, v_shape, pos_shape, window, *args, out_shape=None, **kwargs):
    """Shapes only: every slot of the ring counted as written (a full cache,
    as in the dry-run's decode cells), the count of the reference's einsums."""
    B, _, H, D = q_shape
    return decode_attention_flops(B, H, D, k_shape[1])


@register_flop_formula(torch.ops.repro_torch.decode_attention_slots)
def _(q_shape, k_shape, v_shape, pos_shape, window, slot0, ring, *args, out_shape=None,
      **kwargs):
    B, _, H, D = q_shape
    return decode_attention_flops(B, H, D, k_shape[1])


def _slot_dims(cache_k) -> list:
    """The mesh dims over which a DTensor cache is sharded along its slots."""
    if not isinstance(cache_k, DTensor):
        return []
    return [i for i, p in enumerate(cache_k.placements) if p == Shard(1)]


def _as_dtensor(t: Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _on_slot_shards(q, cache_k, cache_v, pos, window: int) -> Tensor:
    """Each rank attends over its own slots (``decode_attention_slots``);
    the ranks' outputs are then weighted by exp(lse - max lse) and summed, a
    reduction of (B, H, D) and (B, H) floats. The other mesh dims keep the
    cache's layout (batch or heads), q and pos following it."""
    mesh, pl = cache_k.device_mesh, tuple(cache_k.placements)
    Smax = cache_k.shape[1]
    slot0, _ = local_range(1, Smax, pl, mesh)
    q_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
    pos_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    # the ranks' results stacked on a new leading dim, sharded where the slots
    # were: o (n, B, 1, H, D), lse (n, B, H)
    def stacked(p, heads_dim):
        if p == Shard(1):
            return Shard(0)
        if p == Shard(0):
            return Shard(1)
        return Shard(heads_dim) if p == Shard(2) else p
    o_pl = tuple(stacked(p, 3) for p in pl)
    lse_pl = tuple(stacked(p, 2) for p in pl)

    def local(q, k, v, pos):
        o, lse = _slots_op(q, k, v, pos, window, slot0, Smax)
        return o[None], lse[None]

    o, lse = local_map(local, out_placements=(o_pl, lse_pl),
                       in_placements=(q_pl, pl, pl, pos_pl), redistribute_inputs=True)(
        _as_dtensor(q, mesh), cache_k, cache_v, _as_dtensor(pos, mesh))
    top = lse.amax(dim=0)            # finite: every row has written its newest slot
    w = torch.exp(lse - top)                                     # (n, B, H)
    num = (o * w.unsqueeze(2).unsqueeze(-1)).sum(dim=0)          # (B, 1, H, D)
    den = w.sum(dim=0).unsqueeze(1).unsqueeze(-1)
    return (num / den).to(q.dtype)


def decode_attention(q: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor, *,
                     window: int | None = None) -> Tensor:
    """Attention of one token per row over its ring cache. q: (B, 1, H, D);
    cache_k, cache_v: (B, Smax, K, D), rings indexed ``pos % Smax``, this
    step's K/V already written; pos: (B,) int, each row's absolute position;
    ``window`` limits the age of the slots attended to. Only the written
    slots count: row b attends to the n_b = min(pos_b + 1, Smax, window)
    newest. Returns (B, 1, H, D) in q's dtype; scale D^-0.5."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    w = 0 if window is None else int(window)
    if _slot_dims(cache_k):
        return _on_slot_shards(q, cache_k, cache_v, pos, w)
    return _decode_op(q, cache_k, cache_v, pos, w)

"""Attention blocks: GQA causal / sliding-window / bidirectional
self-attention, its one-token decode step, and the decoder's
cross-attention over an encoder's output (port of
``repro.models.attention``).

Layout as in the reference: activations (B, S, D), projections keep heads
explicit ((B, S, H, Dh)), KV caches are (B, Smax, K, Dh) and sliding-window
caches are ring buffers of ``window`` slots.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import ParamSpec, apply_rope, rotary_embedding
from repro_torch.parallel.sharding import index_put_local, reshape

__all__ = ["attn_specs", "attn_apply", "attn_decode", "cross_memory_kv",
           "cross_attn_apply"]


def attn_specs(cfg, *, cross: bool = False) -> dict:
    """Projection weights; the QKV biases (``qkv_bias``) only off the
    cross-attention, as in the reference."""
    D, H, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((D, H, Dh), ("embed", "heads", "head")),
        "wk": ParamSpec((D, K, Dh), ("embed", "kv_heads", "head")),
        "wv": ParamSpec((D, K, Dh), ("embed", "kv_heads", "head")),
        "wo": ParamSpec((H, Dh, D), ("heads", "head", "embed"),
                        fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = ParamSpec((H, Dh), ("heads", "head"), init="zeros")
        s["bk"] = ParamSpec((K, Dh), ("kv_heads", "head"), init="zeros")
        s["bv"] = ParamSpec((K, Dh), ("kv_heads", "head"), init="zeros")
    return s


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    D, H, Dh = w.shape
    y = x @ reshape(w.to(x.dtype), D, H * Dh)
    return reshape(y, *y.shape[:-1], H, Dh)


def _proj_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    H, Dh, D = w.shape
    return reshape(o, *o.shape[:-2], H * Dh) @ reshape(w.to(o.dtype), H * Dh, D)


def _qkv(p, x, cfg):
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def attn_apply(p: dict, x: torch.Tensor, cfg, *, causal: bool = True,
               window: int | None = None):
    """Full-sequence (train / prefill) self-attention, causal unless the
    caller says otherwise (the encoder). x: (B, S, D). Returns the output
    and the rotated (k, v) for the decode cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = flash_attention(q, k, v, causal=causal, window=window, chunked=cfg.attn_chunked,
                        q_block=cfg.attn_q_block, k_block=cfg.attn_k_block)
    return _proj_out(o, p["wo"]), (k, v)


def cross_memory_kv(p: dict, enc_out: torch.Tensor):
    """Per-layer cross-attention K/V over the encoder's output (B, F, D):
    (B, F, K, Dh) each, no RoPE."""
    return _proj_in(enc_out, p["wk"]), _proj_in(enc_out, p["wv"])


def cross_attn_apply(p: dict, x: torch.Tensor, memory, cfg) -> torch.Tensor:
    """Decoder cross-attention, not causal, no RoPE. ``memory`` is either
    the encoder's output (B, F, D), whose K/V are computed here, or a
    precomputed (mk, mv) pair (the prefill's, or the decode cache's)."""
    mk, mv = memory if isinstance(memory, tuple) else cross_memory_kv(p, memory)
    q = _proj_in(x, p["wq"])
    o = flash_attention(q, mk.to(x.dtype), mv.to(x.dtype), causal=False)
    return _proj_out(o, p["wo"])


def attn_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, cfg, *,
                window: int | None = None) -> torch.Tensor:
    """One-token decode step; writes this token's K/V into the caches in
    place (the reference returns new caches, which JAX donates); a sharded
    cache is written on each rank's shard.

    x: (B, 1, D); cache_k/v: (B, Smax, K, Dh); pos: (B,) int (absolute
    position of each row's token — rows differ under continuous batching).
    Caches are rings indexed ``pos % Smax``; rope uses absolute positions.
    Attention over the cache is the op ``repro_torch::decode_attention``
    (the reference's plain jnp on the CPU, a CUDA kernel that reads only the
    written slots on the card). Returns out (B, 1, D).
    """
    B = x.shape[0]
    Smax, Dh = cache_k.shape[1], cfg.head_dim
    pos = pos.expand(B).long()

    q, k_new, v_new = _qkv(p, x, cfg)
    sin, cos = rotary_embedding(pos[:, None], Dh, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)

    slot = pos % Smax                                       # (B,)
    rows = torch.arange(B, device=x.device)
    index_put_local(cache_k, (rows, slot), k_new[:, 0])
    index_put_local(cache_v, (rows, slot), v_new[:, 0])

    o = decode_attention(q, cache_k, cache_v, pos, window=window)
    return _proj_out(o, p["wo"])

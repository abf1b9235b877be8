"""Multi-head latent attention (MLA), as DeepSeek-V2/V3 and Moonlight
publish it, without q LoRA.

Per token, with H heads, a latent of C = ``kv_lora_rank``, per-head widths
N = ``qk_nope_head_dim``, R = ``qk_rope_head_dim``, V = ``v_head_dim``:

  q            = x W_q                       (H, N + R): q_nope | q_rope
  [c ; k_rope] = x W_kv_a                    (C + R)
  c            = RMSNorm(c) (``kv_norm``, the published ``kv_a_layernorm``)
  [k_nope ; v] = c W_kv_b                    (H, N + V); W_kv_b = [W_UK | W_UV]
  q_rope, k_rope rotated by the position; one k_rope is shared by the heads
  o_h          = softmax((q_h . k_h) (N + R)^-0.5) v_h, k_h = [k_nope_h ; k_rope]
  out          = [o_1 .. o_H] W_o

Prefill computes that form (scores over N + R = 192, values of V = 128)
through the flash op. The decode cache holds only the normed latent and the
rotated k_rope, C + R values a slot (576, in the compute dtype), with no
per-head K/V. Decode is absorbed: q_nope W_UK^T gives a C-wide latent query
per head, beside its rotated q_rope; one token's H heads attend over the
row's written latent slots (the op ``repro_torch::mla_decode_attention``),
whose first C values serve as V; the latent output goes through W_UV and
then W_o. Both forms are the same sums taken in another order.

The flash kernel takes one head_dim for q, k and v (8-256, see
``kernels.flash_attention.HEAD_DIMS``), so the prefill pads q, k and v with
zero columns to the smallest width it has that holds N + R and V (256 at
the published widths) and multiplies q by sqrt(256 / 192) first, so that the
kernel's 256^-0.5 becomes the published 192^-0.5. Zero columns add nothing
to a score or an output; the rescaled q is rounded once more to the compute
dtype (one bf16 rounding of q's scale, a relative 2^-9 at most).

Rope pairing: the port rotates split halves (``layers.apply_rope``, the
first R/2 dims against the last R/2) in q_rope and k_rope alike. The
published checkpoint stores the rope columns of W_q and W_kv_a interleaved
(pairs 2i, 2i + 1) and de-interleaves them before its rotate-half; loading
it would permute those columns once. The benchmark's weights are random and
both sides here, and the plain references, use split halves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.models.layers import ParamSpec, apply_rope, rms_norm, rotary_embedding
from repro_torch.parallel.sharding import index_put_local, pad, reshape

__all__ = ["mla_specs", "mla_apply", "mla_decode", "slot_width", "flash_width"]


def slot_width(cfg) -> int:
    """Values a latent cache slot holds: the latent and the rotated k_rope."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def flash_width(cfg) -> int:
    """The head_dim the prefill's flash call runs at: the smallest the
    kernel has that holds the score width N + R and the value width V."""
    need = max(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return min(d for d in HEAD_DIMS if d >= need)


def mla_specs(cfg) -> dict:
    D, H, C = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    N, R, V = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": ParamSpec((D, H, N + R), ("embed", "heads", "head")),
        "wkv_a": ParamSpec((D, C + R), ("embed", None)),
        "kv_norm": ParamSpec((C,), (None,), init="ones"),
        "wkv_b": ParamSpec((C, H, N + V), (None, "heads", "head"), fan_in_axes=(0,)),
        "wo": ParamSpec((H, V, D), ("heads", "head", "embed"), fan_in_axes=(0, 1)),
    }


def _latent(p, x, cfg):
    """x (..., D) → (the normed latent (..., C), k_rope before rotation (..., R))."""
    C = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"].to(x.dtype)
    return rms_norm(kv_a[..., :C], p["kv_norm"], cfg.norm_eps), kv_a[..., C:]


def _q(p, x, cfg):
    D, H, W = p["wq"].shape
    q = x @ reshape(p["wq"].to(x.dtype), D, H * W)
    return reshape(q, *q.shape[:-1], H, W)


def _flash_padded(q, k, v, cfg):
    """Causal attention of q, k (B, S, H, N + R) over v (B, S, H, V) through
    the flash op, zero-padded to :func:`flash_width` with the scale kept at
    (N + R)^-0.5 (module docstring). Returns (B, S, H, V)."""
    Dqk, Dv, Dp = q.shape[-1], v.shape[-1], flash_width(cfg)
    if Dp != Dqk:
        q = (q.float() * (Dp / Dqk) ** 0.5).to(q.dtype)
        q, k = pad(q, (0, Dp - Dqk)), pad(k, (0, Dp - Dqk))
    if Dp != Dv:
        v = pad(v, (0, Dp - Dv))
    o = flash_attention(q, k, v, causal=True, chunked=cfg.attn_chunked,
                        q_block=cfg.attn_q_block, k_block=cfg.attn_k_block)
    return o[..., :Dv]


def mla_apply(p: dict, x: torch.Tensor, cfg):
    """Full-sequence (train / prefill) causal MLA. x: (B, S, D). Returns the
    output (B, S, D) and the cache rows (B, S, C + R): the normed latent
    and the rotated k_rope."""
    B, S, _ = x.shape
    H, N, R, V = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = _q(p, x, cfg)
    c, k_rope = _latent(p, x, cfg)
    kv = c @ reshape(p["wkv_b"].to(x.dtype), cfg.kv_lora_rank, H * (N + V))
    kv = reshape(kv, B, S, H, N + V)
    positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = rotary_embedding(positions, R, cfg.rope_theta)
    q_rope = apply_rope(q[..., N:], sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)             # (B, S, 1, R)
    q = torch.cat([q[..., :N], q_rope], dim=-1)
    k = torch.cat([kv[..., :N], k_rope.expand(B, S, H, R)], dim=-1)
    o = _flash_padded(q, k, kv[..., N:], cfg)
    out = reshape(o, B, S, H * V) @ reshape(p["wo"].to(x.dtype), H * V, cfg.d_model)
    return out, torch.cat([c, k_rope[:, :, 0]], dim=-1)


def mla_decode(p: dict, x: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor,
               cfg) -> torch.Tensor:
    """One-token absorbed decode step; writes this token's latent slot into
    ``cache`` (B, Smax, C + R) in place, at ``pos % Smax``. x: (B, 1, D);
    pos: (B,) int, each row's absolute position. Returns (B, 1, D)."""
    B = x.shape[0]
    H, C = cfg.num_heads, cfg.kv_lora_rank
    N, R, V = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pos = pos.expand(B).long()
    q = _q(p, x, cfg)[:, 0]                                          # (B, H, N + R)
    c, k_rope = _latent(p, x[:, 0], cfg)                             # (B, C), (B, R)
    sin, cos = rotary_embedding(pos[:, None], R, cfg.rope_theta)     # (B, 1, R/2)
    q_rope = apply_rope(q[:, None, :, N:], sin, cos)[:, 0]           # (B, H, R)
    k_rope = apply_rope(k_rope[:, None, None, :], sin, cos)[:, 0, 0]

    rows = torch.arange(B, device=x.device)
    index_put_local(cache, (rows, pos % cache.shape[1]), torch.cat([c, k_rope], dim=-1))

    w = p["wkv_b"].to(x.dtype)                                       # (C, H, N + V)
    # q_nope W_UK^T per head: (H, B, N) @ (H, N, C)
    q_lat = torch.matmul(q[..., :N].transpose(0, 1), w[..., :N].permute(1, 2, 0))
    q_abs = torch.cat([q_lat.transpose(0, 1), q_rope], dim=-1)       # (B, H, C + R)
    o_lat = mla_decode_attention(q_abs[:, None].contiguous(), cache, pos, C,
                                 (N + R) ** -0.5)                    # (B, 1, H, C)
    o = torch.matmul(o_lat[:, 0].transpose(0, 1), w[..., N:].transpose(0, 1))  # (H, B, V)
    o = reshape(o.transpose(0, 1), B, 1, H * V)
    return o @ reshape(p["wo"].to(x.dtype), H * V, cfg.d_model)

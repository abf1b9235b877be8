"""Plain PyTorch versions of the decode attention over a ring KV cache.

``decode_attention_ref`` is the reference's own decode attention (plain jnp
in ``src/repro/models/attention.py::attn_decode``, ported as it is): the
whole ring widened to f32, every slot scored, the slots not yet written or
outside the window given -1e30 before an f32 softmax. It is the CPU path of
:func:`repro_torch.kernels.decode_attention.decode_attention` and the oracle
the CUDA kernel (``csrc/decode_attention.cu``) is held against on the card.

``decode_attention_slots_ref`` is the kernel's contract in plain PyTorch: a
softmax over only the written slots of a cache that may hold a part of the
ring (slots ``slot0 .. slot0 + S - 1`` of ``ring``), with each (row, head)'s
log-sum-exp beside the output; the CPU path of the op on a cache sharded
over its slots.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "decode_attention_slots_ref", "written_slots"]


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                         pos: torch.Tensor, window: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, Dh); cache_k, cache_v: (B, Smax, K, Dh), rings indexed
    ``pos % Smax``, this step's K/V already written; pos: (B,) int, each
    row's absolute position. Returns (B, 1, H, Dh) in q's dtype."""
    B, _, H, Dh = q.shape
    Smax, K = cache_k.shape[1], cache_k.shape[2]
    G = H // K
    pos = pos.expand(B).long()
    slot = pos % Smax                                       # (B,)

    qf = q.float().reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, cache_k.float()) * (Dh ** -0.5)
    # slot j holds the token `age = (slot - j) mod Smax` steps in the past
    idx = torch.arange(Smax, device=q.device)[None, :]
    age = (slot[:, None] - idx) % Smax                      # (B, Smax); 0 = now
    valid = age <= torch.clamp(pos, max=Smax - 1)[:, None]  # written yet?
    if window is not None:
        valid &= age < window
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), -1e30, device=q.device))
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", pattn, cache_v.float()).reshape(B, 1, H, Dh)
    return o.to(q.dtype)


def written_slots(pos: torch.Tensor, S: int, window: int | None = None, slot0: int = 0,
                  ring: int | None = None) -> torch.Tensor:
    """(B, S) bool: which of the local slots ``slot0 .. slot0 + S - 1`` of a
    ring of ``ring`` slots (default S) hold a token row b attends to, the
    age of the slot below n_b = min(pos_b + 1, ring, window)."""
    ring = S if ring is None else ring
    pos = pos.long()
    n = torch.clamp(pos + 1, max=ring)
    if window is not None:
        n = torch.clamp(n, max=window)
    j = slot0 + torch.arange(S, device=pos.device)[None, :]
    age = (pos[:, None] % ring - j) % ring
    return age < n[:, None]


def decode_attention_slots_ref(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                               pos: torch.Tensor, window: int | None = None, slot0: int = 0,
                               ring: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The softmax over the written slots only: (o (B, 1, H, Dh) in f32,
    lse (B, H) f32, the natural log-sum-exp of the scaled scores). A row with
    no written slot here gives o = 0 and lse = -inf."""
    B, _, H, Dh = q.shape
    S, K = cache_k.shape[1], cache_k.shape[2]
    G = H // K
    live = written_slots(pos.expand(B), S, window, slot0, ring)       # (B, S)
    qf = q.float().reshape(B, K, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, cache_k.float()) * (Dh ** -0.5)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                                   # (B, K, G)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    o = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float()).reshape(B, 1, H, Dh)
    return o, lse.reshape(B, H)

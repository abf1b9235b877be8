"""Plain PyTorch latent (MLA) decode attention: the CPU path of
:func:`repro_torch.kernels.mla_decode.mla_decode_attention` and the oracle
the CUDA kernel (``csrc/mla_decode_attention.cu``) is held against on the
card.

One token of H heads per row against the row's latent cache, every head
reading the same slots: scores are ``q . slot`` over all C + R values of a
slot, times ``scale``; the values are each slot's first C. Only the written
slots count (:func:`repro_torch.kernels.decode_attention.written_slots`):
row b attends to the min(pos_b + 1, S) newest slots of a ring of S indexed
``pos % S``. Computed in f32, the output rounded once to q's dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import written_slots

__all__ = ["mla_decode_attention_ref"]


def mla_decode_attention_ref(q: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor,
                             v_dim: int, scale: float) -> torch.Tensor:
    """q: (B, 1, H, C + R); cache: (B, S, C + R), this step's slot already
    written; pos: (B,) int. Returns (B, 1, H, v_dim) in q's dtype."""
    B = q.shape[0]
    live = written_slots(pos.expand(B), cache.shape[1])                   # (B, S)
    s = torch.einsum("bhw,btw->bht", q[:, 0].float(), cache.float()) * scale
    p = torch.softmax(s.masked_fill(~live[:, None, :], float("-inf")), dim=-1)
    o = torch.einsum("bht,btc->bhc", p, cache[..., :v_dim].float())
    return o[:, None].to(q.dtype)

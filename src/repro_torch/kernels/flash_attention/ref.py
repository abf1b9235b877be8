"""Plain PyTorch version of flash attention (port of the reference's
``kernels/flash_attention/ref.py::attention_ref``).

The CPU path of :func:`repro_torch.kernels.flash_attention.flash_attention`
and the oracle the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]

NEG_INF = -1e30


def _mask(sq: int, sk: int, *, causal: bool, window: int | None,
          device) -> torch.Tensor:
    """(sq, sk) boolean mask; True = attend. q position i and k position j
    are both counted from 0 (causal alignment at the top left)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= qpos - kpos < window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, H, D);  k, v: (B, Sk, K, D) with H % K == 0.
    Returns (B, Sq, H, D) in q.dtype; scale D^-0.5, softmax in float32.
    """
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    m = _mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(m, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)

"""Plain PyTorch versions of flash attention (port of the reference's
``kernels/flash_attention/ref.py``): ``attention_ref`` and
``attention_chunked``, and the VJP of the latter, ``flash_bwd_ref``.

``attention_ref`` is the CPU path of
:func:`repro_torch.kernels.flash_attention.flash_attention` and the oracle
the forward CUDA kernel is held against on the card; ``attention_chunked``
is the CPU path under ``chunked``, and ``flash_bwd_ref`` the CPU gradient
there and the oracle of the backward kernel (``csrc/flash_attention_bwd.cu``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["attention_ref", "attention_chunked", "flash_bwd_ref"]

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


def _kv_step(acc, m, l, qf, kb, vb, qpos, start: int, causal: bool,
             window: int | None):
    """One k-block of the online softmax (the reference's scan ``body``):
    the running (acc, m, l) of a q block after keys start..start+len(kb)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb.float())          # (B,K,G,qb,kb)
    kpos = start + torch.arange(kb.shape[1], device=qf.device)
    mask = torch.ones((qpos.shape[0], kb.shape[1]), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=qf.device))
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb.float())
    return acc_new, m_new, l_new


def _plan(Sq: int, Sk: int, causal: bool, window: int | None, q_block: int,
          k_block: int):
    """The reference's blocks: per q block (q0, its rows, the k range
    [lo, hi) it scans, the k block, the offset of its positions), or None
    where a block does not divide its length. Causal q blocks stop at their
    diagonal, aligned at the bottom right (q position i sits at Sk - Sq + i);
    a window starts at the q block's oldest visible k block."""
    q_block, k_block = min(q_block, Sq), min(k_block, Sk)
    if Sq % q_block or Sk % k_block:
        return None
    plan = []
    for q0 in range(0, Sq, q_block):
        hi = Sk
        if causal:     # the q block's last row sits at Sk - Sq + q0 + q_block - 1
            hi = min(Sk, -(-min(Sk, Sk - Sq + q0 + q_block) // k_block) * k_block)
        lo = 0
        if window is not None:
            lo = max(0, (Sk - Sq + q0) - window + 1) // k_block * k_block
        plan.append((q0, q_block, lo, hi, k_block, Sk - Sq))
    return plan


def _q_block(q, q0: int, rows: int, K: int):
    """q rows q0 .. q0 + rows - 1 as (B, rows, K, G, D) f32, scaled by D^-0.5."""
    B, _, H, D = q.shape
    return q[:, q0:q0 + rows].float().reshape(B, rows, K, H // K, D) * D ** -0.5


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_block: int = 1024, k_block: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention (the reference's
    ``attention_chunked``): never materialises the (Sq, Sk) scores. Each q
    block walks its k blocks (:func:`_plan`) with a running (max, sum, acc);
    each k-block step runs under ``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint(body)``, so autograd keeps O(S·D) bytes and
    recomputes the block's scores in the backward. Where a block does not
    divide its length, the result is :func:`attention_ref`'s, as in the
    reference.

    Shapes as :func:`attention_ref`; scale D^-0.5, softmax in float32."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    plan = _plan(Sq, Sk, causal, window, q_block, k_block)
    if plan is None:
        return attention_ref(q, k, v, causal=causal, window=window)
    outs = []
    for q0, rows, lo, hi, kb, offset in plan:
        qf = _q_block(q, q0, rows, K)
        qpos = offset + q0 + torch.arange(rows, device=q.device)
        acc = qf.new_zeros((B, K, H // K, rows, D))
        m = qf.new_full((B, K, H // K, rows), float("-inf"))
        l = qf.new_zeros((B, K, H // K, rows))
        for start in range(lo, hi, kb):
            acc, m, l = checkpoint(_kv_step, acc, m, l, qf, k[:, start:start + kb],
                                   v[:, start:start + kb], qpos, start, causal, window,
                                   use_reentrant=False, preserve_rng_state=False)
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(3, 1).reshape(B, rows, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_bwd_ref(grad_o: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, causal: bool, window: int | None,
                  q_block: int = 1024, k_block: int = 1024):
    """The vector-Jacobian product of :func:`attention_chunked` at (q, k, v)
    with cotangent ``grad_o``, block by block as its checkpointed scan's
    backward runs: per q block, the forward's walk again for the row
    statistics (L = m + log l, the output O and Delta = rowsum(dO o O)),
    then per k block P = exp(x - L), dV += P^T dO, dP = dO V^T,
    dS = P o (dP - Delta), dQ += dS K, dK += dS^T Q (scale folded into Q).
    It holds no (Sq, Sk) tensor, only one block pair's scores at a time.
    It is written out rather than taken by autograd because it runs as the
    CPU implementation of a custom op, below autograd. Where a block does
    not divide its length it is the VJP of :func:`attention_ref`, computed
    as one block. The plain version of the backward kernel, the CPU gradient
    of the flash op under ``chunked`` and the kernel's oracle on the card.
    Returns (dq, dk, dv), each in its input's dtype."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    G = H // K
    plan = _plan(Sq, Sk, causal, window, q_block, k_block) or [(0, Sq, 0, Sk, Sk, 0)]
    dq = torch.zeros((B, Sq, K, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, K, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    g = grad_o.float().reshape(B, Sq, K, G, D)
    neg = torch.full((), NEG_INF, device=q.device)
    for q0, rows, lo, hi, kb, offset in plan:
        qf = _q_block(q, q0, rows, K)
        go = g[:, q0:q0 + rows].permute(0, 2, 3, 1, 4)                   # (B,K,G,qb,D)
        qpos = offset + q0 + torch.arange(rows, device=q.device)
        acc = qf.new_zeros((B, K, G, rows, D))
        m = qf.new_full((B, K, G, rows), float("-inf"))
        l = qf.new_zeros((B, K, G, rows))
        for start in range(lo, hi, kb):
            acc, m, l = _kv_step(acc, m, l, qf, k[:, start:start + kb],
                                 v[:, start:start + kb], qpos, start, causal, window)
        o = acc / torch.clamp(l[..., None], min=1e-30)
        lse = (m + torch.log(l))[..., None]
        delta = (o * go).sum(dim=-1, keepdim=True)
        for start in range(lo, hi, kb):
            kf, vf = k[:, start:start + kb].float(), v[:, start:start + kb].float()
            kpos = start + torch.arange(kf.shape[1], device=q.device)
            mask = torch.ones((rows, kf.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, torch.einsum("bqkgd,bskd->bkgqs", qf, kf), neg)
            p = torch.exp(s - lse)
            dv[:, start:start + kb] += torch.einsum("bkgqs,bkgqd->bskd", p, go)
            ds = p * (torch.einsum("bkgqd,bskd->bkgqs", go, vf) - delta)
            dq[:, q0:q0 + rows] += torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * D ** -0.5
            dk[:, start:start + kb] += torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

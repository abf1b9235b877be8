"""The Mamba-2 SSD chunked scan in plain PyTorch, float32: a frozen copy of
the port's plain oracle ``src/repro_torch/kernels/ssd/ref.py::ssd_ref`` (itself
the JAX reference's ``kernels/ssd/ref.py``), kept here so that a change to
the port's oracle cannot move the benchmark's reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_ref"]

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, *, chunk: int = 256, return_state: bool = False):
    """x: (B,S,H,P); dt: (B,S,H) (>0, post-softplus); A: (H,) (<0);
    Bm, Cm: (B,S,N) (single group, broadcast over heads).
    Returns y: (B,S,H,P) in x's dtype [and the final state (B,H,P,N) in
    f32]; all the math is f32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:                      # padded steps have dt = 0: they change nothing
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    T = x.shape[1]
    nc = T // Q

    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bf = Bm.float().reshape(Bsz, nc, Q, N)
    Cf = Cm.float().reshape(Bsz, nc, Q, N)

    # cum reaches -10^3 over a chunk of 256, where an ulp of it is a relative
    # error of 10^-4 in exp(cum_i - cum_j): sum in f64 and round once, as the
    # CUDA kernel does, so both give the same f32 cum on any device.
    cum = torch.cumsum((dtf * A.float()).double(), dim=2).float()   # (B,nc,Q,H) ≤ 0
    u = dtf[..., None] * xf                                     # (B,nc,Q,H,P)

    # ---- intra-chunk (the "duality" quadratic form), heads before (i, j).
    # Mask INSIDE the exponent: the upper triangle's exponent is positive
    # and unbounded, and exp of it would poison the gradient with inf·0.
    cum_h = cum.transpose(2, 3)                                 # (B,nc,H,Q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]            # (B,nc,H,i,j)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, diff, torch.tensor(float("-inf"), device=x.device)))
    CB = Cf @ Bf.transpose(-1, -2)                              # (B,nc,i,j)
    u_h = u.permute(0, 1, 3, 2, 4)                              # (B,nc,H,Q,P)
    y_intra = (CB[:, :, None] * L) @ u_h                        # (B,nc,H,i,P)

    # ---- inter-chunk state carry
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B,nc,Q,H)
    S_c = torch.einsum("bcjhp,bcjn->bchpn", decay_to_end[..., None] * u, Bf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)                                      # state at chunk start
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_starts = torch.stack(h_starts, dim=1)                     # (B,nc,H,P,N)
    y_inter = (Cf[:, :, None] @ h_starts.transpose(-1, -2)      # (B,nc,H,i,P)
               * torch.exp(cum_h)[..., None])

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(Bsz, T, H, P)
    y = y[:, :S].to(x.dtype)
    return (y, h) if return_state else y

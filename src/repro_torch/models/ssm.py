"""Mamba-2 (SSD) block, full-sequence path (port of ``repro.models.ssm``):
in-proj → causal depthwise conv → SSD scan → gated norm → out-proj.

The casts sit where the reference puts them: the softplus of dt and
``A = -exp(A_log)`` in f32, the projections, the conv and the gate in the
compute dtype. The one-token decode path (``ssm_decode``,
``ssm_cache_shapes``) comes with mamba2 serving (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd
from repro_torch.models.layers import ParamSpec, rms_norm

__all__ = ["ssm_dims", "ssm_specs", "ssm_apply"]


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    if H * P != d_inner:
        raise ValueError(f"ssm_heads {H} x ssm_head_dim {P} != d_inner {d_inner}")
    conv_dim = d_inner + 2 * N
    return d_inner, H, P, N, conv_dim


def ssm_specs(cfg) -> dict:
    D = cfg.d_model
    d_inner, H, P, N, conv_dim = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * N + H          # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((D, proj_out), ("embed", "ff")),
        "conv_w": ParamSpec((cfg.conv_width, conv_dim), (None, "ff")),
        "conv_b": ParamSpec((conv_dim,), ("ff",), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),     # A = -exp(A_log)
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "D_skip": ParamSpec((H,), (None,), init="ones"),
        "gate_norm": ParamSpec((d_inner,), ("ff",), init="ones"),
        "out_proj": ParamSpec((d_inner, D), ("ff", "embed")),
    }


def _split(proj: torch.Tensor, cfg):
    d_inner, H, P, N, _ = ssm_dims(cfg)
    z = proj[..., :d_inner]
    xs = proj[..., d_inner:2 * d_inner]
    Bm = proj[..., 2 * d_inner:2 * d_inner + N]
    Cm = proj[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xs, Bm, Cm, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W: y[t] = Σ_i w[i]·u[t-W+1+i] + b."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(W)) + b


def ssm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence SSD mixer. x: (B, S, D) → (B, S, D)."""
    B, S, D = x.shape
    d_inner, H, P, N, conv_dim = ssm_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xs, Bm, Cm, dt = _split(proj, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype)))
    xs = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + N]
    Cm = conv_out[..., d_inner + N:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,S,H)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    xh = xs.reshape(B, S, H, P)                                 # a view: no copy
    y = ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + p["D_skip"].to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype)

"""Mamba-2 (SSD) block (port of ``repro.models.ssm``): in-proj → causal
depthwise conv → SSD scan → gated norm → out-proj, plus the one-token
recurrent decode path, whose state (the conv tail in the compute dtype and
the (H, P, N) SSM state in f32) replaces the KV cache.

The casts sit where the reference puts them: the softplus of dt and
``A = -exp(A_log)`` in f32, the projections, the conv and the gate in the
compute dtype. The full-sequence mixer (:func:`ssm_apply`, training) and
the prompt pass (``transformer._ssm_prefill``, serving) share one body,
:func:`ssm_seq`: training scans with :func:`ssd` (the kernel on the card),
the prefill with the plain scan (:func:`ssd_with_state`, on each rank's
shards), which also returns the final state, as
the reference's prefill does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd, ssd_decode_step, ssd_with_state
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.parallel import sharding as shd

__all__ = ["ssm_dims", "ssm_specs", "ssm_seq", "ssm_apply", "ssm_cache_shapes",
           "ssm_decode"]


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
    pad = shd.pad(u, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(W)) + b


def _conv_split(conv_out: torch.Tensor, cfg):
    d_inner, _, _, N, _ = ssm_dims(cfg)
    return (conv_out[..., :d_inner], conv_out[..., d_inner:d_inner + N],
            conv_out[..., d_inner + N:])


def _gated_out(p: dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, cfg):
    """Skip, gated norm and out-proj: y, xh (..., H, P); z (..., d_inner)."""
    y = y + p["D_skip"].to(z.dtype)[:, None] * xh
    y = shd.reshape(y, *z.shape)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(z.dtype)


def ssm_seq(p: dict, x: torch.Tensor, cfg, *, prefill: bool = False):
    """The SSD mixer over a full sequence. x: (B, S, D). Returns the output
    (B, S, D), the pre-conv projection (B, S, conv_dim), whose last rows are
    the decode cache's conv tail, and, with ``prefill``, the final state
    (B, H, P, N) in f32 (else None)."""
    B, S, D = x.shape
    d_inner, H, P, N, conv_dim = ssm_dims(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xs, Bm, Cm, dt = _split(proj, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype)))
    xs, Bm, Cm = _conv_split(conv_out, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,S,H)
    A = -torch.exp(p["A_log"].float())                          # (H,)
    xh = shd.reshape(xs, B, S, H, P)                                 # a view: no copy
    if prefill:
        y, state = ssd_with_state(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, state = ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk), None
    return _gated_out(p, y, xh, z, cfg), conv_in, state


def ssm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence SSD mixer (training). x: (B, S, D) → (B, S, D)."""
    return ssm_seq(p, x, cfg)[0]


# --------------------------------------------------------------------- decode
def ssm_cache_shapes(cfg, batch: int, dtype) -> dict:
    d_inner, H, P, N, conv_dim = ssm_dims(cfg)
    return {
        "conv": ((batch, cfg.conv_width - 1, conv_dim), dtype),
        "state": ((batch, H, P, N), torch.float32),
    }


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``cache`` ({"conv" (B, W-1, C), "state"
    (B, H, P, N)} of this layer) is updated in place (the reference returns a
    new one). Returns out (B, 1, D)."""
    B = x.shape[0]
    d_inner, H, P, N, conv_dim = ssm_dims(cfg)
    proj = (x @ p["in_proj"].to(x.dtype))[:, 0]
    z, xs, Bm, Cm, dt = _split(proj, cfg)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                   # (B, C)
    hist = torch.cat([cache["conv"], conv_in[:, None, :]], dim=1)
    w = p["conv_w"].to(x.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].to(x.dtype))
    xs, Bm, Cm = _conv_split(conv_out, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = shd.reshape(xs, B, H, P)
    y, state = ssd_decode_step(cache["state"], xh, dt, A, Bm, Cm)
    out = _gated_out(p, y, xh, z, cfg)[:, None, :]
    cache["conv"].copy_(hist[:, 1:, :])
    cache["state"].copy_(state)
    return out

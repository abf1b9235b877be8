"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro.models.rglru``).

Block: norm → two branches: (i) linear → causal conv → input/recurrence
gates → RG-LRU scan; (ii) linear → GeLU gate; merged by elementwise product
and an output projection. The recurrence

    a_t = exp(-c · softplus(Λ) · r_t),   r_t = σ(W_a u_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(W_x u_t) ⊙ u_t)

keeps |h| bounded; the decode state is one (B, W) vector in f32 plus a conv
tail. The casts sit where the reference puts them, so the two round alike.
The full-sequence mixer (:func:`rglru_apply`, training) and the prompt pass
(``transformer._rglru_prefill``, serving) share one body, :func:`rglru_seq`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import lru_decode_step_ref, lru_scan
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding as shd

__all__ = ["rglru_specs", "rglru_seq", "rglru_apply", "rglru_decode",
           "rglru_cache_shapes", "gelu"]

_C = 8.0  # Griffin's fixed decay sharpness


def rglru_specs(cfg) -> dict:
    D, W = cfg.d_model, cfg.lru_width
    return {
        "in_x": ParamSpec((D, W), ("embed", "ff")),
        "in_gate": ParamSpec((D, W), ("embed", "ff")),
        "conv_w": ParamSpec((cfg.conv_width, W), (None, "ff")),
        "conv_b": ParamSpec((W,), ("ff",), init="zeros"),
        "lam": ParamSpec((W,), ("ff",), init="ones"),
        "gate_a": ParamSpec((W, W), ("ff", None)),
        "gate_x": ParamSpec((W, W), ("ff", None)),
        "out_w": ParamSpec((W, D), ("ff", "embed")),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gates(p, u: torch.Tensor):
    """u: (..., W) conv output → (a, b) recurrence coefficients in u's dtype.
    r and i in the activation dtype; log_a, a and b in f32."""
    r = torch.sigmoid(u @ p["gate_a"].to(u.dtype))
    i = torch.sigmoid(u @ p["gate_x"].to(u.dtype))
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u).float()
    return a.to(u.dtype), b.to(u.dtype)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S. u: (B, S, W); w: (conv_width, W)."""
    cw, S = w.shape[0], u.shape[1]
    pad = shd.pad(u, (0, 0, cw - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(cw)) + b


def rglru_seq(p: dict, x: torch.Tensor):
    """The recurrent mixer over a full sequence. x: (B, S, D). Returns the
    output (B, S, D), the pre-conv projection u (B, S, W), whose last rows
    are the decode cache's conv tail, and the scan's h (B, S, W)."""
    u = x @ p["in_x"].to(x.dtype)
    uc = _causal_conv(u, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    a, b = _gates(p, uc)
    h = lru_scan(a, b)
    g = gelu(x @ p["in_gate"].to(x.dtype))
    return (h * g) @ p["out_w"].to(x.dtype), u, h


def rglru_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence recurrent mixer (training). x: (B, S, D) → (B, S, D)."""
    return rglru_seq(p, x)[0]


def rglru_cache_shapes(cfg, batch: int, dtype) -> dict:
    W = cfg.lru_width
    return {
        "conv": ((batch, cfg.conv_width - 1, W), dtype),
        "h": ((batch, W), torch.float32),
    }


def rglru_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``cache`` ({"conv", "h"} of this layer)
    is updated in place (the reference returns a new one). Returns out
    (B, 1, D)."""
    u = (x @ p["in_x"].to(x.dtype))[:, 0]                       # (B, W)
    hist = torch.cat([cache["conv"], u[:, None, :]], dim=1)
    w = p["conv_w"].to(x.dtype)
    u = torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].to(x.dtype)
    a, b = _gates(p, u)
    h = lru_decode_step_ref(cache["h"], a.float(), b.float())
    g = gelu(x @ p["in_gate"].to(x.dtype))[:, 0]
    out = ((h.to(x.dtype) * g) @ p["out_w"].to(x.dtype))[:, None, :]
    cache["conv"].copy_(hist[:, 1:, :])
    cache["h"].copy_(h)
    return out

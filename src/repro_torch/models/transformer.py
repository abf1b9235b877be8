"""Block assembly: norm → attention → residual → norm → SwiGLU MLP →
residual (port of ``repro.models.transformer``, layer kind ``attn``).

The other kinds of the reference (local_attn, rglru, ssm, enc_attn, cross)
and MoE / gelu MLPs belong to families this slice does not port; asking for
them raises ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import ParamSpec, rms_norm, swiglu

__all__ = ["layer_kinds", "mlp_specs", "block_specs", "mlp_apply",
           "block_prefill", "block_decode"]

_ROADMAP = {
    "vlm": "Queue 1 item 4 (vlm family)", "moe": "Queue 1 item 5 (moe family)",
    "audio": "Queue 1 item 6 (audio family)",
    "ssm": "Queue 1 item 7 (ssm family + SSD kernel)",
    "hybrid": "Queue 1 item 8 (hybrid family + RG-LRU kernel)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md {item}")


def layer_kinds(cfg) -> list[str]:
    if cfg.family != "dense":
        raise _not_ported(f"family {cfg.family!r}",
                          _ROADMAP.get(cfg.family, "Queue 1"))
    return ["attn"] * cfg.num_layers


# ------------------------------------------------------------------- specs
def mlp_specs(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"wi_gate": ParamSpec((D, F), ("embed", "ff")),
            "wi_up": ParamSpec((D, F), ("embed", "ff")),
            "wo_mlp": ParamSpec((F, D), ("ff", "embed"))}


def block_specs(cfg, kind: str) -> dict:
    if kind != "attn":
        raise _not_ported(f"layer kind {kind!r}", "Queue 1")
    D = cfg.d_model
    s: dict = {"pre_norm": ParamSpec((D,), ("embed",), init="ones")}
    s.update(attn.attn_specs(cfg))
    s["mlp_norm"] = ParamSpec((D,), ("embed",), init="ones")
    s.update(mlp_specs(cfg))
    return s


# ------------------------------------------------------------------- apply
def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = swiglu(x @ p["wi_gate"].to(x.dtype), x @ p["wi_up"].to(x.dtype))
    return h @ p["wo_mlp"].to(x.dtype)


def _ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp_apply(p, h, cfg)


def _window_for(cfg) -> int | None:
    return cfg.window if cfg.attention == "swa" else None


# ------------------------------------------------------------------ prefill
def block_prefill(p: dict, x: torch.Tensor, cfg, max_len: int):
    """Prompt pass of one block; also returns this layer's decode cache laid
    into ``max_len`` slots (``min(window, max_len)`` for sliding window)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    window = _window_for(cfg)
    out, (k, v) = attn.attn_apply(p, h, cfg, window=window)
    x = x + out
    cache = _kv_to_cache(k, v, max_len if window is None else min(window, max_len))
    return _ffn(p, x, cfg), cache


def _kv_to_cache(k: torch.Tensor, v: torch.Tensor, slots: int) -> dict:
    """Lay the prefill K/V into a ring/flat cache of ``slots`` positions."""
    B, S, K, Dh = k.shape
    if S >= slots:   # keep the last `slots` positions; ring phase = S % slots
        shift = S % slots
        k_c = torch.roll(k[:, -slots:], shift, dims=1)
        v_c = torch.roll(v[:, -slots:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, slots - S)     # pad dim 1 at the end
        k_c = torch.nn.functional.pad(k, pad)
        v_c = torch.nn.functional.pad(v, pad)
    return {"k": k_c, "v": v_c}


# ------------------------------------------------------------------- decode
def block_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``cache`` ({"k", "v"} of this layer) is
    updated in place. Returns x."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    x = x + attn.attn_decode(p, h, cache["k"], cache["v"], pos, cfg,
                             window=_window_for(cfg))
    return _ffn(p, x, cfg)

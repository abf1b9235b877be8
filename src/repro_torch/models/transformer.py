"""Block assembly: norm → mixer → residual [→ norm → FFN/MoE → residual]
(port of ``repro.models.transformer``).

One block type per layer kind, as in the reference:
  attn        causal self-attention (full or sliding window per config) +
              FFN, or MoE when the config has experts
  local_attn  sliding-window attention (hybrid archs) + FFN
  rglru       RG-LRU recurrent mixer + FFN
  ssm         Mamba-2 SSD mixer (no FFN — the mamba block subsumes it)
  enc_attn    bidirectional self-attention (encoder) + FFN
  cross       causal self-attention + cross-attention over the encoder's
              output + FFN (decoder of an encoder-decoder)
Each kind has its training forward, prefill and decode, except
``enc_attn``: the encoder runs through the full-sequence block only (once a
prefill) and keeps no cache of its own. The FFN is SwiGLU, or a tanh-gelu
MLP with ``mlp_variant="gelu"``.

The full-sequence block returns (x, aux): aux is the MoE layer's
load-balancing loss, 0 for every other layer; prefill and decode drop it,
as the reference does. A family the reference does not have raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ParamSpec, rms_norm, swiglu
from repro_torch.parallel.ctx import constrain_logical
from repro_torch.parallel import sharding as shd

__all__ = ["layer_kinds", "mlp_specs", "block_specs", "resid", "mlp_apply",
           "block_apply", "block_prefill", "block_decode"]

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_KINDS = ("attn", "local_attn", "rglru", "ssm", "enc_attn", "cross")


def layer_kinds(cfg, *, encoder: bool = False) -> list[str]:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (the port has {_FAMILIES}); "
            "see ROADMAP.md Queue 1")
    if encoder:
        return ["enc_attn"] * cfg.encoder_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = list(cfg.block_pattern)
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    if cfg.is_encdec:
        return ["cross"] * cfg.num_layers
    return ["attn"] * cfg.num_layers


# ------------------------------------------------------------------- specs
def mlp_specs(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_variant == "gelu":
        return {"wi": ParamSpec((D, F), ("embed", "ff")),
                "wo_mlp": ParamSpec((F, D), ("ff", "embed"))}
    return {"wi_gate": ParamSpec((D, F), ("embed", "ff")),
            "wi_up": ParamSpec((D, F), ("embed", "ff")),
            "wo_mlp": ParamSpec((F, D), ("ff", "embed"))}


def block_specs(cfg, kind: str) -> dict:
    if kind not in _KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    D = cfg.d_model
    s: dict = {"pre_norm": ParamSpec((D,), ("embed",), init="ones")}
    if kind == "ssm":
        s.update(ssm_mod.ssm_specs(cfg))
        return s                                     # mamba block: mixer only
    if kind == "rglru":
        s.update(rglru_mod.rglru_specs(cfg))
    else:
        s.update(attn.attn_specs(cfg))
    if kind == "cross":
        s["cross_norm"] = ParamSpec((D,), ("embed",), init="ones")
        s["cross"] = attn.attn_specs(cfg, cross=True)
    s["mlp_norm"] = ParamSpec((D,), ("embed",), init="ones")
    s.update(moe_mod.moe_specs(cfg) if _is_moe(cfg, kind) else mlp_specs(cfg))
    return s


# ------------------------------------------------------------------- apply
def resid(x: torch.Tensor) -> torch.Tensor:
    """The residual stream in its logical layout (batch over the DP axes,
    d_model whole), after every residual add: a sublayer's partial sum (a
    head- or ff-sharded output projection) is reduced here, as Megatron's
    all-reduce does. DTensor picks each op's layout greedily from its
    inputs', so without this pin the next sublayer could take a partial
    input and run on full weights (gathering a weight is cheaper than
    reducing an activation, but 16x the work). The identity off a sharding
    context."""
    return constrain_logical(x, ("batch", "seq", "act_embed"))


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_variant == "gelu":
        h = rglru_mod.gelu(x @ p["wi"].to(x.dtype))
    else:
        h = swiglu(x @ p["wi_gate"].to(x.dtype), x @ p["wi_up"].to(x.dtype))
    return h @ p["wo_mlp"].to(x.dtype)


def _is_moe(cfg, kind: str) -> bool:
    return cfg.num_experts > 0 and kind in ("attn", "local_attn")


def _ffn(p: dict, x: torch.Tensor, cfg, kind: str):
    """Norm → MLP or MoE → residual. Returns (x, aux): the MoE's aux
    loss as a 0-d f32 tensor, or 0.0 for the MLP (no tensor is made for a
    value that prefill and decode drop)."""
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if _is_moe(cfg, kind):
        out, aux = moe_mod.moe_apply(p, h, cfg)
        return resid(x + out), aux
    return resid(x + mlp_apply(p, h, cfg)), 0.0


def _window_for(cfg, kind: str) -> int | None:
    if kind == "local_attn" or cfg.attention == "swa":
        return cfg.window
    return None


def _cross(p: dict, x: torch.Tensor, memory, cfg) -> torch.Tensor:
    """Norm → cross-attention over ``memory`` → residual."""
    hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
    return resid(x + attn.cross_attn_apply(p["cross"], hc, memory, cfg))


def block_apply(p: dict, x: torch.Tensor, cfg, kind: str, *, memory=None):
    """Train/eval full-sequence block. ``memory`` is the encoder's output
    (B, F, D), which a ``cross`` block attends to. Returns (x, aux loss): a
    0-d f32 tensor from an MoE layer, else 0.0."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind == "ssm":
        return resid(x + ssm_mod.ssm_apply(p, h, cfg)), 0.0
    if kind == "rglru":
        x = resid(x + rglru_mod.rglru_apply(p, h, cfg))
    else:
        x = resid(x + attn.attn_apply(p, h, cfg, causal=kind != "enc_attn",
                                      window=_window_for(cfg, kind))[0])
        if kind == "cross":
            x = _cross(p, x, memory, cfg)
    return _ffn(p, x, cfg, kind)


# ------------------------------------------------------------------ prefill
def block_prefill(p: dict, x: torch.Tensor, cfg, kind: str, max_len: int, *,
                  memory=None):
    """Prompt pass of one block; also returns this layer's decode cache:
    K/V laid into ``max_len`` slots (``min(window, max_len)`` for a sliding
    window), plus for a ``cross`` block the cross-attention K/V of the
    encoder's output ``memory`` (``enc_k``, ``enc_v``: (B, F, K, Dh)), or
    the conv tail and last state of a recurrent mixer."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind == "ssm":
        out, cache = _ssm_prefill(p, h, cfg)
        return resid(x + out), cache                 # mamba block: no FFN
    if kind == "rglru":
        out, cache = _rglru_prefill(p, h, cfg)
        return _ffn(p, resid(x + out), cfg, kind)[0], cache
    window = _window_for(cfg, kind)
    out, (k, v) = attn.attn_apply(p, h, cfg, window=window)
    x = resid(x + out)
    cache = _kv_to_cache(k, v, max_len if window is None else min(window, max_len))
    if kind == "cross":
        mk, mv = attn.cross_memory_kv(p["cross"], memory)
        x = _cross(p, x, (mk, mv), cfg)
        cache.update(enc_k=mk, enc_v=mv)
    return _ffn(p, x, cfg, kind)[0], cache


def _kv_to_cache(k: torch.Tensor, v: torch.Tensor, slots: int) -> dict:
    """Lay the prefill K/V into a ring/flat cache of ``slots`` positions."""
    B, S, K, Dh = k.shape
    if S >= slots:   # keep the last `slots` positions; ring phase = S % slots
        shift = S % slots
        k_c = torch.roll(k[:, -slots:], shift, dims=1)
        v_c = torch.roll(v[:, -slots:], shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, slots - S)     # pad dim 1 at the end
        k_c = shd.pad(k, pad)
        v_c = shd.pad(v, pad)
    return {"k": k_c, "v": v_c}


def _conv_tail(u: torch.Tensor, cfg) -> torch.Tensor:
    """The last conv_width - 1 rows of u (B, S, C), left-padded with zeros
    for a shorter prompt: the decode cache's conv history."""
    S, tail_len = u.shape[1], cfg.conv_width - 1
    return u[:, -tail_len:, :] if S >= tail_len else shd.pad(u, (0, 0, tail_len - S, 0))


def _ssm_prefill(p: dict, h: torch.Tensor, cfg):
    """SSD mixer over the prompt (:func:`ssm_mod.ssm_seq`, the training
    mixer's body, with the plain scan that returns the final state, as the
    reference's prefill runs it). The conv cache is the conv tail of the
    pre-conv projection; the state cache is the scan's final state in f32."""
    out, conv_in, state = ssm_mod.ssm_seq(p, h, cfg, prefill=True)
    return out, {"conv": _conv_tail(conv_in, cfg), "state": state}


def _rglru_prefill(p: dict, h: torch.Tensor, cfg):
    """Recurrent mixer over the prompt (:func:`rglru_mod.rglru_seq`, the
    training mixer's body). The conv cache is the last conv_width - 1 rows
    of the pre-conv projection (left-padded with zeros for a shorter
    prompt); the state cache is the last h, rounded to the compute dtype by
    the scan and then widened to f32, as the reference does."""
    out, u, hseq = rglru_mod.rglru_seq(p, h)
    S, tail_len = u.shape[1], cfg.conv_width - 1
    tail = u[:, -tail_len:, :] if S >= tail_len else shd.pad(u, (0, 0, tail_len - S, 0))
    return out, {"conv": tail, "h": hseq[:, -1].float()}


# ------------------------------------------------------------------- decode
def block_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg, kind: str) -> torch.Tensor:
    """One-token step. x: (B, 1, D); ``cache`` (this layer's {"k", "v"}
    (and {"enc_k", "enc_v"}, read only, for a ``cross`` block), {"conv",
    "h"} or {"conv", "state"}) is updated in place. Returns x."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind == "ssm":
        return resid(x + ssm_mod.ssm_decode(p, h, cache, cfg))
    if kind == "rglru":
        x = resid(x + rglru_mod.rglru_decode(p, h, cache, cfg))
    else:
        x = resid(x + attn.attn_decode(p, h, cache["k"], cache["v"], pos, cfg,
                                       window=_window_for(cfg, kind)))
        if kind == "cross":
            x = _cross(p, x, (cache["enc_k"], cache["enc_v"]), cfg)
    return _ffn(p, x, cfg, kind)[0]

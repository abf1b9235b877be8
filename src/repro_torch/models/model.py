"""Model assembly: param shapes, prefill and decode steps (port of
``repro.models.model`` for the dense family).

Parameters and caches keep the reference's stacked layout: every per-layer
leaf has a leading ``num_layers`` dim, so JAX trees map one to one (see
:mod:`repro_torch.interop`). ``lax.scan`` over layers becomes a Python loop
over the layer index. The decode cache is updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import ParamSpec, init_tree, rms_norm, take_embedding

__all__ = ["param_shapes", "init_params", "cache_shapes", "init_cache",
           "prefill", "decode_step", "compute_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _stacked_kind(cfg) -> str:
    return tfm.layer_kinds(cfg)[0]


def _layer(tree: dict, i: int) -> dict:
    return {k: t[i] for k, t in tree.items()}


# --------------------------------------------------------------------- specs
def param_shapes(cfg) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed"),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((D, V), ("embed", "vocab"))
    block = tfm.block_specs(cfg, _stacked_kind(cfg))
    specs["layers"] = {k: s.with_prefix(cfg.num_layers) for k, s in block.items()}
    return specs


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """Seeded init on ``device`` (the generator's device), stored in ``dtype``."""
    return init_tree(param_shapes(cfg), generator, dtype, device)


# -------------------------------------------------------------------- cache
def cache_shapes(cfg, batch: int, max_len: int) -> dict:
    """Nested {name: (shape, dtype)} decode-cache description, in the compute
    dtype."""
    dtype = compute_dtype(cfg)
    _stacked_kind(cfg)
    slots = min(cfg.window, max_len) if cfg.attention == "swa" else max_len
    shape = (cfg.num_layers, batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": {"k": (shape, dtype), "v": (shape, dtype)}}


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    return {"layers": {name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in
                       cache_shapes(cfg, batch, max_len)["layers"].items()}}


# ------------------------------------------------------------ embed/unembed
def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    return take_embedding(params["embed"], batch["tokens"], compute_dtype(cfg))


def _unembed(params, cfg, x) -> torch.Tensor:
    """Logits in float32: the matmul runs in the compute dtype, then casts."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    return logits.float()


# ------------------------------------------------------------------- decode
def decode_step(params, cfg, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: (B,) int (absolute position
    of each row's token). Writes the new K/V into ``cache`` in place.
    Returns (logits (B, V) float32, cache)."""
    _stacked_kind(cfg)
    x = take_embedding(params["embed"], tokens, compute_dtype(cfg))
    layers_c = cache["layers"]
    for i in range(cfg.num_layers):
        x = tfm.block_decode(_layer(params["layers"], i), x,
                             _layer(layers_c, i), pos, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], cache


# ------------------------------------------------------------------ prefill
def prefill(params, cfg, batch, max_len: int):
    """Process the prompt, build the decode cache.
    Returns (last_logits (B, V) float32, cache with (L, B, slots, K, Dh) leaves)."""
    _stacked_kind(cfg)
    x = _embed_inputs(params, cfg, batch)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c = tfm.block_prefill(_layer(params["layers"], i), x, cfg, max_len)
        ks.append(c["k"])
        vs.append(c["v"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    return logits, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}

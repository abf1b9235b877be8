"""Model assembly: param shapes, the full-sequence forward and loss
(training), and the prefill and decode steps (serving), of every family of
the reference: dense, moe, ssm, hybrid, vlm (precomputed vision embeddings
prepended to the text) and audio (an encoder over precomputed speech-frame
embeddings, which the decoder's cross-attention reads). Port of
``repro.models.model``.

Parameters and caches keep the reference's layouts, so JAX trees map one to
one (see :mod:`repro_torch.interop`). When every layer has one kind (and
``scan_layers``), each per-layer leaf is stacked with a leading
``num_layers`` dim and ``lax.scan`` over layers becomes a Python loop over
the layer index. Otherwise (recurrentgemma: rglru, rglru, local_attn) the
stack is unrolled into ``{"layer_{i}": ...}`` subtrees, one per layer. An
encoder-decoder adds an ``encoder`` subtree ({"layers": stacked
``enc_attn`` blocks, "final_norm"}). The decode cache is updated in place.

With ``cfg.remat`` (the reference's default), each layer of the stack and
of the encoder runs under ``torch.utils.checkpoint`` whenever autograd
records: its activations are dropped after the forward and the layer's
forward runs again in the backward, as ``jax.checkpoint`` does in the
reference. Under a sharding context (:mod:`repro_torch.parallel.ctx`) the
embeddings and the logits are constrained to their logical layouts, where
the reference constrains them; so is the residual stream after every
residual add (``transformer.resid``), and each layer's params are gathered
over the batch's mesh axes before it computes (``gather_for_compute``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import ParamSpec, init_tree, rms_norm, take_embedding
from repro_torch.models.rglru import rglru_cache_shapes
from repro_torch.models.ssm import ssm_cache_shapes
from repro_torch.parallel.ctx import constrain_logical, gather_for_compute

__all__ = ["param_shapes", "init_params", "forward", "loss_fn", "cache_shapes",
           "init_cache", "prefill", "decode_step", "compute_dtype", "uniform_scan",
           "FRONTEND_KEYS"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The batch key of each family's precomputed frontend embeddings (B, F, D).
FRONTEND_KEYS = {"vlm": "vision_embeds", "audio": "audio_embeds"}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def uniform_scan(cfg) -> bool:
    """True when the layers are stacked (L, ...) leaves, False when they are
    unrolled ``layer_{i}`` subtrees (the reference's ``_uniform_scan``)."""
    return cfg.scan_layers and len(set(tfm.layer_kinds(cfg))) == 1


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (L, ...) tree (the cross block's ``cross``
    subtree is stacked too)."""
    return {k: _layer(t, i) if isinstance(t, dict) else t[i] for k, t in tree.items()}


def _stacked(specs: dict, n: int) -> dict:
    """A block's ParamSpec tree with a leading layer dim of ``n``."""
    return {k: _stacked(s, n) if isinstance(s, dict) else s.with_prefix(n)
            for k, s in specs.items()}


# --------------------------------------------------------------------- specs
def param_shapes(cfg) -> dict:
    kinds = tfm.layer_kinds(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="embed"),
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((D, V), ("embed", "vocab"))
    if uniform_scan(cfg):
        block = tfm.block_specs(cfg, kinds[0])
        specs["layers"] = _stacked(block, cfg.num_layers)
    else:
        specs["layers"] = {f"layer_{i}": tfm.block_specs(cfg, k)
                           for i, k in enumerate(kinds)}
    if cfg.is_encdec:
        enc_block = tfm.block_specs(cfg, "enc_attn")
        specs["encoder"] = {
            "layers": _stacked(enc_block, cfg.encoder_layers),
            "final_norm": ParamSpec((D,), ("embed",), init="ones"),
        }
    return specs


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """Seeded init on ``device`` (the generator's device), stored in ``dtype``."""
    return init_tree(param_shapes(cfg), generator, dtype, device)


# -------------------------------------------------------------------- trunk
def _block_apply(p, x, cfg, kind, *, memory=None):
    """``tfm.block_apply`` on the layer's params gathered for compute
    (:func:`gather_for_compute`: FSDP's gather, inside the remat region, so
    the backward gathers again rather than keep the full weights)."""
    return tfm.block_apply(gather_for_compute(p), x, cfg, kind, memory=memory)


def _block(cfg):
    """:func:`_block_apply`, rematerialised when ``cfg.remat`` and autograd
    records (the reference's ``jax.checkpoint`` of each layer)."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda *a, **kw: checkpoint(_block_apply, *a, use_reentrant=False, **kw)
    return _block_apply


def _stack_apply(layers_p, x, cfg, kinds, *, memory=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack over the full sequence. Returns (x, aux): the
    layers' MoE aux losses summed in f32. A stacked (L, ...) leaf is indexed
    per layer, so its gradient lands in the stacked leaf."""
    stacked = uniform_scan(cfg)
    block = _block(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(kinds):
        p_i = _layer(layers_p, i) if stacked else layers_p[f"layer_{i}"]
        x, a = block(p_i, x, cfg, kind, memory=memory)
        aux = aux + a
    return x, aux


def _encoder_apply(params, cfg, embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over the frontend's embeddings (B, F, D): the stacked
    ``enc_attn`` blocks (bidirectional), then its final norm."""
    enc = params["encoder"]
    block = _block(cfg)
    x = embeds
    for i in range(cfg.encoder_layers):
        x, _ = block(_layer(enc["layers"], i), x, cfg, "enc_attn")
    return rms_norm(x, gather_for_compute(enc["final_norm"]), cfg.norm_eps)


def _memory(params, cfg, batch, dtype):
    """The encoder's output for an encoder-decoder (from
    ``batch["audio_embeds"]``), else None."""
    if not cfg.is_encdec:
        return None
    return _encoder_apply(params, cfg, batch[FRONTEND_KEYS["audio"]].to(dtype))


def forward(params, cfg, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V) float32, aux loss, a
    0-d float32 tensor: the MoE layers' load-balancing loss, 0 without
    experts), as the reference's forward does. For vlm S counts the vision
    prefix too."""
    x = _embed_inputs(params, cfg, batch)
    memory = _memory(params, cfg, batch, x.dtype)
    x, aux = _stack_apply(params["layers"], x, cfg, tfm.layer_kinds(cfg), memory=memory)
    x = rms_norm(x, gather_for_compute(params["final_norm"]), cfg.norm_eps)
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg, batch) -> torch.Tensor:
    """Next-token cross entropy of tokens[:, 1:], in float32, plus the MoE
    aux loss: the mean over the B x (S - 1) predictions, or, with
    ``batch["loss_mask"]`` (B, S), the sum over the predictions whose target
    is masked in, divided by max(that mask's sum, 1), as the reference does.
    vlm skips the logits of the vision prefix."""
    logits, aux = forward(params, cfg, batch)
    prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    tokens = batch["tokens"]
    preds = logits[:, prefix:prefix + tokens.shape[1] - 1]
    nll = F.cross_entropy(preds.reshape(-1, preds.shape[-1]),
                          tokens[:, 1:].reshape(-1).long(), reduction="none")
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.mean() + aux
    m = mask[:, 1:].reshape(-1).float()
    return (nll * m).sum() / m.sum().clamp(min=1.0) + aux


# -------------------------------------------------------------------- cache
def _layer_cache_shapes(cfg, kind: str, batch: int, max_len: int, dtype) -> dict:
    if kind == "ssm":
        return ssm_cache_shapes(cfg, batch, dtype)
    if kind == "rglru":
        return rglru_cache_shapes(cfg, batch, dtype)
    slots = max_len
    if kind == "local_attn" or cfg.attention == "swa":
        slots = min(cfg.window, max_len)
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    c = {"k": (shape, dtype), "v": (shape, dtype)}
    if kind == "cross":
        enc = (batch, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim)
        c.update(enc_k=(enc, dtype), enc_v=(enc, dtype))
    return c


def cache_shapes(cfg, batch: int, max_len: int) -> dict:
    """Nested {name: (shape, dtype)} decode-cache description; K/V (the
    cross-attention's ``enc_k``/``enc_v`` too) and the conv tails in the
    compute dtype, the RG-LRU and SSM states in f32."""
    dtype = compute_dtype(cfg)
    kinds = tfm.layer_kinds(cfg)
    if uniform_scan(cfg):
        per = _layer_cache_shapes(cfg, kinds[0], batch, max_len, dtype)
        return {"layers": {k: ((cfg.num_layers, *shape), dt)
                           for k, (shape, dt) in per.items()}}
    return {"layers": {f"layer_{i}": _layer_cache_shapes(cfg, k, batch, max_len, dtype)
                       for i, k in enumerate(kinds)}}


def _zeros(tree, device):
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    shape, dtype = tree
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    return _zeros(cache_shapes(cfg, batch, max_len), device)


# ------------------------------------------------------------ embed/unembed
def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """Token embeddings in the compute dtype; for vlm the batch's
    ``vision_embeds`` (B, F, D) come first."""
    dt = compute_dtype(cfg)
    x = take_embedding(params["embed"], batch["tokens"], dt)
    if cfg.family == "vlm":
        x = torch.cat([batch[FRONTEND_KEYS["vlm"]].to(dt), x], dim=1)
    return constrain_logical(x, ("batch", "seq", "act_embed"))


def _unembed(params, cfg, x) -> torch.Tensor:
    """Logits in float32: the matmul runs in the compute dtype, then casts."""
    if cfg.tie_embeddings:
        logits = x @ gather_for_compute(params["embed"]).to(x.dtype).T
    else:
        logits = x @ gather_for_compute(params["unembed"]).to(x.dtype)
    return constrain_logical(logits.float(), ("batch", "seq", "vocab"))


# ------------------------------------------------------------------- decode
def decode_step(params, cfg, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: (B,) int (absolute position
    of each row's token). Updates ``cache`` in place.
    Returns (logits (B, V) float32, cache)."""
    kinds = tfm.layer_kinds(cfg)
    x = take_embedding(params["embed"], tokens, compute_dtype(cfg))
    layers_p, layers_c = params["layers"], cache["layers"]
    stacked = uniform_scan(cfg)
    for i, kind in enumerate(kinds):
        if stacked:
            p_i, c_i = _layer(layers_p, i), _layer(layers_c, i)
        else:
            p_i, c_i = layers_p[f"layer_{i}"], layers_c[f"layer_{i}"]
        x = tfm.block_decode(gather_for_compute(p_i), x, c_i, pos, cfg, kind)
    x = rms_norm(x, gather_for_compute(params["final_norm"]), cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], cache


# ------------------------------------------------------------------ prefill
def prefill(params, cfg, batch, max_len: int):
    """Process the prompt (after the vision prefix for vlm), build the
    decode cache; an encoder-decoder first encodes ``batch["audio_embeds"]``
    and keeps each layer's cross-attention K/V in the cache.
    Returns (last_logits (B, V) float32, cache in :func:`cache_shapes`'s
    layout)."""
    kinds = tfm.layer_kinds(cfg)
    x = _embed_inputs(params, cfg, batch)
    memory = _memory(params, cfg, batch, x.dtype)
    layers_p = params["layers"]
    stacked = uniform_scan(cfg)
    caches = {}
    for i, kind in enumerate(kinds):
        p_i = _layer(layers_p, i) if stacked else layers_p[f"layer_{i}"]
        x, caches[f"layer_{i}"] = tfm.block_prefill(gather_for_compute(p_i), x, cfg, kind,
                                                    max_len, memory=memory)
    if stacked:
        caches = {name: torch.stack([caches[f"layer_{i}"][name]
                                     for i in range(cfg.num_layers)])
                  for name in caches["layer_0"]}
    x = rms_norm(x, gather_for_compute(params["final_norm"]), cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    return logits, {"layers": caches}

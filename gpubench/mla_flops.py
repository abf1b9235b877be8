"""Operations and bytes of a latent-attention (MLA) MoE configuration
(Moonlight, DeepSeek-V3 architecture), the benchmark's own beside
``gpubench/flops.py`` (which it leaves as it is): the model FLOPs from the
published widths and the traffic's shapes, and the latent decode kernel's
work from the rows' written slots.

Model FLOPs count the active matrix parameters a token (``matmul_params_active``
in the configuration's file: attention, the dense layer, 6 routed and 2
shared experts, the routers, the head) and attention in the published,
non-absorbed form (scores over qk_nope + qk_rope values a head, values of
v_head_dim), so the count is the same whatever form the program computes.
"""

from __future__ import annotations

from gpubench.flops import bound_s

__all__ = ["attention_width", "slot_values", "mla_prefill_flops", "mla_decode_flops",
           "mla_decode_counts", "mla_decode_bound_s"]


def attention_width(cfg: dict) -> int:
    """L x H x (score width + value width): the attention's operations per
    (query, key) pair are twice this."""
    return cfg["num_hidden_layers"] * cfg["num_attention_heads"] * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])


def slot_values(cfg: dict) -> int:
    """Values a latent cache slot holds: the latent and the rotated k_rope."""
    return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]


def mla_prefill_flops(cfg: dict, prompt_len: int) -> float:
    """A prompt's prefill: 2 x the active matrix parameters a token but the
    head's, the head on the last token only, and 2·L·H·(192 + 128) over the
    causal pairs."""
    head = cfg["hidden_size"] * cfg["vocab_size"]
    pairs = prompt_len * (prompt_len + 1) // 2
    return float(2 * (cfg["matmul_params_active"] - head) * prompt_len + 2 * head
                 + 2 * attention_width(cfg) * pairs)


def mla_decode_flops(cfg: dict, context: int) -> float:
    """One decoded token that attends over ``context`` positions (itself
    included): 2 x the active matrix parameters, and 2·L·H·(192 + 128)·context."""
    return float(2 * cfg["matmul_params_active"] + 2 * attention_width(cfg) * context)


def mla_decode_counts(cfg: dict, contexts, itemsize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode step's latent attention over every
    layer: per row, its ``context`` written slots read once (``slot_values``
    each) with its query in (heads x slot_values) and its output out (heads
    x kv_lora_rank); 2 x heads x (slot_values + kv_lora_rank) operations a
    slot."""
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    W, C = slot_values(cfg), cfg["kv_lora_rank"]
    slots = sum(contexts)
    flops = 2 * L * H * (W + C) * slots
    nbytes = itemsize * L * (W * slots + len(contexts) * H * (W + C))
    return float(flops), float(nbytes)


def mla_decode_bound_s(cfg: dict, contexts) -> float:
    """The least time one decode step's latent attention needs on the card."""
    return bound_s(*mla_decode_counts(cfg, contexts))

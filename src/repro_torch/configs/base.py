"""Model configuration: the port's own copy of ``repro.configs.base``.

The fields every family of the reference reads (dense, moe, ssm, hybrid,
vlm, audio), with the reference ``ModelConfig``'s names and defaults, so a
config maps one to one between the two packages. The parameter counts are
taken over the port's own ``ParamSpec`` tree (the reference counts over its
JAX one).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_for", "cell_supported"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # attention
    attention: str = "full"         # full | swa | none | mla (latent attention)
    window: int = 4096              # sliding window (attention == "swa" / local)
    qkv_bias: bool = False
    attn_chunked: bool = False      # blockwise online-softmax (XLA flash):
                                    # O(S·D) peak bytes instead of O(S²)
    attn_q_block: int = 1024        # chunked-attention tile sizes; carry
    attn_k_block: int = 1024        # traffic ∝ S/attn_k_block per q tile

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # DeepSeek-V3-style MoE (all off by default: softmax router, capacity drops)
    router_scoring: str = "softmax"  # softmax (capacity dispatch) | sigmoid (dropless)
    routed_scaling: float = 1.0     # sigmoid: renormalised top-k weights times this
    num_shared_experts: int = 0     # one SwiGLU of num_shared_experts * moe_d_ff, every token
    first_dense_layers: int = 0     # an MLA model's leading layers with a dense d_ff MLP

    # multi-head latent attention (attention == "mla"; no q LoRA)
    kv_lora_rank: int = 0           # the cached latent's width
    qk_nope_head_dim: int = 0       # per-head q/k width without rope
    qk_rope_head_dim: int = 0       # rope width, q per head and one k shared by the heads
    v_head_dim: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 → d_model * ssm_expand // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4             # causal conv of the ssm and hybrid mixers

    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple = ()       # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int = 0

    # encoder-decoder (seamless)
    encoder_layers: int = 0
    cross_attention: bool = False

    # modality frontend stub (vlm/audio): precomputed embeddings prepended
    frontend: str = "none"          # none | vision_stub | audio_stub
    frontend_tokens: int = 0

    # misc
    mlp_variant: str = "swiglu"     # swiglu | gelu (non-gated)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True              # recompute each layer's forward in the backward
    scan_layers: bool = True        # stacked (L, ...) layers when all kinds match

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "ssm" and self.ssm_heads == 0:
            object.__setattr__(
                self, "ssm_heads",
                (self.d_model * self.ssm_expand) // self.ssm_head_dim)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded memory?"""
        return self.family in ("ssm", "hybrid") or self.attention == "swa"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def _flat_param_specs(self):
        from repro_torch.models.layers import flatten_specs
        from repro_torch.models.model import param_shapes
        return flatten_specs(param_shapes(self))

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for _, s in self._flat_param_specs())

    def active_param_count(self) -> int:
        """MoE: params touched per token (top-k of E experts)."""
        if self.num_experts == 0:
            return self.param_count()
        total = 0
        for path, spec in self._flat_param_specs():
            n = math.prod(spec.shape)
            if path[-1].startswith("we_"):
                n = n * self.num_experts_per_tok // self.num_experts
            total += n
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}") from None


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) runnable? A full-attention arch does not decode at
    500k context: its dense KV cache is not sub-quadratic."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense KV decode is not "
                       "sub-quadratic (skip per assignment)")
    return True, ""

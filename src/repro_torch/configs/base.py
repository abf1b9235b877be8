"""Model configuration: the port's own copy of ``repro.configs.base``.

The fields the ported dense and hybrid families read, with the reference
``ModelConfig``'s names and defaults, so a config maps one to one between
the two packages. The fields of the families not ported yet (MoE, SSM,
encoder-decoder, frontends) come with those families. The
parameter count is taken over the port's own ``ParamSpec`` tree (the
reference counts over its JAX one).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | hybrid (the families ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # attention
    attention: str = "full"         # full | swa
    window: int = 4096              # sliding window (attention == "swa" / local)
    qkv_bias: bool = False

    # recurrent mixer (hybrid family; the ssm family will read conv_width too)
    conv_width: int = 4

    # hybrid (recurrentgemma): repeating block pattern
    block_pattern: tuple = ()       # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int = 0

    # misc
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    scan_layers: bool = True        # stacked (L, ...) layers when all kinds match

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models.layers import flatten_specs
        from repro_torch.models.model import param_shapes
        return sum(math.prod(s.shape) for _, s in flatten_specs(param_shapes(self)))

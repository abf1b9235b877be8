"""internvl2-26b — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821]. Backbone only, as in the reference: the batch carries
precomputed patch embeddings (256 tokens per image tile), prepended to the
text embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    frontend="vision_stub", frontend_tokens=256,
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, frontend_tokens=8,
)

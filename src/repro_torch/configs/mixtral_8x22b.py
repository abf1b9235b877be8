"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=16384,
    attention="swa", window=4096,
)

SMOKE = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    num_experts=4, num_experts_per_tok=2, moe_d_ff=128, window=32,
)

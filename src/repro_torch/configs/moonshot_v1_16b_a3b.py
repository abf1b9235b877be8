"""moonshot-v1-16b-a3b — Moonlight 16B-A3B: 64-expert top-6 fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    num_experts=64, num_experts_per_tok=6, moe_d_ff=1408,
)

SMOKE = CONFIG.replace(
    name="moonshot-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=96,
)

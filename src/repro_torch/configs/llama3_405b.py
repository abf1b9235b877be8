"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, rope_theta=5e5,
)

SMOKE = CONFIG.replace(
    name="llama3-smoke", num_layers=3, d_model=64, num_heads=8,
    num_kv_heads=2, head_dim=8, d_ff=192, vocab_size=256,
)

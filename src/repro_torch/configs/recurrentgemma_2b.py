"""recurrentgemma-2b — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427] (Griffin)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"), window=2048,
    lru_width=2560, conv_width=4, tie_embeddings=True,
    scan_layers=False,  # 26 % 3 != 0: pattern remainder → unrolled stack
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", num_layers=5, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256, lru_width=64,
    window=32,
)

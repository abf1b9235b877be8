"""tiny — ~100M-class dense model for the end-to-end training example
(examples/cluster_train.py trains it for a few hundred steps on CPU)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tiny", family="dense",
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
    d_ff=2048, vocab_size=32768, dtype="float32",
)

SMOKE = CONFIG.replace(name="tiny-smoke", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=256)

"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attention="none", ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_width=4, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke", num_layers=2, d_model=64, vocab_size=256,
    ssm_state=16, ssm_head_dim=16, ssm_heads=8, ssm_chunk=32,
)

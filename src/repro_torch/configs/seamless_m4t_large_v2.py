"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stub)
[arXiv:2308.11596]. Backbone transformer only, as in the reference: the
batch carries precomputed speech-frame embeddings for the encoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, cross_attention=True,
    frontend="audio_stub", frontend_tokens=1024,
    mlp_variant="gelu",
)

SMOKE = CONFIG.replace(
    name="seamless-smoke", num_layers=2, encoder_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    frontend_tokens=16,
)

"""moonshot-v1-16b-a3b — the JAX reference's stand-in for Moonlight 16B-A3B:
a 64-expert top-6 fine-grained MoE that cites [hf:moonshotai/Moonlight-16B-A3B]
but does not have that model's architecture. The port keeps it as the JAX
package has it, so that the two packages can be compared. It differs from the
published model (``configs/moonlight_16b_a3b.py``) in: 48 layers, not 27;
MHA with per-head K/V (16 x 128), not latent attention (MLA); no shared
experts (published: 2); no leading dense layer (published:
``first_k_dense_replace`` 1 of ``intermediate_size`` 11264); a softmax
router with capacity drops, not a sigmoid router with a correction bias
(``noaux_tc``, top-6 of 64 renormalised, times 2.446); ``rope_theta`` 1e4,
not 5e4; RMSNorm eps 1e-6, not 1e-5."""
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

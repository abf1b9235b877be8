"""moonlight-16b-a3b — Moonlight-16B-A3B as published (``model_type``
deepseek_v3) [hf:moonshotai/Moonlight-16B-A3B, config.json]: 27 layers,
multi-head latent attention (16 heads; ``kv_lora_rank`` 512,
``qk_nope_head_dim`` 128, ``qk_rope_head_dim`` 64, ``v_head_dim`` 128, no q
LoRA), the first layer a dense SwiGLU of ``intermediate_size`` 11264, the
other 26 MoE: 64 routed experts of 1408, 6 a token by a sigmoid router with
a correction bias (``noaux_tc``, one group), renormalised and times
``routed_scaling_factor`` 2.446, plus 2 shared experts; ``rope_theta``
50000, no ``rope_scaling``, RMSNorm eps 1e-5, vocab 163840, untied head.
15,959,982,080 parameters in its matrices."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=11264, vocab_size=163840, head_dim=192,
    attention="mla", kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64, num_experts_per_tok=6, moe_d_ff=1408,
    router_scoring="sigmoid", routed_scaling=2.446, num_shared_experts=2,
    first_dense_layers=1,
    rope_theta=50000.0, norm_eps=1e-5,
)

# The smoke size keeps a slot of 48 (a latent of 32 and a rope width of 16), a
# multiple of 16 as the decode kernel's bf16 route needs; 3 layers: the dense
# one and two MoE.
SMOKE = CONFIG.replace(
    name="moonlight-smoke", num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=128, vocab_size=256,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=32, num_shared_experts=2,
)

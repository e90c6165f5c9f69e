"""DeepSeek-V2-Lite (15.7B): 27L, d=2048, 16H MLA (kv_lora=512, rope 64),
64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense,
vocab 102400.  [arXiv:2405.04434]

The published V2-Lite config has 64 routed experts (160 belongs to
DeepSeek-V2-236B).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    kv_heads=16,              # MLA: logical heads (cache is latent)
    head_dim=128,
    d_ff=10944,               # dense d_ff (first layer)
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=2 * 1408,
                  first_dense_layers=1),
    rope_theta=10000.0,
    tie_embeddings=False,
)

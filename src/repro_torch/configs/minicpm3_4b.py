"""MiniCPM3-4B: 62L, d=2560, 40H MLA (q_lora=768, kv_lora=256), d_ff=6400,
vocab 73448.  [hf:openbmb/MiniCPM3-4B]"""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    kv_heads=40,
    head_dim=64,              # qk_nope dim; MLA carries the real dims
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64),
    rope_theta=10000.0,
    tie_embeddings=True,
)

"""Gemma2-27B: 46L, d=4608, 32H GQA kv=16, head_dim=128, d_ff=36864,
alternating local(4096)/global attention, logit softcaps, GeGLU,
query scale (d_model/num_heads)^-0.5 = 144^-0.5.  [arXiv:2408.00118]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mlp="geglu",
    local_window=4096,
    local_ratio=1,            # local, global, local, global, ...
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    rope_theta=10000.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)
